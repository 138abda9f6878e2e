"""Minimal NetCDF abstraction over scipy (NetCDF3) and h5py (NetCDF4).

The reference links the NetCDF Fortran library and reads ROMS grid +
history files with nf90_open/get_var (hydrodynamic_module.f90,
SURVEY.md SS3.3).  Without netCDF4/xarray we shim both classic
(CDF-1/2: the C++ reader in ltjax.native, or scipy.io.netcdf_file) and
NetCDF4/HDF5 (via h5py, imported only when such a file is opened),
detected by magic bytes.  Hyperslab reads (one time record at a
time) are first-class — that is what the streaming input pipeline
needs, and per-host tile reads fall out of numpy basic slicing.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class NCFile:
    """Read-only NetCDF file with record-wise variable access."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic[:3] == b"CDF":
            # prefer the native C++ reader (GIL-free bulk reads for the
            # prefetch pipeline, ltjax/native); scipy is the fallback
            # and still serves attribute reads
            try:
                from ..native import NativeCDF
                self._kind = "native"
                self._f = NativeCDF(path)
                return
            except OSError:
                pass
            from scipy.io import netcdf_file
            self._kind = "cdf"
            self._f = netcdf_file(path, "r", mmap=True)
        elif magic[1:4] == b"HDF":
            try:
                import h5py
            except ImportError as e:
                raise ImportError(
                    f"{path} is NetCDF4 (HDF5); reading it needs the "
                    "h5py package, which is not installed.  Convert the "
                    "file to NetCDF3 (e.g. `nccopy -k 64-bit-offset`) or "
                    "install h5py.") from e
            self._kind = "hdf"
            self._f = h5py.File(path, "r")
        else:
            raise ValueError(f"{path}: not a NetCDF file (magic {magic!r})")

    # -- introspection ----------------------------------------------------
    def variables(self):
        if self._kind == "native":
            return self._f.variables()
        if self._kind == "cdf":
            return list(self._f.variables)
        return [k for k in self._f.keys()]

    def has(self, name: str) -> bool:
        return name in self.variables()

    def dims(self, name: str) -> Tuple[int, ...]:
        if self._kind == "native":
            return self._f.dims(name)
        if self._kind == "cdf":
            return self._f.variables[name].shape
        return self._f[name].shape

    def num_records(self, name: str) -> int:
        """Length of the leading (time) axis of a variable."""
        return self.dims(name)[0]

    # -- data -------------------------------------------------------------
    def read(self, name: str, index=None, dtype=None,
             eta_slice=None) -> np.ndarray:
        """Read a whole variable or one leading-axis record (hyperslab).

        dtype: optional target dtype hint ("float32"/"float64"); the
        native reader converts during the read, other backends convert
        after.

        eta_slice: optional (lo, hi) row range applied to the
        second-to-last axis — the ROMS eta axis of ([K,] eta, xi)
        records.  Per-host hyperslab reads (SURVEY.md SS5.8): each host
        of a domain-decomposed run reads only its tiles' rows; scipy's
        mmap and h5py slice lazily, so only those rows touch disk.
        """
        es = slice(*eta_slice) if eta_slice is not None else slice(None)
        if self._kind == "native":
            out = self._f.read(name, index, dtype=dtype)
            if eta_slice is not None and out.ndim >= 2:
                out = out[..., es, :]
        elif self._kind == "cdf":
            var = self._f.variables[name]
            if var.shape == ():  # scalar var: scipy can't slice 0-d data
                data = var.getValue()
            elif eta_slice is not None and len(var.shape) >= 2:
                data = (var[index][..., es, :] if index is not None
                        else var[:][..., es, :])
            else:
                data = var[index] if index is not None else var[:]
            out = np.array(data)  # copy out of the mmap
        else:
            ds = self._f[name]
            if eta_slice is not None and ds.ndim >= 2:
                if index is not None:
                    out = np.asarray(ds[(index, Ellipsis, es, slice(None))])
                else:
                    out = np.asarray(ds[(Ellipsis, es, slice(None))])
            else:
                out = np.asarray(ds[index] if index is not None else ds[:])
        if dtype is not None:
            out = np.asarray(out, dtype)
        return out

    def read_attr(self, name: str, attr: str, default=None):
        try:
            if self._kind == "native":
                # the C++ reader skips attributes; parse them via scipy
                from scipy.io import netcdf_file
                with netcdf_file(self.path, "r", mmap=False) as f:
                    return getattr(f.variables[name], attr)
            if self._kind == "cdf":
                return getattr(self._f.variables[name], attr)
            return self._f[name].attrs[attr]
        except (AttributeError, KeyError):
            return default

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_netcdf(path: str, dims: Dict[str, Optional[int]],
                 variables: Dict[str, Tuple[Sequence[str], np.ndarray]],
                 attrs: Optional[Dict[str, str]] = None):
    """Write a classic NetCDF3 file via scipy.

    dims: name -> size (None for the unlimited/record dimension).
    variables: name -> (dim-name tuple, array).
    """
    from scipy.io import netcdf_file

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    f = netcdf_file(path, "w")
    try:
        for dname, size in dims.items():
            f.createDimension(dname, size)
        if attrs:
            for k, v in attrs.items():
                setattr(f, k, v)
        for vname, (vdims, data) in variables.items():
            data = np.asarray(data)
            typecode = {"f": "f", "d": "d", "i": "i", "l": "i"}.get(
                data.dtype.kind + "", None)
            if data.dtype == np.float64:
                tc = "d"
            elif data.dtype == np.float32:
                tc = "f"
            elif data.dtype.kind in "iu":
                tc = "i"
                data = data.astype(np.int32)
            else:
                tc = "d"
                data = data.astype(np.float64)
            var = f.createVariable(vname, tc, tuple(vdims))
            if data.ndim == 0:
                # scipy's assignValue does `self.data[:] = value`, which
                # IndexErrors on 0-d arrays under numpy>=2; poke the 0-d
                # backing array directly.
                var.data[()] = data
            else:
                var[:] = data
    finally:
        f.close()
