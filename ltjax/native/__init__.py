"""Native (C++) runtime components.

The compute path is JAX/XLA; the host runtime around it uses
C++ where the reference's runtime is native (the whole reference is
Fortran — SURVEY.md SS2): here, the NetCDF3 record reader that feeds
the streaming input pipeline without holding the Python GIL.

The shared library self-builds with g++ on first import (no install
step, matching the zero-pip environment); on any failure the callers
fall back to the pure-Python readers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ncread.cpp")
_SO = os.path.join(_DIR, "_ltnc.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        if (os.path.exists(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
            return True
        # per-process temporary: concurrent first imports (test
        # workers) each build their own and the atomic rename settles
        tmp = f"{_SO}.{os.getpid()}.tmp"
        r = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, _SRC],
            capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded C library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.ltnc_open.restype = ctypes.c_void_p
        lib.ltnc_open.argtypes = [ctypes.c_char_p]
        lib.ltnc_close.argtypes = [ctypes.c_void_p]
        lib.ltnc_numrecs.restype = ctypes.c_longlong
        lib.ltnc_numrecs.argtypes = [ctypes.c_void_p]
        lib.ltnc_num_vars.restype = ctypes.c_int
        lib.ltnc_num_vars.argtypes = [ctypes.c_void_p]
        lib.ltnc_var_name.restype = ctypes.c_int
        lib.ltnc_var_name.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_int]
        lib.ltnc_find_var.restype = ctypes.c_int
        lib.ltnc_find_var.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ltnc_var_ndims.restype = ctypes.c_int
        lib.ltnc_var_ndims.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ltnc_var_isrec.restype = ctypes.c_int
        lib.ltnc_var_isrec.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ltnc_var_type.restype = ctypes.c_int
        lib.ltnc_var_type.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ltnc_var_shape.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong)]
        lib.ltnc_read.restype = ctypes.c_longlong
        lib.ltnc_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_void_p,
                                  ctypes.c_int]
        _lib = lib
        return _lib


class NativeCDF:
    """Read-only NetCDF3 classic file via the C++ reader.

    API-compatible subset of ltjax.io.nc.NCFile (variables/dims/
    num_records/read/close).  Raises OSError if the file can't be
    parsed (caller falls back to scipy).
    """

    def __init__(self, path: str):
        import numpy as np
        self._np = np
        lib = get_lib()
        if lib is None:
            raise OSError("native reader unavailable")
        self._lib = lib
        self._h = lib.ltnc_open(path.encode())
        if not self._h:
            raise OSError(f"{path}: native CDF parse failed")
        self.path = path
        self._names = {}
        buf = ctypes.create_string_buffer(256)
        for vid in range(lib.ltnc_num_vars(self._h)):
            lib.ltnc_var_name(self._h, vid, buf, 256)
            self._names[buf.value.decode()] = vid

    def variables(self):
        return list(self._names)

    def has(self, name):
        return name in self._names

    def dims(self, name):
        vid = self._names[name]
        nd = self._lib.ltnc_var_ndims(self._h, vid)
        shape = (ctypes.c_longlong * max(nd, 1))()
        self._lib.ltnc_var_shape(self._h, vid, shape)
        return tuple(int(shape[d]) for d in range(nd))

    def num_records(self, name):
        return self.dims(name)[0]

    def read(self, name, index=None, dtype=None):
        """float32 / float64 when ``dtype`` asks for it; otherwise the
        variable's own integer type, or float64 for float variables."""
        np = self._np
        vid = self._names[name]
        shape = self.dims(name)
        isrec = self._lib.ltnc_var_isrec(self._h, vid)
        if index is not None and isrec:
            out_shape = shape[1:]
            rec = int(index)
        else:
            out_shape = shape
            rec = -1
        want = 0 if dtype in ("float32", np.float32) else 1
        out = np.empty(out_shape,
                       np.float32 if want == 0 else np.float64)
        n = self._lib.ltnc_read(
            self._h, vid, rec, out.ctypes.data_as(ctypes.c_void_p), want)
        if n != out.size:
            raise OSError(f"{self.path}:{name}: native read failed")
        if dtype is None:
            itype = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.int32}.get(
                self._lib.ltnc_var_type(self._h, vid))
            if itype is not None:
                out = out.astype(itype)
        if index is not None and not isrec:
            return out[index]
        return out

    def close(self):
        if self._h:
            self._lib.ltnc_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
