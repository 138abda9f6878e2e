"""Trajectory output: CSV and NetCDF snapshots.

Reference: ``printOutput``/``writeOutput`` in LTRANS.f90 (SURVEY.md
SS3.4 [conf: M]): every ``iprint`` seconds append particle snapshots —
CSV rows and/or a NetCDF file with dims (time, particle) and variables
model_time, lon, lat, depth, color (status code), optional salt/temp/
age/settle-polygon, plus hitLand/hitBottom when TrackCollisions is on.

Scale design (the reference's writeOutput appends incrementally; so do
we): the NetCDF path writes NetCDF3 64-bit-offset files (CDF-2, scipy)
and appends each snapshot as one record along the unlimited ``time``
dimension — O(1) host memory regardless of run length, and a snapshot
append is one contiguous write at the end of the file.  The CSV path
formats whole columns via numpy (``np.savetxt``), not a per-particle
Python loop.  Readers: ltjax.io.nc.NCFile.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .. import convert
from ..config import Config
from ..state import Particles


def _typecode(arr: np.ndarray) -> str:
    return {"f8": "d", "i4": "i"}[f"{arr.dtype.kind}{arr.dtype.itemsize}"]


class RecordFile:
    """A NetCDF3 64-bit-offset file with dims (time: unlimited,
    particle) that grows one record at a time.

    The first :meth:`append` writes the header, the fixed ``(particle,)``
    variables and record 0 through scipy; later ones write the record's
    bytes (big-endian, in the header's variable order) at the end of
    the file and then raise the header's record count.  Record values
    are float64 or int32 arrays of shape (particle,), or scalars.
    """

    def __init__(self, path: str, n_particles: int, fixed: dict,
                 attrs: dict):
        self.path = path
        self.n = n_particles
        self.fixed = fixed
        self.attrs = attrs
        self.n_records = 0
        self._order = None      # record variable names in file order
        self._end = 0           # byte offset where the next record goes

    def append(self, rec: dict):
        if self._order is None:
            self._create(rec)
            return
        with open(self.path, "r+b") as f:
            f.seek(self._end)
            for name in self._order:
                arr = np.asarray(rec[name])
                f.write(arr.astype(arr.dtype.newbyteorder(">")).tobytes())
            self._end = f.tell()
            # data first, then the count that makes it visible
            self.n_records += 1
            f.seek(4)
            f.write(struct.pack(">i", self.n_records))

    def _create(self, rec: dict):
        from scipy.io import netcdf_file

        f = netcdf_file(self.path, "w", version=2)
        try:
            for k, v in self.attrs.items():
                setattr(f, k, v)
            f.createDimension("time", None)
            f.createDimension("particle", self.n)
            for name, arr in self.fixed.items():
                arr = np.asarray(arr)
                f.createVariable(name, _typecode(arr),
                                 ("particle",))[:] = arr
            for name, arr in rec.items():
                arr = np.asarray(arr)
                dims = ("time",) if arr.ndim == 0 else ("time", "particle")
                f.createVariable(name, _typecode(arr), dims)[0] = arr
            f.flush()
            # header position of each record variable's entry: the
            # header lists them in the order their data is interleaved
            hdr = {name: v._begin for name, v in f.variables.items()
                   if v.isrec}
        finally:
            f.close()
        self._order = sorted(hdr, key=hdr.get)
        self._end = os.path.getsize(self.path)   # records run to the end
        self.n_records = 1


class TrajectoryWriter:
    def __init__(self, cfg: Config, shard_tag: str = ""):
        """``shard_tag``: optional suffix (e.g. "_h03") so multi-host
        runs write per-host shard files without coordination."""
        self.cfg = cfg
        self.tag = shard_tag
        os.makedirs(cfg.outpath, exist_ok=True)
        self._csv = None
        self._nc = None           # RecordFile, created on first snapshot
        self._nt = 0
        if cfg.writeCSV:
            self._csv = open(os.path.join(
                cfg.outpath, cfg.NCOutFile + shard_tag + ".csv"), "w")
            if cfg.WriteHeaders:
                self._csv.write(",".join(self._csv_cols()) + "\n")

    # ------------------------------------------------------------------
    def _csv_cols(self):
        cols = ["time", "id", "lon", "lat", "depth", "status"]
        if self.cfg.SaltTempOn:
            cols += ["salt", "temp"]
        cols += ["age", "poly"]
        if self.cfg.TrackCollisions:
            cols += ["hitLand", "hitBottom"]
        return cols

    def _to_lonlat(self, p: Particles):
        cfg = self.cfg
        x = np.asarray(p.x, np.float64)
        y = np.asarray(p.y, np.float64)
        lat = convert.y2lat(y, cfg.latmin, cfg.Earth_Radius,
                            cfg.SphericalProjection)
        lon = convert.x2lon(x, y, cfg.lonmin, cfg.latmin, cfg.Earth_Radius,
                            cfg.SphericalProjection)
        return np.asarray(lon), np.asarray(lat)

    # ------------------------------------------------------------------
    def snapshot(self, t: float, p: Particles):
        cfg = self.cfg
        lon, lat = self._to_lonlat(p)
        pid = np.asarray(p.pid, np.int32)
        depth = np.asarray(p.z, np.float64)
        status = np.asarray(p.status, np.int32)
        age = np.asarray(p.age, np.float64)
        poly = np.asarray(p.settle_poly, np.int32)
        extra = {}
        if cfg.SaltTempOn:
            extra["salt"] = np.asarray(p.salt, np.float64)
            extra["temp"] = np.asarray(p.temp, np.float64)
        if cfg.TrackCollisions:
            extra["hitLand"] = np.asarray(p.hit_land, np.int32)
            extra["hitBottom"] = np.asarray(p.hit_bottom, np.int32)

        if cfg.writeNC:
            if self._nc is None:
                self._nc = RecordFile(
                    os.path.join(cfg.outpath,
                                 cfg.NCOutFile + self.tag + ".nc"),
                    len(lon), {"pid": pid},
                    {"title": cfg.RunName, "run_by": cfg.RunBy,
                     "institution": cfg.Institution,
                     "source": "ltjax (LTRANS v2b rebuild on JAX)"})
            rec = {"model_time": np.float64(t), "lon": lon, "lat": lat,
                   "depth": depth, "color": status, "age": age,
                   "settle_poly": poly}
            if self.tag:
                # per-host shard files: slot occupancy changes as
                # particles migrate between hosts, so pid is a
                # per-snapshot variable (EMPTY slots carry color < 0;
                # merge_shards filters them)
                rec["pid_t"] = pid
            rec.update(extra)
            self._nc.append(rec)
            self._nt += 1

        if self._csv is not None:
            cols = [np.full(len(lon), float(t)), pid, lon, lat, depth,
                    status]
            fmt = ["%.1f", "%d", "%.8f", "%.8f", "%.4f", "%d"]
            if cfg.SaltTempOn:
                cols += [extra["salt"], extra["temp"]]
                fmt += ["%.4f", "%.4f"]
            cols += [age, poly]
            fmt += ["%.1f", "%d"]
            if cfg.TrackCollisions:
                cols += [extra["hitLand"], extra["hitBottom"]]
                fmt += ["%d", "%d"]
            np.savetxt(self._csv, np.column_stack(cols),
                       fmt=",".join(fmt))

    def close(self):
        if self._csv is not None:
            self._csv.close()
            self._csv = None
        self._nc = None


def merge_shards(shard_paths, out_path):
    """Merge per-host trajectory shard files into one global NC file.

    Shard files (TrajectoryWriter(shard_tag=...)) hold fixed-length
    per-host slot rows with per-snapshot ``pid_t`` and EMPTY slots as
    ``color < 0``.  The merged file has the single-process layout:
    fixed ``pid`` (sorted union) + (time, particle) variables.
    """
    from ..io.nc import NCFile, write_netcdf

    fs = [NCFile(p) for p in shard_paths]
    try:
        times = fs[0].read("model_time")
        for f in fs[1:]:
            np.testing.assert_allclose(f.read("model_time"), times)
        names = [n for n in fs[0].variables()
                 if n not in ("model_time", "pid", "pid_t")]
        pid_t = np.concatenate([f.read("pid_t") for f in fs], axis=1)
        keep = np.concatenate([f.read("color") for f in fs], axis=1) >= 0
        # global pid set: union over ALL snapshots (a pid may be absent
        # at snapshot 0 — late release into a migrated-away slot — or
        # vanish later via a migration drop; an all-empty first
        # snapshot must not crash, and unseen pids must not alias onto
        # row 0)
        pids = np.unique(pid_t[keep])
        npar = int(pids.shape[0])
        if npar == 0:
            write_netcdf(out_path, {"time": None},
                         {"model_time": (("time",), times)})
            return
        lookup = np.full(int(pids.max()) + 2, -1, np.int64)
        lookup[pids] = np.arange(npar)
        out = RecordFile(out_path, npar, {"pid": pids.astype(np.int32)},
                         {})
        for k in range(len(times)):
            rows = lookup[pid_t[k][keep[k]]]
            assert (rows >= 0).all(), "shard pid outside the union"
            rec = {"model_time": np.float64(times[k])}
            for n in names:
                col = np.concatenate([f.read(n, k) for f in fs])
                # pids absent at snapshot k (not yet in any shard /
                # dropped) keep a zero fill
                buf = np.zeros(npar, col.dtype)
                buf[rows] = col[keep[k]]
                rec[n] = buf
            out.append(rec)
    finally:
        for f in fs:
            f.close()
