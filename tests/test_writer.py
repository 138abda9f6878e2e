"""Trajectory writer: streaming NetCDF3 appends + vectorized CSV.

Reference: writeOutput (LTRANS.f90, SURVEY.md SS3.4) appends snapshots
incrementally every iprint; the writer must do the same with O(1) host
memory (VERDICT r2: buffering every snapshot broke 1M-10M runs).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from ltjax import state as st
from ltjax.config import Config
from ltjax.io.nc import NCFile
from ltjax.out.writer import TrajectoryWriter


@pytest.fixture()
def particles():
    rng = np.random.default_rng(0)
    n = 1000
    p = st.init_particles(rng.uniform(0, 1e4, n), rng.uniform(0, 1e4, n),
                          rng.uniform(-50, -1, n), dtype=jnp.float64)
    return p._replace(status=jnp.full(n, st.ACTIVE, jnp.int32))


def test_streaming_nc_and_csv(tmp_path, particles):
    cfg = Config(outpath=str(tmp_path), NCOutFile="traj", writeCSV=True,
                 writeNC=True, WriteHeaders=True, TrackCollisions=True,
                 SphericalProjection=False)
    w = TrajectoryWriter(cfg)
    for k in range(3):
        w.snapshot(k * 3600.0, particles)
        # the NC file grows incrementally — no close-time dump
        assert w._nt == k + 1
    w.close()

    f = NCFile(os.path.join(str(tmp_path), "traj.nc"))
    lon = f.read("lon")
    assert lon.shape == (3, particles.n)
    t = f.read("model_time")
    np.testing.assert_allclose(t, [0.0, 3600.0, 7200.0])
    assert f.read("color").dtype == np.int32
    assert f.read("pid").shape == (particles.n,)
    # hitLand present when TrackCollisions
    assert f.read("hitLand").shape == (3, particles.n)
    f.close()

    csv = open(os.path.join(str(tmp_path), "traj.csv")).read().splitlines()
    assert csv[0].startswith("time,id,lon,lat,depth,status")
    assert len(csv) == 1 + 3 * particles.n
    row = csv[1].split(",")
    assert float(row[0]) == 0.0 and int(row[1]) == 0


def test_nc_roundtrip_values(tmp_path, particles):
    cfg = Config(outpath=str(tmp_path), NCOutFile="vals", writeCSV=False,
                 writeNC=True, SphericalProjection=False)
    w = TrajectoryWriter(cfg)
    w.snapshot(0.0, particles)
    w.close()
    f = NCFile(os.path.join(str(tmp_path), "vals.nc"))
    # planar projection: lon == x / (Earth_Radius * pi/180)-ish; just
    # check depth passthrough which is projection-free
    np.testing.assert_allclose(f.read("depth")[0],
                               np.asarray(particles.z), rtol=0, atol=0)
    f.close()


def test_merge_shards_union_and_empty_first_snapshot(tmp_path):
    """Advisor r4-low: the merged pid set must be the union over ALL
    snapshots — an all-empty FIRST snapshot (e.g. every slot of a host
    migrated away before the first output) must not crash, and a pid
    first seen at a later snapshot must land in its own row, not alias
    particle 0's."""
    from ltjax.out.writer import merge_shards

    cfg = Config(numpar=4, outpath=str(tmp_path), NCOutFile="sh",
                 writeNC=True, writeCSV=False)
    w = TrajectoryWriter(cfg, shard_tag="_h000")

    def snap(pids, statuses):
        n = 4
        arr = np.zeros(n)
        p = st.Particles(
            x=jnp.asarray(arr + 1.0), y=jnp.asarray(arr + 2.0),
            z=jnp.asarray(arr - 5.0), dob=jnp.asarray(arr),
            age=jnp.asarray(arr), status=jnp.asarray(statuses, jnp.int32),
            pid=jnp.asarray(pids, jnp.int32),
            settle_poly=jnp.full(n, -1, jnp.int32),
            hit_land=jnp.zeros(n, jnp.int32),
            hit_bottom=jnp.zeros(n, jnp.int32),
            salt=jnp.asarray(arr), temp=jnp.asarray(arr))
        return p

    EMPTY = -1
    # snapshot 0: ALL slots empty (previously crashed pids.max())
    w.snapshot(0.0, snap([0, 0, 0, 0], [EMPTY] * 4))
    # snapshot 1: pids 7 and 3 appear
    w.snapshot(1.0, snap([7, 3, 0, 0], [1, 1, EMPTY, EMPTY]))
    # snapshot 2: pid 11 appears late (previously aliased onto row 0)
    w.snapshot(2.0, snap([7, 3, 11, 0], [1, 1, 1, EMPTY]))
    w.close()

    out = os.path.join(tmp_path, "merged.nc")
    merge_shards([os.path.join(tmp_path, "sh_h000.nc")], out)
    f = NCFile(out)
    pids = np.asarray(f.read("pid"))
    np.testing.assert_array_equal(pids, [3, 7, 11])
    color = np.asarray(f.read("color"))
    assert color.shape == (3, 3)
    # pid 11 absent before snapshot 2 -> zero-filled rows, present after
    assert color[2, list(pids).index(11)] == 1


@pytest.fixture
def no_h5py(monkeypatch):
    """Make ``import h5py`` fail, as on a machine without it."""
    import sys
    monkeypatch.setitem(sys.modules, "h5py", None)


@pytest.mark.parametrize("tag", ["", "_h000"])
def test_writer_and_merge_round_trip_without_h5py(tmp_path, particles,
                                                  no_h5py, tag):
    """Trajectory files are NetCDF3 64-bit offset (CDF-2), written and
    merged with scipy alone, and read back value for value."""
    from ltjax.out.writer import merge_shards

    cfg = Config(outpath=str(tmp_path), NCOutFile="t", writeNC=True,
                 writeCSV=False, SaltTempOn=True, SphericalProjection=False)
    w = TrajectoryWriter(cfg, shard_tag=tag)
    moved = particles._replace(z=particles.z - 1.0)
    for k, p in enumerate((particles, moved, particles)):
        w.snapshot(k * 60.0, p)
    w.close()
    path = os.path.join(str(tmp_path), f"t{tag}.nc")
    with open(path, "rb") as f:
        assert f.read(4) == b"CDF\x02"
    if tag:
        merged = os.path.join(str(tmp_path), "merged.nc")
        merge_shards([path], merged)
        path = merged
    with NCFile(path) as f:
        np.testing.assert_array_equal(f.read("pid"),
                                      np.arange(particles.n))
        np.testing.assert_allclose(f.read("model_time"), [0.0, 60.0, 120.0])
        depth = f.read("depth")
        np.testing.assert_array_equal(depth[1], np.asarray(moved.z))
        np.testing.assert_array_equal(depth[2], np.asarray(particles.z))
        assert f.read("color").dtype == np.int32
        assert f.read("salt").shape == (3, particles.n)


def test_netcdf4_input_names_h5py_when_missing(tmp_path, no_h5py):
    path = tmp_path / "hist.nc"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(64))
    with pytest.raises(ImportError, match="h5py"):
        NCFile(str(path))
