"""chip_smoke.py off the card: its refusal to run anywhere but a GPU,
and each of its phases rehearsed at a tiny size on the CPU (the
four-card phase on four of the suite's virtual devices)."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(nx=24, ny=24, us=6)


def test_device_check_refuses_the_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.main([])


def test_script_exits_nonzero_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_cli_phase_runs_through_run_main(tmp_path):
    res = chip_smoke.phase_cli(str(tmp_path), numpar=400, n_ext=2, **TINY)
    assert res["err_h_m"] <= res["tol_h_m"]
    assert res["err_z_m"] <= res["tol_z_m"]
    assert len(res["step_s"]) == 2
    nml = (tmp_path / "LTRANS.data").read_text()
    assert "numpar = 400" in nml and "dtype_pos = 'float32'" in nml
    json.dumps(res)                     # phase results print as JSON


def test_reference_phase_tiny():
    res = chip_smoke.phase_reference(2000, **TINY)
    for prec in ("highest", "default"):
        assert res[prec]["max_dxy_m"] <= res["tol_h_m"]
    assert res["tf32_on_path"] is False


def test_sharded_phase_on_four_virtual_devices(tmp_path):
    res = chip_smoke.phase_sharded(str(tmp_path), numpar=2000, n_ext=2,
                                   mesh=(2, 2), **TINY)
    assert res["max_dxy_m"] <= res["tol_h_m"]
