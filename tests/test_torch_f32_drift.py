"""The port's counterpart of ``tests/test_f32_drift.py``: the coupled model
run by ``python -m elmkernels_torch.tools.f32_traj`` in float32 and in
float64 (two processes, as the JAX test runs ``tools/f32_traj.py`` with and
without ``--x64``), from 1 January on the CPU, the state drift and the
conservation errors held to the JAX test's bounds (set there at ~5x the
drift measured over 720 steps).

Two horizons: 48 steps (4 columns) in the default tier, and the JAX test's
720 steps, across snow-layer creation, marked ``slow`` as the JAX test is.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
BOUNDS = {  # absolute, tests/test_f32_drift.py's
    "state_t_soisno": 0.15,      # K
    "state_t_grnd": 0.05,
    "state_t_veg": 0.05,
    "state_t_h2osfc": 0.05,
    "state_h2osno": 0.01,        # mm
    "state_h2osoi_liq": 0.1,
    "state_h2osoi_ice": 0.1,
    "state_h2ocan": 1e-4,
    "state_snow_depth": 1e-4,    # m
    "state_frac_sno": 1e-5,
    "state_dz": 1e-4,
}


@pytest.fixture(scope="module", params=[
    (48, 24), pytest.param((720, 240), marks=pytest.mark.slow)],
    ids=["48_steps", "720_steps"])
def trajectories(request, tmp_path_factory):
    steps, window = request.param
    tmp = tmp_path_factory.mktemp(f"f32drift{steps}")
    out = {}
    for dtype in ("float32", "float64"):
        path = tmp / f"{dtype}.npz"
        res = subprocess.run(
            [sys.executable, "-m", "elmkernels_torch.tools.f32_traj",
             "--ncol", "4", "--steps", str(steps), "--window", str(window),
             "--dtype", dtype, "--platform", "cpu", "--out", str(path)],
            cwd=REPO, capture_output=True, text=True, timeout=1500,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert res.returncode == 0, (res.stdout, res.stderr[-4000:])
        out[dtype] = np.load(path)
    assert out["float32"]["state_t_grnd"].dtype == np.float32
    assert out["float64"]["state_t_grnd"].dtype == np.float64
    return steps, out["float32"], out["float64"]


def test_f32_everything_finite(trajectories):
    _, f32, _ = trajectories
    bad = [k for k in f32.files
           if f32[k].dtype.kind == "f" and not np.all(np.isfinite(f32[k]))]
    assert not bad, f"non-finite float32 outputs: {bad}"


def test_f32_snow_layer_count_identical(trajectories):
    steps, f32, f64 = trajectories
    if steps >= 720:   # the short horizon ends before layers form
        assert f64["state_snl"].max() > 0, "run never created snow layers"
    np.testing.assert_array_equal(f32["state_snl"], f64["state_snl"])


def test_f32_state_drift_bounded(trajectories):
    _, f32, f64 = trajectories
    fails = []
    for k, bound in BOUNDS.items():
        d = np.abs(f32[k].astype(np.float64) - f64[k]).max()
        if d > bound:
            fails.append(f"{k}: |drift|={d:.3e} > {bound}")
    assert not fails, fails


def test_f32_conservation_bounded(trajectories):
    _, f32, f64 = trajectories
    assert np.abs(f32["diag_errsol_max"]).max() < 1e-3
    assert np.abs(f32["diag_errlon_max"]).max() < 1e-3
    # errh2osno carries a real model residual in float64 too: float32
    # must track float64, not beat it
    dd = np.abs(f32["diag_errh2osno_max"] - f64["diag_errh2osno_max"])
    assert dd.max() < 1e-4
    assert np.abs(f32["diag_errh2osno_max"]).max() < 0.02
    assert np.all(np.isfinite(f32["diag_errseb_max"]))
    assert np.abs(f32["diag_errseb_max"]).max() < 300.0
