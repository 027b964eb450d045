"""The port's twins of the JAX package's entry points, on the CPU at a
tiny size: ``python -m elmkernels_torch.bench`` (``bench.py``),
``elmkernels_torch.examples.run_single_column`` and
``elmkernels_torch.tools.long_run``; and the all-float32 model the bench
twin's ``BENCH_F32=1`` runs, against the float64 one within
``tests/test_f32_drift.py``'s bounds.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import torch_parity as tp
from elmkernels_torch.driver.model import Model
from elmkernels_torch.utils.dates import Date

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
# the JAX bench's headline metric, read from its source (not imported):
# the json.dumps of its result line, not its docstring's "..."
JAX_METRIC, = {m for m in re.findall(r'"metric": "([^"]+)"',
                                     (REPO / "bench.py").read_text())
               if m != "..."}
TINY = dict(BENCH_PLATFORM="cpu", BENCH_NCOL="4", BENCH_DAYS="1")


def _run(module, env=None, args=(), timeout=300):
    return subprocess.run(
        [sys.executable, "-m", module, *args], cwd=REPO, text=True,
        capture_output=True, timeout=timeout,
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})))


@pytest.mark.parametrize("knobs", [dict(BENCH_SCAN="0", BENCH_STEPS="2"),
                                   dict(BENCH_SCAN="1", BENCH_STEPS="1",
                                        BENCH_HETERO="1"),
                                   dict(BENCH_SCAN="0", BENCH_STEPS="2",
                                        BENCH_F32="1")])
def test_bench_prints_one_json_line(knobs):
    res = _run("elmkernels_torch.bench", dict(TINY, **knobs))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == JAX_METRIC
    assert rec["unit"] == "columns/s" and rec["vs_baseline"] == 1.0
    assert rec["value"] > 0
    assert "parameter files (synthetic)" in res.stderr
    assert "per-step:" in res.stderr and "device=cpu" in res.stderr


@pytest.mark.parametrize("knob", [dict(BENCH_COMPILE_EFFORT="1.0"),
                                  dict(BENCH_COMPILE_EFFORT="-1.0"),
                                  dict(BENCH_PLATFORM="tpu")])
def test_bench_refuses_knobs_without_meaning(knob):
    res = _run("elmkernels_torch.bench", dict(TINY, **knob))
    assert res.returncode == 2
    assert res.stdout == ""
    assert "refused" in res.stderr and next(iter(knob)) in res.stderr


def test_bench_needs_a_card_unless_asked_for_the_cpu():
    env = {k: v for k, v in TINY.items() if k != "BENCH_PLATFORM"}
    res = _run("elmkernels_torch.bench", dict(env, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA device" in res.stderr


def test_float32_model_drift_within_jax_bounds(tmp_path):
    """48 steps from 1 January in float32 and float64 (the production
    flags): state drift and conservation within test_f32_drift.py's
    bounds (set there for 720 steps)."""
    files = tp.write_files(tmp_path)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        m = Model(ncol=4, pft_path=files[0], snicar_path=files[1],
                  device="cpu", dtype=dtype)
        d = m.run_windows(Date.from_ymd(1985, 1, 1), 48, window=24,
                          series=True)
        assert m.state.t_grnd.dtype == dtype
        runs[dtype] = (m.state, d)
    (s32, d32), (s64, d64) = runs[torch.float32], runs[torch.float64]
    bounds = {"t_soisno": 0.15, "t_grnd": 0.05, "t_veg": 0.05,
              "t_h2osfc": 0.05, "h2osno": 0.01, "h2osoi_liq": 0.1,
              "h2osoi_ice": 0.1, "h2ocan": 1e-4, "snow_depth": 1e-4,
              "frac_sno": 1e-5, "dz": 1e-4}
    fails = []
    for k, bound in bounds.items():
        a, b = getattr(s32, k).double(), getattr(s64, k)
        assert bool(torch.isfinite(a).all()), k
        drift = float((a - b).abs().max())
        if drift > bound:
            fails.append(f"{k}: |drift|={drift:.3e} > {bound}")
    assert not fails, fails
    assert torch.equal(s32.snl, s64.snl)
    assert float(d32.errsol_max.abs().max()) < 1e-3
    assert float(d32.errlon_max.abs().max()) < 1e-3
    dd = (d32.errh2osno_max.double() - d64.errh2osno_max).abs().max()
    assert float(dd) < 1e-4
    assert float(d32.errh2osno_max.abs().max()) < 0.02
    assert float(d32.errseb_max.abs().max()) < 300.0


def test_pdma_tangent_rule_refuses_float32():
    """K4's tangent rule is float64 (the tangent-linear model's type),
    on the CPU as on the card."""
    from elmkernels_torch.ops import pdma, testing
    lhs, rhs = (torch.tensor(a, dtype=torch.float32)
                for a in testing.pdma_problem(8, 3))
    with pytest.raises(TypeError, match="float64"):
        torch.func.jvp(pdma.PdmaSolve.apply, (lhs, rhs),
                       (torch.zeros_like(lhs), torch.ones_like(rhs)))
    x = pdma.solve(lhs, rhs)
    assert x.dtype == torch.float32


def test_single_column_example_runs():
    res = _run("elmkernels_torch.examples.run_single_column",
               args=("--steps", "3", "--device", "cpu"))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 4 and lines[0].startswith("1985-182 43200")
    assert "t_grnd=" in lines[0] and "errseb=" in lines[0]
    assert lines[-1].startswith("final errsol_max=")


def test_long_run_resumes_bit_for_bit(tmp_path):
    out = tmp_path / "longrun"
    res = _run("elmkernels_torch.tools.long_run",
               dict(LR_PLATFORM="cpu", LR_NCOL="8", LR_STEPS="9",
                    LR_WINDOW="2", LR_OUT=str(out)))
    assert res.returncode == 0, res.stderr
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["nsteps"] == 8 and summary["metrics_windows"] == 4
    assert summary["resume_bit_identical"] is True
    assert summary["guard_failures"] == 0 and summary["checkpoint_window"] == 1
    art = json.loads((out / "longrun.json").read_text())
    assert art["summary"] == summary and len(art["windows"]) == 4
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 4
    assert summary["history_files"] >= 1 and (out / "ckpt.pt").exists()
