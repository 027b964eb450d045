"""The port's twins of the JAX package's remaining tools, each run once as
``python -m elmkernels_torch.tools.<name>`` on the CPU at a tiny size,
printing the JAX script's output keys: ``ingest_bench`` (both modes),
``capacity_probe``, ``f32_check``, ``mixed_canopy_drift`` (one day),
``weak_scaling`` (1 and 2 gloo ranks) and ``gen_api_docs``.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_keys(script: str, pattern) -> set:
    """The keys of the dict literals inside the ``json.dumps(...)`` calls
    of the JAX package's ``tools/<script>``, read from its source (not
    imported), filtered by ``pattern(keys)``."""
    tree = ast.parse((REPO / "tools" / script).read_text())
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"):
            for d in ast.walk(node):
                if isinstance(d, ast.Dict):
                    keys = {k.value for k in d.keys
                            if isinstance(k, ast.Constant)}
                    if keys and pattern(keys):
                        found.append(keys)
    return set().union(*found)


def _run(module, env=None, args=(), timeout=600):
    res = subprocess.run(
        [sys.executable, "-m", f"elmkernels_torch.tools.{module}", *args],
        cwd=REPO, text=True, capture_output=True, timeout=timeout,
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})))
    assert res.returncode == 0, res.stderr[-4000:]
    return res


def _last_json(res):
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_ingest_bench_files_mode(tmp_path):
    res = _run("ingest_bench", dict(
        IB_PLATFORM="cpu", IB_FILES="1", IB_NCOL="6", IB_NLON="4",
        IB_WINDOW="6", IB_NWIN="2", IB_FORCDIR=str(tmp_path / "forc")))
    rec = _last_json(res)
    want = _jax_keys("ingest_bench.py", lambda k: "mode" in k)
    assert want <= set(rec), want - set(rec)
    assert rec["mode"] == "files" and rec["bit_identical"] is True
    assert rec["window_reads_equal"] is True and rec["device"] == "cpu"
    assert sorted(p.name for p in (tmp_path / "forc").iterdir()) == [
        "forc_1985-07.nc", "forc_1985-08.nc"]
    assert "native reader" in res.stderr and "# launches:" in res.stderr


def test_ingest_bench_synthetic_mode():
    rec = _last_json(_run("ingest_bench", dict(
        IB_PLATFORM="cpu", IB_NCOL="4", IB_WINDOW="3", IB_NWIN="2")))
    want = _jax_keys("ingest_bench.py", lambda k: "overlapped_ms" in k)
    assert want <= set(rec), want - set(rec)
    assert all(rec[k] > 0 for k in ("prestaged_ms", "overlapped_ms",
                                    "overlapped_series_ms"))


def test_capacity_probe():
    rec = _last_json(_run("capacity_probe", dict(
        CAP_PLATFORM="cpu", CAP_NCOL="8", CAP_STEPS="2")))
    want = _jax_keys("capacity_probe.py", lambda k: "ncol" in k)
    assert want <= set(rec), want - set(rec)
    assert rec["fits"] is True and rec["ncol"] == 8
    assert rec["errsol_max"] <= rec["errsol_bound"]
    # the memory figures are the card's: none on the CPU
    assert "hbm_peak_gib" not in rec and "peak_bytes_per_col" not in rec


def test_f32_check():
    rec = _last_json(_run("f32_check", args=(
        "--ncol", "4", "--steps", "4", "--platform", "cpu")))
    want = _jax_keys("f32_check.py", lambda k: True) | {
        "errsol_max", "errlon_max", "errh2osno_max", "t_grnd_mean", "ok"}
    assert want <= set(rec), want - set(rec)
    assert rec["ok"] is True and rec["dtype"] == "torch.float32"


def test_mixed_canopy_drift_one_day():
    res = _run("mixed_canopy_drift", dict(
        MCD_PLATFORM="cpu", MCD_NCOL="4", MCD_DAYS="1", MCD_WINDOW="48"))
    rec = json.loads(res.stdout)
    assert {"ncol", "days", "nsteps", "results"} == set(rec)
    assert rec["nsteps"] == 48
    want_rows = {f"{s}/{m}" for s in ("winter", "summer")
                 for m in ("mixed_canopy", "mixed_canopy+warm",
                           "warm_vs_mixed")}
    assert set(rec["results"]) == want_rows
    row = rec["results"]["summer/mixed_canopy"]
    assert {"drift", "snl_mismatch_cols", "errh2o_led_max", "errsol_max",
            "errh2osno_max", "eflx_sh_mean_rmse", "finite",
            "wall_s"} == set(row)
    # the closed water ledger on rainy heterogeneous columns reaches
    # ~8e-9 mm in float64 (the JAX package's step too), as on the global
    # grid, where chip_smoke.py holds it to 2e-8
    assert row["finite"] and row["errh2o_led_max"] < 2e-8
    assert all(np.isfinite(v) for v in row["drift"].values())


def test_weak_scaling_one_and_two_gloo_ranks():
    res = _run("weak_scaling", args=(
        "--cols-per-dev", "4", "--steps", "2", "--devices", "1", "2",
        "--platform", "cpu"))
    recs = _last_json(res)
    assert [r["devices"] for r in recs] == [1, 2]
    assert [r["ncol"] for r in recs] == [4, 8]
    for r in recs:
        assert set(r) == {"devices", "ncol", "per_step_ms", "columns_per_s",
                          "efficiency"}
        assert r["per_step_ms"] > 0 and r["columns_per_s"] > 0
    assert recs[0]["efficiency"] == 1.0


def test_weak_scaling_needs_a_card_unless_asked_for_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "elmkernels_torch.tools.weak_scaling",
         "--devices", "1"], cwd=REPO, text=True, capture_output=True,
        timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 2 and res.stdout == ""
    assert "--platform cpu" in res.stderr


def test_gen_api_docs(tmp_path):
    out = tmp_path / "API_torch.md"
    res = _run("gen_api_docs", args=(str(out),))
    text = out.read_text()
    assert text.startswith("# elmkernels_torch API reference")
    for module in ("elmkernels_torch/io/native.py",
                   "elmkernels_torch/utils/packing.py",
                   "elmkernels_torch/driver/model.py"):
        assert f"## `{module}`" in text
    assert "**`class NativeNetCDF`**" in text
    assert f"wrote {out}" in res.stdout
    # walked by ast: the docs name every module of the port that has a
    # docstring or a public name
    assert text.count("\n## `elmkernels_torch/") >= 60
