"""A windows cell over ranks, rehearsed on the CPU: the harness's leader
and ranks (``portbench/run.py``, ``portbench/ranks.py``) over a gloo group
on 127.0.0.1, each rank a process of ``rank_worker.py`` at 256 columns of
``global-1m-4chip-windows``, two calls of 8 steps in windows of 4.

- Over 2 and 4 ranks the run is correct, the state each compared column
  ends with is bit for bit the one-rank run's on the same seed, and the
  global conservation maxima, which came out of the collectives, equal
  the one-rank run's.
- A fault planted once the window has begun makes ``correct`` false: in
  rank 1's step, a state left unchanged, half of its batch left out, or
  its answers altered (``test_portbench_faults.py``'s faults); on every
  rank, the exchange between them left out.  A rank that raises, is
  killed or loads ``jax`` ends the run with an exit code other than 0 and
  no result line, well within the group's timeout.

The processes run ATen's scalar CPU capability (``ATEN_CPU_CAPABILITY=
default``): a column's last bit then does not depend on its place in the
batch (``tests/test_torch_parallel.py``)."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench.tests import _util

from portbench import ranks  # noqa: E402

WORKER = _util.ROOT / "portbench" / "tests" / "rank_worker.py"
CELL = "global-1m-4chip-windows"
NCOL = 256
SEED = 2**40 + 23


def _launch(out, world: int, fault: str | None = None):
    """(exit code, result line or None, standard error, seconds)."""
    out.mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", ATEN_CPU_CAPABILITY="default")
    cmd = [sys.executable, str(WORKER), "--workload", CELL, "--seed",
           str(SEED), "--seconds", "0", "--trace", "0", "--world", str(world),
           "--ncol", str(NCOL), "--out", str(out)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd + (["--fault", fault] if fault else []),
                          capture_output=True, text=True, env=env,
                          cwd=_util.ROOT, timeout=ranks.TIMEOUT_S + 60)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
    return (proc.returncode, json.loads(lines[-1]) if lines else None,
            proc.stderr, time.monotonic() - t0)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    out = tmp_path_factory.mktemp("one")
    rc, res, err, _ = _launch(out / "run", 1)
    assert rc == 0 and res is not None, err[-4000:]
    return res, torch.load(out / "run" / "rank0.pt", weights_only=True)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_agree_with_one_rank(world, one_rank, tmp_path):
    res1, kept1 = one_rank
    rc, res, err, _ = _launch(tmp_path / "run", world)
    assert rc == 0 and res is not None, err[-4000:]
    assert res["correct"] and res["checks"]["state_gap"]["value"] == 0.0
    assert res["checks"]["ranks_disagree"] == dict(value=0, limit=0)
    assert res["device"]["count"] == world
    assert res["attempted"] == res1["attempted"] == 8
    assert res["metrics"]["grid_column_steps_per_s"]["value"] > 0
    parts = [torch.load(tmp_path / "run" / f"rank{r}.pt", weights_only=True)
             for r in range(world)]
    # each rank followed its own block's columns, together every column
    cols = torch.cat([p["cols"] for p in parts])
    assert torch.equal(cols, kept1["cols"])
    for k, v in kept1["state"].items():
        assert torch.equal(torch.cat([p["state"][k] for p in parts]), v), k
    for p in parts:
        for k, v in kept1["conservation"].items():
            assert torch.equal(p["conservation"][k], v), k
    for k in ("errh2o_led_max", "errlon_max", "errsol_max"):
        assert res["checks"][k] == res1["checks"][k]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "alone"])
def test_a_fault_makes_it_incorrect(fault, tmp_path):
    rc, res, err, _ = _launch(tmp_path / "run", 2, fault)
    assert rc == 0 and res is not None, err[-4000:]
    assert not res["correct"], res["checks"]
    checks = res["checks"]
    if fault == "alone":
        assert checks["ranks_disagree"]["value"] > 0
    else:
        assert checks["state_gap"]["value"] > checks["state_gap"]["limit"]
        assert "(rank 1)', 'ranks_disagree'" in err


@pytest.mark.parametrize("fault", ["raise", "killed", "jax"])
def test_a_failed_rank_ends_the_run_without_a_result(fault, tmp_path):
    rc, res, err, took = _launch(tmp_path / "run", 2, fault)
    assert rc != 0 and res is None, err[-4000:]
    assert took < ranks.TIMEOUT_S
    if fault == "jax":
        assert "rank 1 loaded ['jax']" in err
