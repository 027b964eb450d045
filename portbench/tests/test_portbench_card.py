"""On the card: a short run of each cell through the command, as the
benchmark's check runs it, ends with a correct result line.  Marked
``cuda``; skips without a card, or without as many as the cell asks for.

    python3 -m pytest -p no:cacheprovider -m cuda portbench/tests"""

import json
import subprocess
import sys

import pytest

from portbench.tests import _util

CELLS = ["global-july-windows", "utqiagvik-spring-windows",
         "utqiagvik-coupled", "global-1m-4chip-windows"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(name):
    import torch
    from portbench import manifest
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chips = manifest.Cell(manifest.load(), name).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    proc = subprocess.run(
        [sys.executable, str(_util.ROOT / "portbench" / "run.py"),
         "--workload", name, "--seed", str(2**33 + 1), "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["attempted"] > 0
    assert res["device"]["count"] == chips
