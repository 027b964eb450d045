"""What the harness and the reference load: no module whose top-level
name (the part before the first dot, compared whole) is ``jax``,
``jaxlib``, ``flax`` or ``elmkernels_tpu``; and the reference loads
nothing of ``elmkernels_torch``.  Each check runs in a fresh process."""

import subprocess
import sys

from portbench.tests import _util

FORBIDDEN = {"jax", "jaxlib", "flax", "elmkernels_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", "import sys\nsys.path.insert(0, %r)\n%s\n"
         "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))"
         % (str(_util.ROOT), code)],
        capture_output=True, text=True, timeout=600, check=True)
    return set(out.stdout.split())


def test_reference_loads_no_program_and_no_jax():
    top = _loaded(
        "from portbench.reference import columns\n"
        "from portbench.reference.elm.data import forcing_files\n"
        "from portbench import check, inputs, synthetic\n"
        "from portbench.sources import aerosol, forcing, phenology\n"
        "from portbench.rooflines import k2, k5")
    assert not top & FORBIDDEN
    assert "elmkernels_torch" not in top
    # the port's name begins with the JAX package's: compared whole
    assert "elmkernels" not in top


def test_harness_loads_no_jax():
    top = _loaded(
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('r', %r)\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(run)\n"
        "from portbench import drive, manifest, trace, readings\n"
        "from portbench.drives import coupled, windows\n"
        "import elmkernels_torch.driver.model, "
        "elmkernels_torch.driver.interface"
        % str(_util.ROOT / "portbench" / "run.py"))
    assert "elmkernels_torch" in top and not top & FORBIDDEN


def test_no_card_no_result():
    # on a machine without a CUDA card the command prints no result and
    # exits other than 0
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, str(_util.ROOT / "portbench" / "run.py"),
         "--workload", "global-july-windows", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
