"""The PyTorch port stands alone: no module of ``elmkernels_torch`` and no
line of ``chip_smoke.py`` imports JAX or the JAX package, the model refuses
to run without a card unless asked for the CPU, and the kernel wrappers
take only CUDA tensors."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "elmkernels_tpu")


def _port_sources():
    files = sorted((REPO / "elmkernels_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0], node.lineno


def test_port_sources_import_no_jax():
    files = _port_sources()
    assert len(files) > 20  # the whole package was found
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in files for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_port_import_loads_no_jax():
    """Importing the whole port in a fresh interpreter loads no JAX."""
    code = ("import sys, pkgutil, importlib, elmkernels_torch\n"
            "for m in pkgutil.walk_packages(elmkernels_torch.__path__,"
            " 'elmkernels_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_model_refuses_cpu_fallback(monkeypatch):
    from elmkernels_torch.driver.model import Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(ncol=4)


def test_model_runs_on_cpu_when_asked(tmp_path):
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    pft, snicar = tmp_path / "p.nc", tmp_path / "s.nc"
    synthetic.write_clm_params(pft)
    synthetic.write_snicar_optics(snicar)
    m = Model(ncol=4, pft_path=str(pft), snicar_path=str(snicar),
              device="cpu")
    assert m.state.t_soisno.device.type == "cpu"
    assert m.state.t_soisno.dtype == torch.float64
    assert m.state.snl.dtype == torch.int64


def test_kernel_wrappers_take_only_cuda_tensors():
    from elmkernels_torch.ops import testing
    from elmkernels_torch.ops.ci_solver import ci_hybrid_solve
    from elmkernels_torch.ops.pdma import pdma_solve
    x0, env, en = testing.ci_problem_tensors(8, 0, "c3", torch.float64,
                                             "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ci_hybrid_solve(x0, env, "c3", en)
    lhs, rhs = testing.pdma_problem(4, 0)
    with pytest.raises(ValueError, match="CUDA"):
        pdma_solve(torch.tensor(lhs), torch.tensor(rhs))
