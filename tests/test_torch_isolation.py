"""The PyTorch port stands alone: no module of ``elmkernels_torch`` and no
line of ``chip_smoke.py`` imports JAX or the JAX package or loads a binary
of the JAX tree (every ``ctypes`` load opens a library the port built under
``build/``), the model refuses to run without a card unless asked for the
CPU, and the kernel wrappers take only CUDA tensors."""

import ast
import importlib.util
import io
import pathlib
import subprocess
import sys
import tokenize

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


# ---- no binary of the JAX tree ---------------------------------------------

# every ctypes load of the port: (file, enclosing function) -> the source of
# its library argument, and the paths that load opens
def _build_targets(mod):
    return [mod._target(name) for name in mod.SOURCES]


def _native_targets(mod):
    return [mod.library_path()]


def _probe_targets(mod):
    return [mod.REPO / "build" / "probe" / "libk1t_probe.so"]


LOADERS = {
    ("elmkernels_torch/ops/build.py", "load"):
        ("str(_target(name))", _build_targets),
    ("elmkernels_torch/io/native.py", "_load"):
        ("str(build())", _native_targets),
    ("chip_smoke.py", "k1t_probe"): ("str(lib)", _probe_targets),
}
_CTYPES_LOADS = {"CDLL", "PyDLL", "LoadLibrary"}


def _docstrings(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                out.add(id(first.value))
    return out


def _ctypes_loads(path: pathlib.Path):
    """(innermost enclosing function or None, library argument's source)
    of every ``ctypes.CDLL``/``cdll.LoadLibrary``-style call in ``path``."""
    out = []

    def visit(node, where):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            where = node.name
        if isinstance(node, ast.Call):
            f = node.func
            name = (f.attr if isinstance(f, ast.Attribute)
                    else f.id if isinstance(f, ast.Name) else None)
            if name in _CTYPES_LOADS:
                out.append((where, ast.unparse(node.args[0]) if node.args
                            else ""))
        for child in ast.iter_child_nodes(node):
            visit(child, where)
    visit(ast.parse(path.read_text()), None)
    return out


def _module(rel: str):
    spec = importlib.util.spec_from_file_location(
        "_iso_" + rel.replace("/", "_")[:-3], REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_ctypes_load_opens_a_library_under_build():
    """Each ctypes load in the port is a known one, and the libraries it
    opens lie under the checkout's ``build/`` (a new load must be added
    to ``LOADERS`` with the paths it opens)."""
    found = [((str(p.relative_to(REPO)), where), arg)
             for p in _port_sources() for where, arg in _ctypes_loads(p)]
    assert sorted(k for k, _ in found) == sorted(LOADERS), found
    found = dict(found)
    build_dir = (REPO / "build").resolve()
    for key, (arg, targets) in LOADERS.items():
        assert found[key] == arg, (key, found[key])
        mod = (importlib.import_module(key[0][:-3].replace("/", "."))
               if key[0].startswith("elmkernels_torch/")
               else _module(key[0]))
        for path in targets(mod):
            assert pathlib.Path(path).resolve().is_relative_to(build_dir), (
                key, path)


def _path_parts(node):
    """The string parts of a ``a / "b" / "c"`` chain, or None."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        left = _path_parts(node.left)
        right = _path_parts(node.right)
        return (left or [None]) + (right or [None])
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    return None


def test_no_source_names_the_jax_trees_binaries():
    """No string or comment of a port source holds ``native/libelmio.so``
    or the JAX tree's ``native/`` directory as a path; a ``"native"``
    path part is allowed only under ``"build"``.  Docstrings that name a
    JAX counterpart stay allowed."""
    bad = []
    for p in _port_sources():
        rel = p.relative_to(REPO)
        text = p.read_text()
        tree = ast.parse(text)
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                v = node.value.replace("\\", "/")
                if "libelmio.so" in v or (
                        "native/" in v and "build/native/" not in v):
                    bad.append(f"{rel}:{node.lineno}: {node.value!r}")
            parts = _path_parts(node) if isinstance(node, ast.BinOp) else None
            if parts:
                for i, part in enumerate(parts):
                    if part == "native" and (i == 0 or parts[i - 1]
                                             != "build"):
                        bad.append(f"{rel}:{node.lineno}: path {parts}")
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT and "libelmio.so" in tok.string:
                bad.append(f"{rel}:{tok.start[0]}: {tok.string}")
    assert not bad, bad


def test_native_reader_maps_only_the_ports_library(tmp_path):
    """In a fresh interpreter, the port's reader builds, reads a file
    (through a prefetch too) and maps its own library from
    ``build/native``; no file of the JAX tree (``native/``,
    ``elmkernels_tpu/``) is mapped into the process."""
    code = (
        "import sys, numpy as np\n"
        "from elmkernels_torch.data import netcdf\n"
        "from elmkernels_torch.io import native\n"
        f"path = {str(tmp_path / 'a.nc')!r}\n"
        "netcdf.write_nc(path, {'x': 3}, {'a': (('x',), np.arange(3.0))})\n"
        "netcdf.prefetch(path)\n"
        "assert netcdf.read_var(path, 'a').tolist() == [0.0, 1.0, 2.0]\n"
        "maps = open('/proc/self/maps').read().split()\n"
        "libs = sorted({m for m in maps if m.startswith('/')})\n"
        "print('\\n'.join(libs))\n"
        "print('LIB', native.library_path())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=300, check=True)
    lines = res.stdout.splitlines()
    lib = pathlib.Path(lines[-1].split(" ", 1)[1])
    mapped = [pathlib.Path(m) for m in lines[:-1]]
    assert lib in mapped
    assert lib.resolve().is_relative_to((REPO / "build" / "native").resolve())
    jax_tree = [(REPO / "native").resolve(),
                (REPO / "elmkernels_tpu").resolve()]
    bad = [m for m in mapped
           if any(m.resolve().is_relative_to(d) for d in jax_tree)]
    assert not bad, bad
