"""The port's public surface against the JAX package's.

The JAX package's source is walked with ``ast`` (nothing of it is
imported): every public module-level function and class, every method of
a public class (private ones too, dunders aside), every field a class
declares, every upper-case module constant, and every argument of a public
function or method.  The port must have each at the mirrored module path
(``elmkernels_tpu/x/y.py`` -> ``elmkernels_torch.x.y``; the JAX repo's
``examples/``, ``tools/`` and ``bench.py`` -> ``elmkernels_torch.examples``,
``.tools`` and ``.bench``), or in the module the port merged it into
(``MERGED``), checked on the imported port module.  What stays absent is
listed in ``ABSENT`` with its reason; a second test holds that list to
names the JAX package still has, so that it cannot go stale.  A name added
to the JAX package fails the first test until the port has it or the list
gives a reason.
"""

from __future__ import annotations

import ast
import functools
import importlib
import inspect
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

# the JAX source files, relative to the repo root
SOURCES = ("elmkernels_tpu/**/*.py", "examples/*.py", "bench.py",
           "tools/*.py", "tools/goldengen/*.py")

# JAX source file -> the port module that holds its names
MERGED = {
    "elmkernels_tpu/data/snicar_data.py": "elmkernels_torch.data.params",
    "elmkernels_tpu/data/netcdf_io.py": "elmkernels_torch.data.netcdf",
    "examples/run_model.py": "elmkernels_torch.run_model",
}

# absences by design: "<JAX file>" for a whole file, "<JAX file>::<name>"
# for one name (as ``inventory`` spells it) -> the reason
ABSENT = {
    "tools/compile_breakdown.py":
        "times XLA's compile by phase: eager PyTorch compiles nothing",
    "tools/canopy_compile_probe.py":
        "times XLA's compile of the canopy loop: eager PyTorch compiles "
        "nothing",
    "tools/analyze_trace.py":
        "reads XLA's XSpace trace; tools/profile_step.py sums its own "
        "torch.profiler trace",
    "tools/make_forcing_files.py":
        "data/synthetic.py writes the same month files "
        "(forcing_month_fields, write_forcing_months)",
    "tools/make_global_surfdata.py":
        "data/synthetic.py writes the same surfdata (global_grid_fields, "
        "write_global_surfdata, global_surfdata)",
    "tools/goldengen/pft_alb.py":
        "goldengen/ builds the reference's C++ to write the golden "
        "fixtures; the port reads the fixtures",
    "tools/goldengen/pft_psn.py":
        "goldengen/ builds the reference's C++ to write the golden "
        "fixtures; the port reads the fixtures",
    "elmkernels_tpu/config.py::RunConfig.platform":
        "a JAX platform; the port's field is RunConfig.device",
    "elmkernels_tpu/driver/model.py::Model._params_sharding":
        "a jax.sharding layout; Model(sharding=mesh) holds one rank's block",
    "elmkernels_tpu/driver/model.py::Model._state_sharding":
        "a jax.sharding layout; Model(sharding=mesh) holds one rank's block",
    "elmkernels_tpu/driver/model.py::Model._window_sharding":
        "a jax.sharding layout; Model(sharding=mesh) holds one rank's block",
    "elmkernels_tpu/driver/model.py::Model._phen_stack":
        "private: the port's Model.host_windows stacks the phenology with "
        "the forcing",
    "elmkernels_tpu/driver/interface.py::MinimalInterface._host_step":
        "private, a jitted step pinned to qbot_is_rh=False: the port's "
        "advance_with_forcing calls step.advance so",
    "elmkernels_tpu/parallel/mesh.py::column_mesh(devices)":
        "a jax.sharding Mesh over devices; the port's column_mesh takes "
        "this rank's ncol/col0 over a torch.distributed group",
    "elmkernels_tpu/physics/canopy_hydrology.py::jax_erf":
        "a TPU-safe erf; the port calls torch.erf",
    "elmkernels_tpu/physics/canopy_hydrology.py::jax_erf(x)":
        "a TPU-safe erf; the port calls torch.erf",
    "elmkernels_tpu/physics/photosynthesis.py::hybrid_solve(out_init)":
        "the step passes zero outputs, where the kernel starts; "
        "hybrid_solve_plain takes out_init",
}


def _args(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _is_dunder(name: str) -> bool:
    return name.startswith("__") and name.endswith("__")


def inventory(path: pathlib.Path) -> list:
    """The public surface of one source file: ``name``, ``Class.member``,
    ``fn(arg)``, ``Class.method(arg)`` and ``Class(arg)`` (its
    ``__init__``'s)."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out.append(node.name)
                out += [f"{node.name}({a})" for a in _args(node)]
        elif isinstance(node, ast.ClassDef):
            if node.name.startswith("_"):
                continue
            out.append(node.name)
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if b.name == "__init__":
                        out += [f"{node.name}({a})" for a in _args(b)]
                    elif not _is_dunder(b.name):
                        out.append(f"{node.name}.{b.name}")
                        if not b.name.startswith("_"):
                            out += [f"{node.name}.{b.name}({a})"
                                    for a in _args(b)]
                elif (isinstance(b, ast.AnnAssign)
                      and isinstance(b.target, ast.Name)
                      and not b.target.id.startswith("_")):
                    out.append(f"{node.name}.{b.target.id}")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out += [n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name) and n.id.isupper()
                    and not n.id.startswith("_")]
    return out


@functools.lru_cache(maxsize=None)
def jax_surface() -> dict:
    """{JAX source file: its inventory}."""
    files = sorted({p for pat in SOURCES for p in REPO.glob(pat)})
    return {str(p.relative_to(REPO)): inventory(p) for p in files}


def port_module_of(rel: str) -> str:
    if rel in MERGED:
        return MERGED[rel]
    mod = rel[:-len(".py")].replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[:-len(".__init__")]
    if mod.startswith("elmkernels_tpu"):
        return "elmkernels_torch" + mod[len("elmkernels_tpu"):]
    return "elmkernels_torch." + mod


def _parameters(obj) -> set:
    try:
        return set(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return set()


def _has_member(cls, name: str) -> bool:
    """A class's method, property, NamedTuple or dataclass field, or an
    attribute its constructor takes."""
    fields = getattr(cls, "__dataclass_fields__", {})
    return (hasattr(cls, name) or name in fields
            or name in _parameters(cls))


def port_has(mod, entry: str) -> bool:
    """Whether the imported port module ``mod`` has ``entry``."""
    owner, _, arg = entry.partition("(")
    arg = arg.rstrip(")")
    head, _, member = owner.partition(".")
    if not hasattr(mod, head):
        return False
    obj = getattr(mod, head)
    if member:
        if not _has_member(obj, member):
            return False
        if not arg:
            return True
        return arg in _parameters(getattr(obj, member))
    return not arg or arg in _parameters(obj)


def _absent(rel: str, entry: str) -> bool:
    return rel in ABSENT or f"{rel}::{entry}" in ABSENT


CASES = sorted(jax_surface())


@pytest.mark.parametrize("rel", CASES)
def test_port_has_the_jax_packages_surface(rel):
    entries = [e for e in jax_surface()[rel] if not _absent(rel, e)]
    if not entries:
        return
    mod = importlib.import_module(port_module_of(rel))
    missing = [e for e in entries if not port_has(mod, e)]
    assert not missing, (f"{mod.__name__} lacks {rel}'s {missing}: port "
                         f"them, or give each a reason in ABSENT")


def test_absent_list_names_only_what_the_jax_package_has():
    surface = jax_surface()
    stale = []
    for key, reason in ABSENT.items():
        rel, _, entry = key.partition("::")
        if rel not in surface or (entry and entry not in surface[rel]):
            stale.append(key)
        assert reason.strip(), key
    assert not stale, f"ABSENT names what the JAX package lacks: {stale}"
    # and each listed absence is one: the port does not have it
    for key in ABSENT:
        rel, _, entry = key.partition("::")
        if not entry:
            continue
        mod = importlib.import_module(port_module_of(rel))
        assert not port_has(mod, entry), f"{key} is in the port now"


def test_inventory_reads_every_kind_of_name():
    """The walk sees what it should on one file of each kind."""
    params = jax_surface()["elmkernels_tpu/data/params.py"]
    for e in ("load_snicar_from_text", "load_snicar_from_text(path)",
              "default_params(organic_max)", "ALBSAT_20"):
        assert e in params, e
    state = jax_surface()["elmkernels_tpu/data/state.py"]
    assert {"ModelState.cnc", "ModelState.with_mss(cnc)",
            "ModelState.t_grnd"} <= set(state)
    guard = jax_surface()["elmkernels_tpu/utils/guard.py"]
    assert "StepGuard.errh2o_max" in guard
