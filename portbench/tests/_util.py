"""Helpers of the benchmark's tests: the checkout on the import path, the
run module, and a cell shrunk to run on the CPU."""

from __future__ import annotations

import importlib.util
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run_module():
    """``portbench/run.py`` as a module (it is a script, not a package
    member)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_run", ROOT / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    path0 = sys.path[0]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[0] = path0
    return mod


# where a cell's short calls start on the CPU, where not at its own start:
# the file-fed cell's window crosses into August, whose file it loads
STARTS = {"global-files-windows": "1985-07-31 22:00"}


def manifest():
    """``BENCHMARK.json`` with the entries of ``files_cell.json`` added: the
    file-fed cell, whose files are in place and which the manifest leaves
    out until the program keeps its columns finite over its window."""
    import json

    from portbench import manifest as manifest_mod
    m = manifest_mod.load()
    extra = json.loads((pathlib.Path(__file__).parent / "files_cell.json")
                       .read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        m[key] = m[key] + extra[key]
    return m


def small_cell(name: str, call_steps: int = 4, window: int = 2,
               compare_steps: int = 2):
    """The cell ``name`` of :func:`manifest` with short calls, for the
    CPU."""
    from portbench import manifest as manifest_mod
    cell = manifest_mod.Cell(manifest(), name)
    t = cell.traffic
    t["start"] = STARTS.get(name, t["start"])
    if "window" in t:
        t.update(call_steps=call_steps, window=window)
    else:
        t["compare"] = dict(t["compare"], steps=compare_steps)
        t["traced_steps"] = 2
    return cell
