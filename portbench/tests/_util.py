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


def small_cell(name: str, call_steps: int = 4, window: int = 2,
               compare_steps: int = 2):
    """The manifest's cell ``name`` with short calls, for the CPU."""
    from portbench import manifest
    cell = manifest.Cell(manifest.load(), name)
    t = cell.traffic
    if "window" in t:
        t.update(call_steps=call_steps, window=window)
    else:
        t["compare"] = dict(t["compare"], steps=compare_steps)
        t["traced_steps"] = 2
    return cell
