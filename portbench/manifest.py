"""The benchmark's manifest, ``BENCHMARK.json`` at the root of the
checkout, and the files it names.  Everything that belongs to one
configuration, traffic mix, cell or per-layer metric is a file of its own,
found by its name:

- ``configs/<config>.json`` (the manifest's ``configs[].file``);
- ``traffic/<traffic>.json``;
- ``limits/<cell>.json``: the limits of the numbers a cell compares;
- ``metrics/<metric>.py``: a reader with ``read(record) -> float | None``,
  and ``ROOFLINE = "<kernel>"`` where it reads a kernel's bound;
- ``rooflines/<kernel>.py``: a kernel's counts, with ``launch_ms(run)``.

Adding a cell, a mix or a metric adds files and manifest entries and edits
none."""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load(path=None) -> dict:
    return json.loads(pathlib.Path(path or ROOT / "BENCHMARK.json")
                      .read_text())


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, manifest: dict, name: str, here=HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in the manifest "
                           f"(has {sorted(cells)})")
        w = cells[name]
        self.name, self.chips = name, int(w["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = _json(here.parent / configs[w["config"]]["file"])
        self.traffic = _json(here / "traffic" / f"{w['traffic']}.json")
        self.limits = _json(here / "limits" / f"{name}.json")["limits"]
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in moved]
        self.here = here

    def module(self, kind: str, name: str):
        """The module of ``<kind>/<name>.py`` (``metrics``, ``rooflines``)."""
        path = self.here / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric's file."""
        return self.module("metrics", metric).read

    def listed(self, metric: dict) -> bool:
        """Whether the manifest lists this cell in the metric's
        ``workloads``: there the metric has to read a number."""
        return self.name in metric.get("workloads", ())
