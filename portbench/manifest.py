"""The benchmark's manifest, ``BENCHMARK.json`` at the root of the
checkout, and the files it names.  Everything that belongs to one
configuration, traffic mix, cell, input kind, drive or metric is a file of
its own, found by its name:

- ``configs/<config>.json`` (the manifest's ``configs[].file``);
- ``traffic/<traffic>.json``, whose ``entry`` names a drive;
- ``limits/<cell>.json``: the limits of the numbers a cell compares;
- ``sources/<kind>.py``: an input kind, one for each key of a
  configuration's ``inputs`` that is not false.  It writes its files once
  a checkout (``write(cfg, ncol, files) -> {key: path}``), gives the
  program's ``Model`` the keywords those files feed (``model_kw(cfg,
  files)``), and gives the reference its provider of the same input for
  the compared columns (``reference(cfg, files, cols, grid)``, the
  provider's role in ``ROLE``: ``forcing``, ``phenology`` or
  ``aerosol``); optionally ``horizon(cfg)``, the last moment its inputs
  cover, which no step of a run may pass.  The provider itself may live
  in a new file under ``reference/``;
- ``drives/<entry>.py``: how the program is driven, its class in
  ``DRIVE`` (a subclass of ``portbench.drive.Drive``);
- ``metrics/<metric>.py``: a per-layer reader with ``read(record) ->
  float | None``, and ``ROOFLINE = "<kernel>"`` where it reads a kernel's
  bound;
- ``end_to_end/<metric>.py``: an end-to-end metric that reads the
  window's readings under another name (``read(measured) -> float``); an
  end-to-end metric with no file is the drive's reading of its own name;
- ``rooflines/<kernel>.py``: a kernel's counts, with ``launch_ms(run)``.

Adding a cell, a mix, a metric, an input kind, a drive or a reference
reader adds files and manifest entries and edits none.  A configuration
that names an input kind, or a mix that names a drive, with no file is
refused at once (:class:`Unknown`): nothing runs without it."""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class Unknown(Exception):
    """A configuration or mix names an input kind or a drive that has no
    file."""


def load(path=None) -> dict:
    return json.loads(pathlib.Path(path or ROOT / "BENCHMARK.json")
                      .read_text())


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_module(here: pathlib.Path, kind: str, name: str):
    """The module of ``<here>/<kind>/<name>.py``: in this benchmark's own
    packages (``drives``, ``sources``, ``rooflines``) imported by its
    name, so that every user shares one module; else loaded from its
    file."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise Unknown(f"no {kind}/{name}.py in {here}")
    if (here == HERE and name.isidentifier()
            and (here / kind / "__init__.py").is_file()):
        return importlib.import_module(f"portbench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kinds_of(cfg: dict, here: pathlib.Path = HERE) -> dict:
    """{kind: module} of the input kinds a configuration names."""
    return {k: load_module(here, "sources", k)
            for k, v in cfg.get("inputs", {}).items() if v}


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
        self.kinds = kinds_of(self.config, here)
        self.drive_class = self.module("drives",
                                       self.traffic["entry"]).DRIVE

    def module(self, kind: str, name: str):
        """The module of ``<kind>/<name>.py`` (``metrics``, ``end_to_end``,
        ``rooflines``, ``drives``, ``sources``)."""
        return load_module(self.here, kind, name)

    def has(self, kind: str, name: str) -> bool:
        return (self.here / kind / f"{name}.py").is_file()

    def drive(self, seed: int, device, **kw):
        """The cell's drive of its program (``sizes``, ``group``:
        :class:`portbench.drive.Drive`)."""
        return self.drive_class(self.config, self.traffic, seed, device,
                                kinds=self.kinds, **kw)

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric's file."""
        return self.module("metrics", metric).read

    def listed(self, metric: dict) -> bool:
        """Whether the manifest lists this cell in the metric's
        ``workloads``: there the metric has to read a number."""
        return self.name in metric.get("workloads", ())
