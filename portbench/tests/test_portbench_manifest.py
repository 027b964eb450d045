"""The manifest and the files it names: each configuration, mix, cell's
limits, input kind, drive and per-layer metric found by name; a new cell,
metric, input kind, drive or reference reader is a new file and a
manifest entry, and the harness's code stays as it is."""

import json
import re
import shutil

import pytest
import torch

from portbench.tests import _util

from portbench import manifest  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_loads():
    # the manifest and the file-fed cell that waits beside it
    m = _util.manifest()
    assert m["paths"] == ["portbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for w in m["workloads"]:
        cell = manifest.Cell(m, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["entry"] in ("windows", "coupled")
        assert "setup_s" in [x["name"] for x in cell.end_to_end]
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for metric in cell.per_layer:
            assert callable(cell.reader(metric["name"]))
        assert "state_gap" in cell.limits
        # a cell over several cards runs the windows drive as its ranks
        assert cell.chips in (1, 4)
        if cell.chips > 1:
            assert cell.traffic["entry"] == "windows"
            assert cell.config["ranks"] == cell.chips
            assert cell.limits["ranks_disagree"] == 0
    for c in m["configs"]:
        cfg = json.loads((_util.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []


def test_per_layer_metrics_name_their_cells():
    m = _util.manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get(
            "workloads", [w["name"] for w in m["workloads"]]))


def _data_copy(tmp_path):
    """A copy of the benchmark's data files, the harness's code untouched:
    the cells run the repository's ``run.py``, ``check.py`` and the rest
    on what the copy's files name."""
    here = tmp_path / "portbench"
    for sub in DATA:
        shutil.copytree(_util.ROOT / "portbench" / sub, here / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return here


DATA = ("configs", "traffic", "limits", "metrics", "end_to_end", "rooflines",
        "drives", "sources")


def test_a_new_cell_metric_and_roofline_are_files_and_entries(tmp_path):
    here = _data_copy(tmp_path)
    m = manifest.load()
    (here / "traffic" / "january-windows.json").write_text(json.dumps(
        dict(json.loads((here / "traffic" / "july-windows.json")
                        .read_text()), start="1985-01-01 00:00")))
    (here / "limits" / "global-january-windows.json").write_text(
        json.dumps({"limits": {"state_gap": 1e-9}}))
    # a new kernel's counts, and two metrics: one reads that kernel's
    # bound, one the untraced window
    (here / "rooflines" / "k9.py").write_text(
        "def launch_ms(run):\n"
        "    return 1e-6 * run['ncol'] * run['traced']['steps']\n")
    (here / "metrics" / "k9_bound_ms.loop.py").write_text(
        "ROOFLINE = 'k9'\n\n\ndef read(rec):\n    return rec['bound_ms']\n")
    (here / "metrics" / "calls_per_window.loop.py").write_text(
        "def read(rec):\n    return len(rec['measured']['calls_s'])\n")
    m["configs"] = [dict(c, file="portbench/" + c["file"].split("/", 1)[1])
                    for c in m["configs"]]
    m["workloads"].append(dict(name="global-january-windows",
                               config="global-r05-262k",
                               traffic="january-windows", chips=1,
                               why="test"))
    for x in m["end_to_end"]:
        if "workloads" in x and "global-july-windows" in x["workloads"]:
            x["workloads"].append("global-january-windows")
    for name, unit in (("k9_bound_ms.loop", "ms"),
                       ("calls_per_window.loop", "calls")):
        m["per_layer"].append(dict(
            name=name, unit=unit, better="lower", source="program_counter",
            layer="time loop", moves="column_steps_per_s",
            workloads=["global-january-windows"]))
    cell = manifest.Cell(m, "global-january-windows", here=here)
    assert cell.traffic["start"] == "1985-01-01 00:00"
    assert [x["name"] for x in cell.per_layer] == ["k9_bound_ms.loop",
                                                   "calls_per_window.loop"]
    # the harness's run, on the CPU at 24 columns, traced: both read
    cell.traffic.update(call_steps=4, window=2)
    run = _util.run_module()
    res = run.run_cell(cell, 2**40 + 5, 0.0, True, torch.device("cpu"),
                       ncol=24, compare_columns=24)
    assert res["correct"], res["checks"]
    assert res["metrics"] == {
        "k9_bound_ms.loop": dict(value=pytest.approx(1e-6 * 24 * 4),
                                 unit="ms"),
        "calls_per_window.loop": dict(value=1, unit="calls")}
    with pytest.raises(KeyError):
        manifest.Cell(m, "no-such-cell", here=here)


# a new input kind: month files of 3-hourly forcing on (DTIME, cell), the
# humidity as RH; FAULT "kind" hands the program no files
KIND = '''"""Forcing in month files on (DTIME, cell), humidity as RH."""

import pathlib

import numpy as np

ROLE = "forcing"
FAULT = {fault!r}


def _write(path, month, ncol):
    from portbench.reference.elm.data.netcdf import write_nc
    nt = (31 if month == 1 else 28) * 8
    t = np.arange(nt) * 0.125
    day = (month - 1) * 31 + t[:, None]
    c = np.arange(ncol)[None, :] + 0.0 * day
    sun = np.maximum(0.0, np.sin(2.0 * np.pi * (day - 0.25)))
    f = dict(TBOT=268.0 + 4.0 * np.sin(2.0 * np.pi * day) + 0.1 * c,
             PBOT=99000.0 + 10.0 * c, FLDS=250.0 + c,
             RH=70.0 + 20.0 * np.cos(2.0 * np.pi * day / 3.0),
             FSDS=500.0 * sun, PRECTmms=np.where(c % 3 == 0, 1e-5, 0.0),
             WIND=3.0 + c / ncol)
    write_nc(path, {{"DTIME": None, "cell": ncol}}, dict(
        DTIME=(("DTIME",), t),
        **{{k: (("DTIME", "cell"), v.astype(np.float32))
           for k, v in f.items()}}))


def write(cfg, ncol, files):
    from portbench import inputs
    base = inputs.grid_dir(cfg, ncol) / "rh" / "rh_"
    for m in (1, 2):
        inputs.ensure(base.with_name(f"rh_1985-{{m:02d}}.nc"),
                      lambda p, m=m: _write(p, m, ncol))
    return dict(forcing=str(base))


def model_kw(cfg, files):
    return {{}} if FAULT == "kind" else dict(
        forcing_basename=files["forcing"])


def reference(cfg, files, cols, grid):
    import importlib.util
    path = pathlib.Path(__file__).parents[1] / "reference" / "rh_reader.py"
    spec = importlib.util.spec_from_file_location("rh_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Reader(files["forcing"], cols)


def horizon(cfg):
    return "1985-02-28 21:00"
'''

# its reference reader, a file of its own; FAULT "reader" reads every row
# one sample late
READER = '''"""The reference's reader of the (DTIME, cell) month files."""

import os

import numpy as np

from portbench.reference.elm.data.netcdf import mapped
from portbench.reference.elm.data.state import StepForcing
from portbench.reference.elm.utils.dates import Date

SHIFT = {shift}
NAMES = dict(tbot="TBOT", pbot="PBOT", qbot="RH", flds="FLDS",
             wind="WIND", fsds="FSDS", prec="PRECTmms")


class Reader:
    qbot_is_rh = True

    def __init__(self, base, cols):
        self.base, self.cols = base, np.asarray(cols)

    def _month(self, y, m):
        path = f"{{self.base}}{{y:04d}}-{{m:02d}}.nc"
        if not os.path.exists(path):
            return None
        return mapped(path, lambda f: dict(
            dtime=np.array(f.variables["DTIME"].data, np.float64),
            **{{k: np.roll(np.array(f.variables[v].data[:, self.cols],
                                   np.float64), SHIFT, axis=0)
               for k, v in NAMES.items()}}))

    def window(self, date, dtime):
        y, m, _ = date.date()
        rows = self._month(y, m)
        nxt = self._month(y, m + 1)
        if nxt is not None:
            rows = {{k: np.concatenate([v, nxt[k][:1]])
                    for k, v in rows.items()}}
        dt = (rows["dtime"][1] - rows["dtime"][0]) * 86400.0
        tmid = ((date.doy - Date.from_ymd(y, m, 1).doy) * 86400.0
                + date.sec + 0.5 * dtime)
        i = int(np.floor(tmid / dt))
        wt2 = float((tmid - i * dt) / dt)
        return StepForcing(
            wt1=1.0 - wt2, wt2=wt2, fsds=rows["fsds"][i],
            prec=rows["prec"][i], decday=date.decimal_doy() + 1.0,
            **{{k: rows[k][i:i + 2]
               for k in ("tbot", "pbot", "qbot", "flds", "wind")}})
'''

# a new drive: the windows loop with each window shipped as per-step
# bracketing pairs; FAULT "drive" runs the program a step ahead of its dates
DRIVE = '''"""The windows loop, each window as per-step bracketing pairs."""

from portbench.drives.windows import WindowsDrive

AHEAD = {ahead}


class PairWindows(WindowsDrive):
    def call(self):
        d = self.model.run_windows(
            self.date_at(self.steps_done + AHEAD), self.call_steps,
            window=self.window, series=False, callback=self._window_done)
        self.diags.append(d)
        return d


DRIVE = PairWindows
'''


@pytest.mark.parametrize("fault", [None, "kind", "drive", "reader"])
def test_a_new_input_kind_drive_and_reader_are_files(tmp_path, monkeypatch,
                                                    fault):
    # a rehearsal cell: the global grid forced from the new kind's files,
    # driven by the new drive, judged through the new reader, in a copy of
    # the data files with the harness's code untouched; sound, it is
    # correct, and a fault planted in any one of the three is not
    from portbench import inputs
    monkeypatch.setattr(inputs, "INPUT_DIR", tmp_path / "inputs")
    here = _data_copy(tmp_path)
    (here / "sources" / "rh_forcing.py").write_text(KIND.format(fault=fault))
    (here / "reference").mkdir()
    (here / "reference" / "rh_reader.py").write_text(
        READER.format(shift=int(fault == "reader")))
    (here / "drives" / "pair_windows.py").write_text(
        DRIVE.format(ahead=int(fault == "drive")))
    cfg = json.loads((here / "configs" / "global-r05-262k.json").read_text())
    cfg.update(name="global-rh", inputs=dict(cfg["inputs"], rh_forcing=True))
    (here / "configs" / "global-rh.json").write_text(json.dumps(cfg))
    (here / "traffic" / "rh-windows.json").write_text(json.dumps(dict(
        entry="pair_windows", start="1985-01-31 22:00", call_steps=4,
        window=2, state={"soil_t_offset_k": [-1.0, 1.0]},
        compare={"columns": 24})))
    (here / "limits" / "global-rh-windows.json").write_text(
        json.dumps({"limits": {"state_gap": 1e-9}}))
    m = manifest.load()
    m["configs"].append(dict(name="global-rh",
                             file="portbench/configs/global-rh.json"))
    m["configs"] = [dict(c, file="portbench/" + c["file"].split("/", 1)[1])
                    for c in m["configs"]]
    m["workloads"].append(dict(name="global-rh-windows", config="global-rh",
                               traffic="rh-windows", chips=1, why="test"))
    for x in m["end_to_end"]:
        if x["name"] == "column_steps_per_s":
            x["workloads"].append("global-rh-windows")
    cell = manifest.Cell(m, "global-rh-windows", here=here)
    assert list(cell.kinds) == ["phenology", "aerosol", "rh_forcing"]
    assert cell.drive_class.__name__ == "PairWindows"
    run = _util.run_module()
    res = run.run_cell(cell, 2**40 + 7, 0.0, False, torch.device("cpu"),
                       ncol=24)
    assert res["correct"] == (fault is None), res["checks"]
    if fault is None:
        # the window crossed into February, forced from its file
        assert res["attempted"] == 4
        assert sorted(p.name for p in (tmp_path / "inputs" / "global_24"
                                       / "rh").iterdir()) == [
            "rh_1985-01.nc", "rh_1985-02.nc"]


def _checkout(tmp_path, drop=(), inputs=None):
    """A checkout of the benchmark in ``tmp_path`` (its program linked):
    without the files ``drop``, and with ``inputs`` added to the new
    cell's configuration."""
    shutil.copytree(_util.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "elmkernels_torch").symlink_to(_util.ROOT
                                               / "elmkernels_torch")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(_util.manifest()))
    for f in drop:
        (tmp_path / "portbench" / f).unlink()
    if inputs:
        path = tmp_path / "portbench" / "configs" / \
            "global-r05-262k-gswp3.json"
        cfg = json.loads(path.read_text())
        cfg["inputs"].update(inputs)
        path.write_text(json.dumps(cfg))
    return tmp_path


@pytest.mark.parametrize("case", ["no_forcing_kind", "unknown_kind",
                                  "no_drive"])
def test_what_the_harness_has_no_file_for_exits_2(tmp_path, case):
    # the harness does not know the kind or the drive: the run ends at
    # once, with no result, and never runs without that input
    import subprocess
    import sys
    root = _checkout(tmp_path, **{
        "no_forcing_kind": dict(drop=["sources/forcing.py"]),
        "unknown_kind": dict(inputs={"landunits": True}),
        "no_drive": dict(drop=["drives/windows.py"])}[case])
    proc = subprocess.run(
        [sys.executable, str(root / "portbench" / "run.py"), "--workload",
         "global-files-windows", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""
    assert "no " in proc.stderr
