"""The manifest and the files it names: each configuration, mix, cell's
limits and per-layer metric found by name, and a new cell or metric is a
new file and a manifest entry."""

import json
import re
import shutil

import pytest
import torch

from portbench.tests import _util

from portbench import manifest  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_loads():
    m = manifest.load()
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
    m = manifest.load()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get(
            "workloads", [w["name"] for w in m["workloads"]]))


def test_a_new_cell_metric_and_roofline_are_files_and_entries(tmp_path):
    # a copy of the benchmark's data files; the harness's code untouched
    here = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics", "rooflines"):
        shutil.copytree(_util.ROOT / "portbench" / sub, here / sub)
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
