"""The five per-layer metrics that read the program's own spans
(``elm.<layer>.<what>``, ``elmkernels_torch/utils/clock.py``): each reader
on a canned record, and the harness's traced run on the CPU with a program
that opens its spans and with one that opens none, as a program before
them does."""

import pytest
import torch

from portbench.tests import _util

from portbench import manifest, spans, trace  # noqa: E402

READS = {
    "coupled_inputs_ms_per_step.coupled": ("elm.coupled.inputs",
                                           "elm.coupled.copy_in"),
    "coupled_issue_ms_per_step.coupled": ("elm.coupled.step",),
    "coupled_exchange_ms_per_step.coupled": ("elm.coupled.exchange",),
    "window_wait_ms_per_step.loop": ("elm.window.wait",),
    "step_issue_ms_per_step.loop": ("elm.window.step",),
}
CELLS = {"coupled": ["utqiagvik-coupled"],
         "loop": ["global-july-windows", "utqiagvik-spring-windows"]}


def _record():
    # a window of 10 ms over two steps; each span twice (1 and 2 ms, in
    # microseconds) inside it, once more outside it; the harness's and
    # the runtime's events around them
    host = [[trace.RANGE, 0.0, 10_000.0], ["cudaLaunchKernel", 50.0, 60.0],
            ["portbench.advance_with_forcing", 10.0, 9_000.0]]
    for k, name in enumerate(sorted({n for v in READS.values() for n in v})):
        a = 100.0 + 1_000.0 * k
        host += [[name, a, a + 1_000.0], [name, a + 300.0, a + 2_300.0],
                 [name, 20_000.0, 25_000.0]]
    return dict(window=[0.0, 10_000.0], steps=2, host=host, device=[],
                measured=dict(steps=4, cpu_s=0.014))


def _reader(name):
    return manifest.Cell(manifest.load(),
                         CELLS[name.rsplit(".", 1)[1]][0]).reader(name)


@pytest.mark.parametrize("name", sorted(READS))
def test_a_reader_sums_its_spans_in_the_window_over_the_steps(name):
    read = _reader(name)
    # 3 ms of each span name in the window over 2 steps
    assert read(_record()) == pytest.approx(1.5 * len(READS[name]))
    # none of its spans: nothing to read, and no error
    rec = _record()
    rec["host"] = [h for h in rec["host"] if h[0] not in READS[name]]
    assert read(rec) is None
    assert read(dict(rec, window=None)) is None
    assert spans.ms_per_step(_record(), ("elm.no.such",)) is None


def test_each_applies_to_every_cell_of_its_end_to_end_metric():
    """The metrics list no cells: each is reported in every cell that
    reports the end-to-end metric it moves, and a run of a program without
    the spans leaves it out instead of ending."""
    m = manifest.load()
    entries = {x["name"]: x for x in m["per_layer"] if x["name"] in READS}
    assert sorted(entries) == sorted(READS)
    for name, entry in entries.items():
        assert "workloads" not in entry and entry["unit"] == "ms"
        got = [w["name"] for w in m["workloads"]
               if name in [x["name"] for x in
                           manifest.Cell(m, w["name"]).per_layer]]
        assert got == CELLS[name.rsplit(".", 1)[1]]


@pytest.mark.parametrize("spans_open", [True, False],
                         ids=["program", "without_spans"])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_the_traced_run_reads_them_or_leaves_them_out(kind, spans_open,
                                                      monkeypatch):
    """The harness's traced run on the CPU at 24 columns, its per-layer
    metrics cut to these five (the accepted ones read the device, which
    the CPU has not): the program's spans read; a program that opens none
    leaves them out, and the run still ends with its result."""
    if not spans_open:
        from elmkernels_torch.utils import clock
        monkeypatch.setattr(clock, "_profiler_enabled", lambda: False)
    run = _util.run_module()
    cell = _util.small_cell(CELLS[kind][0], call_steps=2, window=1)
    cell.per_layer = [x for x in cell.per_layer if x["name"] in READS]
    mine = sorted(k for k in READS if k.endswith("." + kind))
    assert sorted(x["name"] for x in cell.per_layer) == mine
    res = run.run_cell(cell, 2**40 + 17, 0.0, True, torch.device("cpu"),
                       ncol=24, compare_columns=24)
    assert res["correct"], res["checks"]
    if spans_open:
        assert sorted(res["metrics"]) == mine
        assert all(v["unit"] == "ms" and v["value"] > 0
                   for v in res["metrics"].values()), res["metrics"]
    else:
        assert res["metrics"] == {}
