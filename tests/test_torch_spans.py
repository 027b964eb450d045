"""The port's spans on the profiler's clock (``elmkernels_torch/utils/
clock.py``: ``span``), on the CPU at a few columns:

- ``run_windows`` over two windows records ``elm.window.wait`` and
  ``elm.window.copy`` once a window and ``elm.window.step`` once a step,
  eager and through a stand-in for the CUDA graph, in both layouts;
- ``advance_with_forcing`` records each ``elm.coupled.*`` span once a
  step, in order, none inside another ``elm.`` span;
- in an exported chrome trace every ``elm.`` event is a ``cpu_op``, never
  a ``user_annotation`` (which a CUDA trace draws over the device's
  kernels);
- a run with no profiler leaves the same state, bit for bit, as one under
  the profiler;
- ``Clock.time`` opens ``elm.run.<section>``; with no profiler a span is
  the shared null context;
- no ``elm.`` span opens inside the captured step.

The ``cuda`` case runs on a card: the benchmark's traced record of one
``run_windows`` call has the spans on the host and none on the device.
The module imports neither JAX nor the JAX package, so that the ``cuda``
case runs on a machine that has only PyTorch; there, from the root of a
checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_spans.py
"""

import collections
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from elmkernels_torch.data import synthetic
from elmkernels_torch.driver import graphs
from elmkernels_torch.driver.interface import (HostForcing, HostPhenology,
                                               MinimalInterface)
from elmkernels_torch.driver.model import Model
from elmkernels_torch.utils import clock
from elmkernels_torch.utils.dates import Date

torch.set_num_threads(1)

NCOL = 4
WINDOW = 2
COUPLED = ("elm.coupled.inputs", "elm.coupled.copy_in", "elm.coupled.step",
           "elm.coupled.exchange")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return synthetic.parameter_files(tmp_path_factory.mktemp("torch_spans"))


def _model(files, device="cpu"):
    return Model(ncol=NCOL, pft_path=files[0], snicar_path=files[1],
                 device=device)


def _start():
    return Date.from_ymd(1985, 7, 1, 10 * 3600)


def _traced(fn):
    """``fn()`` under the profiler: (its result, the events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _spans(prof, prefix="elm."):
    """[(name, start, end, thread)] of the events whose names start
    ``prefix``, in nanoseconds (read from the profiler's own results:
    building its ``events()`` takes longer than the run)."""
    return [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(prefix)]


def _counts(prof) -> dict:
    return dict(collections.Counter(s[0] for s in _spans(prof)))


class RerunGraph:
    """A stand-in for ``graphs.CudaGraph``: its capture runs the body once
    and puts back what the body wrote, its replay runs the body again
    into the captured outputs; each inside a range of the test's own."""

    def __init__(self, device):
        self.body = self.out = None

    def capture(self, body, writes=()):
        saved = [w.clone() for w in writes]
        self.body = body
        with record_function("test.captured_body"):
            self.out = body()
        for w, s in zip(writes, saved):
            w.copy_(s)
        return self.out

    def replay(self):
        with record_function("test.captured_body"):
            new = self.body()
        for o, n in zip(_leaves(self.out), _leaves(new)):
            o.copy_(n)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return []


@pytest.fixture
def replayed(request, monkeypatch):
    if request.param:
        monkeypatch.setattr(graphs, "GRAPH", RerunGraph)
    return request.param


def _windows(m, nsteps=2 * WINDOW, series=True):
    return m.run_windows(_start(), nsteps, window=WINDOW, series=series)


@pytest.mark.parametrize("replayed", [False, True], indirect=True,
                         ids=["eager", "replayed"])
@pytest.mark.parametrize("series", [True, False], ids=["series", "stacked"])
def test_window_spans_once_a_window_and_a_step(files, replayed, series):
    m = _model(files)
    _, prof = _traced(lambda: _windows(m, series=series))
    assert graphs.uses_graphs(m.device) == replayed
    assert _counts(prof) == {"elm.window.wait": 2, "elm.window.copy": 2,
                             "elm.window.step": 2 * WINDOW}
    # every span is on the calling thread
    assert len({s[3] for s in _spans(prof)}) == 1


def _host_inputs(iface, date):
    """The interface's own providers interpolated on the host: what an
    ATS-style caller hands in."""
    m = iface.model
    w = m.forcing.window(date, m.dtime)
    p = m.phenology.window(date)

    def at(pair, wt1, wt2):
        return wt1 * np.asarray(pair[0]) + wt2 * np.asarray(pair[1])
    atm = HostForcing(
        atm_tbot=at(w.tbot, w.wt1, w.wt2), atm_pbot=at(w.pbot, w.wt1, w.wt2),
        atm_qbot=at(w.qbot, w.wt1, w.wt2), atm_flds=at(w.flds, w.wt1, w.wt2),
        atm_fsds=np.asarray(w.fsds), atm_prec=np.asarray(w.prec),
        atm_wind=at(w.wind, w.wt1, w.wt2))
    phen = HostPhenology(
        lai=at(p.mlai, p.wt1, p.wt2), sai=at(p.msai, p.wt1, p.wt2),
        htop=at(p.mhtop, p.wt1, p.wt2), hbot=at(p.mhbot, p.wt1, p.wt2))
    return atm, phen


def _iface(files):
    return MinimalInterface(ncol=NCOL, model_kw=dict(
        pft_path=files[0], snicar_path=files[1], device="cpu")).setup()


def _coupled(iface, nsteps=2):
    date = _start()
    out = []
    for _ in range(nsteps):
        out.append(iface.advance_with_forcing(
            date, iface.model.dtime, *_host_inputs(iface, date)))
        date.increment_seconds(int(iface.model.dtime))
    return out


def test_coupled_spans_once_a_step_in_order_and_not_nested(files):
    iface = _iface(files)
    _, prof = _traced(lambda: _coupled(iface, 2))
    assert _counts(prof) == {n: 2 for n in COUPLED}
    spans = sorted(_spans(prof), key=lambda s: s[1])
    assert [s[0] for s in spans] == list(COUPLED) * 2
    for i, (name, a, b, _) in enumerate(spans):
        assert a <= b
        assert not any(s[1] <= a and b <= s[2] for j, s in enumerate(spans)
                       if j != i), name
    # the step holds the step's operations, the inputs none
    ops = [s[1] for s in _spans(prof, "aten::")]
    for name, least, most in (("elm.coupled.step", 100, None),
                              ("elm.coupled.inputs", 0, 0)):
        inside = [sum(1 for t in ops if a <= t <= b)
                  for n, a, b, _ in spans if n == name]
        assert all(k >= least and (most is None or k <= most)
                   for k in inside), (name, inside)


@pytest.mark.parametrize("loop", ["windows", "coupled"])
def test_spans_are_cpu_ops_in_the_chrome_trace(files, tmp_path, loop):
    run = ((lambda: _windows(_model(files))) if loop == "windows"
           else (lambda: _coupled(_iface(files), 1)))
    _, prof = _traced(run)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    mine = [e for e in events if str(e.get("name", "")).startswith("elm.")]
    assert mine and {e.get("cat") for e in mine} == {"cpu_op"}


def _state(m):
    return [t.clone() for t in m.state]


@pytest.mark.parametrize("loop", ["windows", "coupled"])
def test_no_profiler_same_state(files, loop):
    """The spans change nothing the step computes."""
    def run():
        if loop == "windows":
            m = _model(files)
            d = _windows(m)
            return _state(m), list(d)
        iface = _iface(files)
        fluxes = _coupled(iface, 2)
        return (_state(iface.model),
                [torch.from_numpy(v) for f in fluxes for v in f])
    plain = run()
    traced, prof = _traced(run)
    assert _spans(prof)
    for a, b in zip(plain, traced):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_clock_time_opens_its_span():
    c = clock.Clock()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with c.time("advance"):
            torch.ones(3).sum()
    assert _counts(prof) == {"elm.run.advance": 1}
    with c.time("advance"):
        pass
    assert c.counts["advance"] == 2 and c.totals["advance"] > 0
    # with no profiler recording, a span is the one null context
    assert clock.span("elm.a") is clock.span("elm.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert clock.span("elm.a") is not clock.span("elm.b")


def test_no_span_inside_the_captured_step(files, monkeypatch):
    monkeypatch.setattr(graphs, "GRAPH", RerunGraph)
    m = _model(files)
    # the first step runs eagerly, the second is captured and replayed,
    # each later one replayed
    _, prof = _traced(lambda: _windows(m, nsteps=3 * WINDOW))
    bodies = _spans(prof, "test.captured_body")
    assert len(bodies) == 3 * WINDOW
    assert m._graphs.replays == 3 * WINDOW - 1
    spans = _spans(prof)
    assert sum(s[0] == "elm.window.step" for s in spans) == 3 * WINDOW
    for name, a, b, _ in spans:
        assert not any(lo <= a and b <= hi for _, lo, hi, _ in bodies), name


@pytest.mark.cuda
def test_traced_record_has_no_span_on_the_device(files):
    """On a card: the benchmark's record (``portbench/trace.py``) of one
    ``run_windows`` call holds the spans among the host's events and no
    ``elm.`` name among the device's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels run only "
                    "there)")
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import trace
    m = _model(files, device=torch.device("cuda"))
    _windows(m)                    # the eager step and the capture
    torch.cuda.synchronize()

    def call():
        _windows(m)
        torch.cuda.synchronize()
        return dict(steps=2 * WINDOW)
    rec = trace.record(call)
    assert rec["device"] and not [n for n, _, _ in rec["device"]
                                  if n.startswith("elm.")]
    host = collections.Counter(n for n, _, _ in rec["host"]
                               if n.startswith("elm."))
    assert host == {"elm.window.wait": 2, "elm.window.copy": 2,
                    "elm.window.step": 2 * WINDOW}
