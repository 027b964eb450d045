"""The compiled step (``elmkernels_torch/driver/graphs.py``) on the CPU.

There is no card here, so the tests hand ``graphs.GRAPH`` a stand-in for
the CUDA graph: its capture runs the captured body once and puts back
what the body wrote (a stream capture runs nothing), its replay runs the
body again and copies the outputs into the captured ones (a graph's
outputs keep their addresses).  The strict stand-in also refuses, during
the capture, the operations a stream capture refuses: a read of a
tensor's value on the host and a tensor made from host data.  The
kernels' plain versions, which the card does not run, are exempt.

On the global grid of ``test_torch_scan.py`` (port-written surfdata,
NetCDF forcing, phenology and aerosol files; 64 columns mixing C3 and C4
PFTs), 8 steps from 1985-07-16 10:00 cross the mid-month phenology
rollover:

- ``run``, ``run_scan``, ``run_scan_series`` and ``run_windows`` (both
  layouts), replayed, with and without ``packed_carry``, give the eager
  ``run``'s state and per-step reductions bit for bit (atol 0);
- the replayed series loop against the JAX package's ``run_scan_series``
  under the exact flags: rtol 1e-10 and equal iteration counts;
- the key re-captures when a flag, the photosynthesis mode, the state
  template, an input dtype or a parameter tensor changes, and only then;
- a replay adds the launches the capture recorded;
- a state set from outside is copied into the carry;
- a capture that meets a host wait raises, naming the operation, and the
  step does not go on eagerly.

    python -m pytest tests/test_torch_graphs.py -q
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_step as ts
import torch_parity as tp
from elmkernels_torch.data import synthetic
from elmkernels_torch.driver import graphs
from elmkernels_torch.driver import step as step_mod
from elmkernels_torch.driver.model import Model as TModel
from elmkernels_torch.driver.model import reduce_diags
from elmkernels_torch.ops import canopy, pdma
from elmkernels_torch.physics import canopy_fluxes, phenology
from elmkernels_torch.physics import soil_temperature
from elmkernels_torch.utils.dates import Date as TDate
from elmkernels_torch.utils.packing import PackedCarry
from elmkernels_tpu.utils.dates import Date as JDate

torch.set_num_threads(1)

NLAT, NLON = 8, 16
NCELL = NLAT * NLON
NCOL, COL0 = 64, 32
NSTEPS = 8
START = (1985, 7, 16, 20)   # year, month, day, steps of 1800 s


def _date(cls=TDate):
    y, m, d, k = START
    date = cls.from_ymd(y, m, d)
    date.increment_seconds(1800 * k)
    return date


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return []


class RerunGraph:
    """A stand-in for ``graphs.CudaGraph`` that runs the captured body."""

    captures = 0

    def __init__(self, device):
        self.body = self.out = None

    def capture(self, body, writes=()):
        type(self).captures += 1
        saved = [w.clone() for w in writes]
        self.body = body
        self.out = body()
        for w, s in zip(writes, saved):
            w.copy_(s)
        return self.out

    def replay(self):
        for o, n in zip(_leaves(self.out), _leaves(self.body())):
            o.copy_(n)


# what a stream capture refuses, seen on the CPU: a value read on the host
# (.item(), bool(), a data-dependent shape) and a tensor made from host
# data (torch.tensor/as_tensor of a Python value: a host-to-device copy)
HOST_OPS = ("aten._local_scalar_dense", "aten.lift_fresh", "aten.nonzero",
            "aten.masked_select", "aten.unique")


class _NoHostWait(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and str(func.overloadpacket) in HOST_OPS:
            raise RuntimeError(f"operation not permitted when stream is "
                               f"capturing ({func})")
        return func(*args, **(kwargs or {}))


class _ScalarFills(TorchFunctionMode):
    """``t[...] = number`` wraps the number as a host tensor
    (``lift_fresh``) that a card's ``fill_`` reads on the host: no copy,
    no wait.  ``strict`` is paused for it."""

    def __init__(self, strict):
        super().__init__()
        self.strict = strict

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (getattr(func, "__name__", "") == "__setitem__"
                and not isinstance(args[2], torch.Tensor)):
            self.strict.paused += 1
            try:
                return func(*args, **(kwargs or {}))
            finally:
                self.strict.paused -= 1
        return func(*args, **(kwargs or {}))


# the kernels' plain versions: the card launches the kernels instead
PLAIN = ((canopy_fluxes, "stability_iteration_plain"),
         (soil_temperature, "pdma_solve_plain"))


class StrictGraph(RerunGraph):
    """:class:`RerunGraph` whose capture refuses host waits outside the
    kernels' plain versions."""

    def capture(self, body, writes=()):
        mode = _NoHostWait()

        def strict():
            with _ScalarFills(mode), mode:
                return body()
        originals = [(m, a, getattr(m, a)) for m, a in PLAIN]

        def exempt(fn):
            def run(*args, **kwargs):
                mode.paused += 1
                try:
                    return fn(*args, **kwargs)
                finally:
                    mode.paused -= 1
            return run
        try:
            for m, a, fn in originals:
                setattr(m, a, exempt(fn))
            out = super().capture(strict, writes)
        finally:
            for m, a, fn in originals:
                setattr(m, a, fn)
        self.body = body      # a replay runs what was captured
        return out


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "GRAPH", StrictGraph)
    StrictGraph.captures = 0
    return StrictGraph


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_graphs")
    pft, snicar = tp.write_files(d)
    synthetic.write_global_surfdata(d / "surfdata.nc", NCELL)
    synthetic.write_phenology(d / "phen.nc", NCELL)
    synthetic.write_aerosol_deposition(d / "aero.nc", NCELL)
    synthetic.write_forcing_months(str(d / "forc_"), 1985, 7, 2, NLAT, NLON)
    return dict(surfdata=str(d / "surfdata.nc"), pft_path=pft,
                snicar_path=snicar, forcing_basename=str(d / "forc_"),
                phenology_path=str(d / "phen.nc"),
                aerosol_path=str(d / "aero.nc"))


def _kw(grid):
    return {k: v for k, v in grid.items() if k != "surfdata"}


def torch_model(grid, **flags):
    return TModel.from_surfdata(grid["surfdata"], NCOL, col0=COL0,
                                device="cpu", **_kw(grid), **flags)


def _run_reduced(m, start, nsteps):
    per_step = []
    m.run(start, nsteps,
          lambda date, state, d: per_step.append(reduce_diags(d)))
    return type(per_step[0])(*(torch.cat(v) for v in zip(*per_step)))


@pytest.fixture(scope="module")
def eager_run(grid):
    """The eager ``run``: its final state and each step's reductions."""
    m = torch_model(grid)
    assert m.psn_mode == "mixed" and m.aerosol is not None
    with graphs.disable_graphs():
        diags = _run_reduced(m, _date(), NSTEPS)
    assert m._graphs is None
    return m.state, diags


LOOPS = {
    "run": lambda m, s: _run_reduced(m, s, NSTEPS),
    "run_scan": lambda m, s: m.run_scan(s, NSTEPS),
    "run_scan_series": lambda m, s: m.run_scan_series(s, NSTEPS),
    "run_windows": lambda m, s: m.run_windows(s, NSTEPS, window=4),
    "run_windows_series": lambda m, s: m.run_windows(s, NSTEPS, window=4,
                                                     series=True),
}


def _assert_state_equal(a, b):
    for k, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_replayed_loop_is_the_eager_run(grid, eager_run, stand_in, loop,
                                        packed):
    state, diags = eager_run
    m = torch_model(grid, packed_carry=packed)
    got = LOOPS[loop](m, _date())
    _assert_state_equal(state, m.state)
    for k in diags._fields:
        x, y = getattr(diags, k), getattr(got, k)
        assert x.dtype == y.dtype and torch.equal(x, y), k
    # one warm-up step, one capture, every later step a replay; the state
    # is views into the carry
    g = m._graphs
    assert stand_in.captures == 1 and len(g.captures) == 1
    assert g.replays == NSTEPS - 1
    bufs = {b.untyped_storage().data_ptr() for b in m._carry.buffers}
    assert all(t.untyped_storage().data_ptr() in bufs for t in m.state)


def test_advance_diagnostics_outlive_the_next_replay(grid, stand_in):
    a, b = torch_model(grid), torch_model(grid)
    date = _date()
    kept_a, kept_b = [], []
    for _ in range(4):
        with graphs.disable_graphs():
            kept_a.append(a.advance(date))
        kept_b.append(b.advance(date))
        date.increment_seconds(1800)
    assert b._graphs.replays == 3
    for da, db in zip(kept_a, kept_b):
        _assert_state_equal(da, db)


def test_replayed_series_matches_jax_exact_flags(grid, stand_in):
    """The replayed ``run_scan_series`` against the JAX package's, under
    the reference-exact flags: rtol 1e-10 and equal iteration counts."""
    import jax
    from elmkernels_tpu.driver.model import Model as JModel
    with jax.default_device(jax.devices("cpu")[0]):
        jm = JModel.from_surfdata(grid["surfdata"], NCOL, col0=COL0,
                                  **_kw(grid), **ts.EXACT)
        jd = jm.run_scan_series(_date(JDate), NSTEPS)
    tm = torch_model(grid, **ts.EXACT)
    td = tm.run_scan_series(_date(), NSTEPS)
    assert tm._graphs.replays == NSTEPS - 1
    tp.assert_close(tp.nt_numpy(jm.state),
                    {k: v.numpy() for k, v in tm.state._asdict().items()},
                    rtol=1e-10)
    for k in ("niters_canopy_max", "niters_canopy_mean", "niters_ci_mean"):
        np.testing.assert_array_equal(np.asarray(getattr(jd, k)),
                                      getattr(td, k).numpy(), k)
    assert int(td.niters_canopy_max.max()) > 0
    for k in jd._fields:
        if not k.startswith("niters"):
            tp.assert_close(np.asarray(getattr(jd, k)),
                            getattr(td, k).numpy(), rtol=1e-10, path=k)


def _replace_params(m):
    m.params = m.params._replace(watsat=m.params.watsat.clone())


# what changes between two 2-step loops, and whether it re-captures
CHANGES = {
    "nothing": (lambda m: None, False),
    "a flag": (lambda m: setattr(m, "warm_start", False), True),
    "psn_mode": (lambda m: setattr(m, "psn_mode", "c3"), True),
    "a params tensor": (_replace_params, True),
    "the state template": (lambda m: setattr(m, "state", m.state._replace(
        t10=m.state.t10.to(torch.float32))), True),
    "an input dtype": (lambda m: setattr(m, "dtype", torch.float32), True),
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_capture_key(grid, stand_in, change):
    fn, recaptures = CHANGES[change]
    m = torch_model(grid)
    date = _date()
    m.run_scan(date, 3)
    graph = m._graphs.graph
    assert len(m._graphs.captures) == 1
    fn(m)
    if change == "the state template":
        # the key alone: the step refuses a float32 t10 in a float64 model
        carry = PackedCarry(m.state)
        forc, phen = m.step_inputs(date)
        assert m._graph_key(carry, (forc, phen)) != m._graphs.key
        return
    if change == "an input dtype":
        forc, phen = m._host_inputs(date)
        assert forc.tbot.dtype == torch.float32
        assert m._graph_key(m._carry, (forc, phen)) != m._graphs.key
        return
    m.run_scan(date, 2)
    # a new key warms up eagerly, then captures; the same key replays
    assert (len(m._graphs.captures) == 2) is recaptures
    assert (m._graphs.graph is graph) is not recaptures
    if change == "a params tensor":
        # the new graph reads the new tensor
        assert m._graphs.key[1][0] == graphs.key_of(
            (), (m.params,), m._carry, (), "cpu")[1][0]


def test_replay_adds_the_captured_launches(grid, stand_in, monkeypatch):
    """The kernels count their launches in Python, at capture and not at
    replay: a replay adds what the capture recorded (here a stand-in step
    that "launches" K2 once and K4 twice)."""
    advance = step_mod.advance

    def counted(*args, **kwargs):
        canopy.canopy_stability.launches += 1
        pdma.pdma_solve.launches += 2
        return advance(*args, **kwargs)
    monkeypatch.setattr(step_mod, "advance", counted)
    monkeypatch.setattr(canopy.canopy_stability, "launches", 0)
    monkeypatch.setattr(pdma.pdma_solve, "launches", 0)
    m = torch_model(grid)
    m.run_scan_series(_date(), 5)
    assert canopy.canopy_stability.launches == 5
    assert pdma.pdma_solve.launches == 10
    assert m._graphs.deltas[:2] == [1, 2]
    # the carry's own counts too: one update a step
    assert m._carry.updates == 5


def test_state_set_from_outside_is_copied_into_the_carry(grid, stand_in):
    a, b = torch_model(grid), torch_model(grid)
    date = _date()
    with graphs.disable_graphs():
        a.run_scan(date, 3)
    b.run_scan(date, 3)
    ptrs = [t.data_ptr() for t in b._carry.buffers]
    # a rollback: the state of another model, set from outside
    b.state = type(a.state)(*(t.clone() for t in a.state))._replace(
        t_grnd=a.state.t_grnd + 1.0)
    a.state = a.state._replace(t_grnd=a.state.t_grnd + 1.0)
    later = _date()
    later.increment_seconds(3 * 1800)
    with graphs.disable_graphs():
        a.run_scan_series(later, 3)
    b.run_scan_series(later, 3)
    assert [t.data_ptr() for t in b._carry.buffers] == ptrs
    assert len(b._graphs.captures) == 1
    _assert_state_equal(a.state, b.state)


def test_a_failed_capture_raises_and_does_not_run_eagerly(grid, stand_in,
                                                         monkeypatch):
    """A step with a host wait: the warm-up step runs it, the capture
    refuses it, and the loop raises, naming the operation and the line of
    the step that reached it."""
    compute = phenology.compute_phenology

    def waits(*args, **kwargs):
        out = compute(*args, **kwargs)
        if bool((out.elai > 100.0).any()):
            raise AssertionError("not reached")
        return out
    monkeypatch.setattr(step_mod.ph, "compute_phenology", waits)
    monkeypatch.setattr(canopy.canopy_stability, "launches", 0)
    m = torch_model(grid)
    with pytest.raises(graphs.CaptureError,
                       match=r"Tensor\w*\.__bool__ in elmkernels_torch/driver/"
                             r"step.py:\d+ \(surface_phase\)") as err:
        m.run_scan(_date(), 3)
    assert "disable_graphs" in str(err.value)
    assert m._graphs.graph is None and m._graphs.replays == 0
    assert canopy.canopy_stability.launches == 0
    # the eager path takes the same step when asked for
    with graphs.disable_graphs():
        m.run_scan(_date(), 3)


def test_the_snow_block_captures_routed_to_k5(grid, stand_in, monkeypatch):
    """The step's snow-hydrology block routed as on a card
    (``snow_hydrology_block`` to ``ops.snow.snow_hydrology``; here a
    stand-in that counts a launch and runs the plain block, not exempted
    from the strict capture): the capture passes, each replay adds K5's
    launch, once a step, and the state equals the eager loop's on the
    plain block bit for bit."""
    from elmkernels_torch.ops import snow
    from elmkernels_torch.physics import snow_hydrology

    def k5(**args):
        k5.launches += 1
        return snow_hydrology.snow_hydrology_block_plain(**args)
    k5.launches = 0
    eager = torch_model(grid)
    with graphs.disable_graphs():
        eager.run_scan(_date(), 4)
    monkeypatch.setattr(snow_hydrology, "_on_card", lambda t: True)
    monkeypatch.setattr(snow, "snow_hydrology", k5)
    m = torch_model(grid)
    m.run_scan(_date(), 4)
    assert len(m._graphs.captures) == 1 and m._graphs.replays == 3
    assert k5.launches == 4
    _assert_state_equal(eager.state, m.state)



def test_the_soil_temperature_module_captures_routed_to_k7(grid, stand_in,
                                                            monkeypatch):
    """The step's soil temperature module routed as on a card
    (``soil_temperature_block`` to ``ops.soil_temperature.
    soil_temperature``; here a stand-in that counts a launch and runs the
    plain chain, not exempted from the strict capture): the capture
    passes, each replay adds K7's launch, once a step, and the state equals
    the eager loop's on the plain chain bit for bit."""
    from elmkernels_torch.ops import soil_temperature as k7

    def stand_in_k7(**args):
        stand_in_k7.launches += 1
        return soil_temperature.soil_temperature_block_plain(**args)
    stand_in_k7.launches = 0
    eager = torch_model(grid)
    with graphs.disable_graphs():
        eager.run_scan(_date(), 4)
    monkeypatch.setattr(soil_temperature, "_on_card", lambda t: True)
    monkeypatch.setattr(k7, "soil_temperature", stand_in_k7)
    m = torch_model(grid)
    m.run_scan(_date(), 4)
    assert len(m._graphs.captures) == 1 and m._graphs.replays == 3
    assert stand_in_k7.launches == 4
    _assert_state_equal(eager.state, m.state)

def test_snicar_captures_routed_to_k3(grid, stand_in, monkeypatch):
    """The step's SNICAR sweep routed as on a card (``snicar_ad_rt_both``
    to ``ops.snicar.snicar``; here a stand-in that counts a launch and runs
    the plain sweep, not exempted from the strict capture): the capture
    passes, each replay adds K3's launch, once a step, the stand-in is
    handed the step's working-type inputs with the production flags'
    float32 sweep, and the state equals the eager loop's on the plain sweep
    bit for bit."""
    from elmkernels_torch.ops import snicar
    from elmkernels_torch.physics import snow_snicar

    def k3(**args):
        k3.launches += 1
        k3.types.add((args["coszen"].dtype, args["sweep_dtype"],
                      args["weight_dtype"]))
        return snow_snicar.snicar_ad_rt_both_plain(None, **args)
    k3.launches, k3.types = 0, set()
    eager = torch_model(grid)
    with graphs.disable_graphs():
        eager.run_scan(_date(), 4)
    monkeypatch.setattr(snow_snicar, "_on_card", lambda t: True)
    monkeypatch.setattr(snicar, "snicar", k3)
    m = torch_model(grid)
    m.run_scan(_date(), 4)
    assert len(m._graphs.captures) == 1 and m._graphs.replays == 3
    assert k3.launches == 4
    assert k3.types == {(torch.float64, torch.float32, torch.float64)}
    _assert_state_equal(eager.state, m.state)


@pytest.mark.parametrize("flags", ["production", "exact"])
def test_the_step_captures_with_no_host_wait(grid, stand_in, flags):
    """The strict stand-in's capture of the step under each set of flags:
    no host read or host-made tensor outside the kernels' plain versions
    (what would stop a capture on the card)."""
    m = torch_model(grid, **(ts.PRODUCTION if flags == "production"
                             else ts.EXACT))
    m.run_scan(_date(), 2)
    assert len(m._graphs.captures) == 1


def test_disable_graphs_runs_the_eager_loop(grid, stand_in):
    m = torch_model(grid)
    with graphs.disable_graphs():
        assert not graphs.uses_graphs("cuda")
        with graphs.disable_graphs():
            assert not graphs.uses_graphs("cpu")
        assert not graphs.uses_graphs("cpu")
        m.run_scan(_date(), 2)
    assert m._graphs is None and m._carry is None
    assert graphs.uses_graphs("cpu") and graphs.uses_graphs("cuda")
