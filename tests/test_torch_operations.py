"""The port's operations layer against the JAX package's, on the CPU:
``RunConfig``, ``StepGuard`` with its rollback, ``MetricsLogger``,
``HistoryWriter``, checkpoint/restart, ``Clock`` and the
``python -m elmkernels_torch.run_model`` driver.

The JAX objects are fed the same states and diagnostics as the port's
(numpy copies of the port's), so no JAX step is compiled here: what is
compared is the layer's own logic, its reason strings, records and files.
"""

import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import torch_parity as tp
from elmkernels_torch import config as tconfig
from elmkernels_torch.utils import checkpoint as tckpt
from elmkernels_torch.utils import guard as tguard
from elmkernels_torch.utils.clock import Clock
from elmkernels_torch.utils.dates import Date as TDate
from elmkernels_torch.utils.history import HistoryWriter as THistory
from elmkernels_torch.utils.metrics import MetricsLogger as TMetrics
from elmkernels_tpu.data.state import ModelState as JState
from elmkernels_tpu.utils import checkpoint as jckpt
from elmkernels_tpu.utils import guard as jguard
from elmkernels_tpu.utils.dates import Date as JDate
from elmkernels_tpu.utils.history import HistoryWriter as JHistory
from elmkernels_tpu.utils.metrics import MetricsLogger as JMetrics

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
NCOL = 3
START = (1985, 7, 1, 12 * 3600)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tp.write_files(tmp_path_factory.mktemp("torch_ops"))


@pytest.fixture(scope="module")
def stepped(files):
    """A port model after two steps: (model, date of the last step, its
    StepDiagnostics, a window's ScanDiagnostics of two more steps)."""
    m = tp.torch_model(files, NCOL)
    date = TDate.from_ymd(*START)
    m.advance(date)
    date.increment_seconds(1800)
    state1 = m.state
    diags = m.advance(date)
    window = m.run_scan(TDate.from_ymd(1985, 7, 1, 13 * 3600), 2)
    return types.SimpleNamespace(model=m, date=date, state1=state1,
                                 diags=diags, window=window)


def jstate(state) -> JState:
    """The JAX package's ModelState holding the port state's values."""
    d = {k: tp.as_numpy(v) for k, v in state._asdict().items()}
    d["snl"] = d["snl"].astype(np.int32)
    return JState(**d)


def jdiags(diags):
    """The JAX side's view of port diagnostics: numpy fields by name."""
    return types.SimpleNamespace(**{k: tp.as_numpy(v)
                                    for k, v in diags._asdict().items()})


def jdate(d: TDate) -> JDate:
    return JDate(d.year, d.doy, d.sec)


# ---- RunConfig ------------------------------------------------------------

def test_config_roundtrip(tmp_path):
    cfg = tconfig.RunConfig(ncol=7, nsteps=3, lat_deg=40.0, errh2o_max=0.5,
                            device="cpu", pft_path="p.nc")
    p = tmp_path / "run.json"
    cfg.save(p)
    assert tconfig.RunConfig.from_file(p) == cfg


def test_config_rejects_unknown_keys_and_types(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"ncol": 2, "notaknob": 1}))
    with pytest.raises(ValueError, match="notaknob"):
        tconfig.RunConfig.from_file(p)
    with pytest.raises(ValueError, match="ncol"):
        tconfig.RunConfig.from_dict({"ncol": 2.5})
    with pytest.raises(ValueError, match="warm_start"):
        tconfig.RunConfig.from_dict({"warm_start": 1})


def test_config_cli_overrides(tmp_path):
    p = tmp_path / "run.json"
    tconfig.RunConfig(ncol=3).save(p)
    cfg = tconfig.RunConfig.from_cli(["--config", str(p), "--nsteps", "9",
                                      "--lat_deg", "12.5", "--warm_start",
                                      "0", "--device", "cpu"])
    assert (cfg.ncol, cfg.nsteps, cfg.lat_deg) == (3, 9, 12.5)
    assert cfg.warm_start is False and cfg.device == "cpu"


def test_config_fields_match_jax():
    """The same knobs with the same defaults, but the three the port
    changes: ``platform`` is ``device``, and the parameter files have no
    default (no reference data directory)."""
    import dataclasses
    from elmkernels_tpu.config import RunConfig as JRunConfig
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.RunConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(JRunConfig)}
    assert set(tf) - {"device"} == set(jf) - {"platform"}
    differ = {k for k in jf if k in tf and jf[k] != tf[k]}
    assert differ == {"pft_path", "snicar_path"}
    assert tf["pft_path"] is None and tf["device"] is None


def test_config_make_model_on_cpu(files, monkeypatch):
    cfg = tconfig.RunConfig(ncol=3, lat_deg=40.0, device="cpu",
                            pft_path=files[0], snicar_path=files[1],
                            mixed_canopy=False)
    m = cfg.make_model()
    assert m.ncol == 3 and m.device.type == "cpu"
    assert m.dtype == torch.float64 and m.mixed_canopy is False
    d = m.advance(cfg.start_date())
    assert bool(torch.isfinite(d.errh2o).all())
    with pytest.raises(NotImplementedError, match="packed_carry"):
        tconfig.RunConfig(packed_carry=True, device="cpu",
                          pft_path=files[0],
                          snicar_path=files[1]).make_model()
    # float32 runs on the card too (K4 has a float32 instantiation): with
    # no device named, the model asks for a card, which the CPU has not
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tconfig.RunConfig(f64=False, pft_path=files[0],
                          snicar_path=files[1]).make_model()
    m32 = tconfig.RunConfig(f64=False, device="cpu", pft_path=files[0],
                            snicar_path=files[1]).make_model()
    assert m32.state.t_grnd.dtype == torch.float32


# ---- StepGuard ------------------------------------------------------------

def test_errsol_bound_matches_jax():
    for ncol, nsteps in ((128, 48), (8192, 48), (262144, 48), (262144, 96),
                         (1048576, 17520)):
        assert tguard.errsol_bound(ncol, nsteps) == \
            jguard.errsol_bound(ncol, nsteps)


GUARDS = {
    "default": dict(),
    "ncol-scaled": dict(ncol=262144),
    "explicit errsol": dict(ncol=262144, errsol_max=1e-6),
    "strict errh2o": dict(errh2o_max=0.0),
    "strict ledger": dict(errh2o_led_max=0.0),
    "strict errseb": dict(errseb_max=0.0, errh2osno_steady_max=None),
    "every 2": dict(errh2o_max=0.0, every=2),
}


def _check_both(tg, jg, state, diags):
    """One check by each guard on the same values: same report."""
    rt = tg.check(state, diags)
    rj = jg.check(jstate(state), jdiags(diags))
    assert (rt.ok, rt.reasons, rt.can_roll_back) == \
        (rj.ok, rj.reasons, rj.can_roll_back)
    return rt


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_guard_matches_jax_per_step_and_window(stepped, name):
    """Per step (StepDiagnostics) and per window (ScanDiagnostics): the
    same verdicts and reason strings as the JAX StepGuard, the same
    failures list, and a rollback that gives back the validated snapshot
    bit for bit."""
    kw = GUARDS[name]
    tg, jg = tguard.StepGuard(**kw), jguard.StepGuard(**kw)
    assert tg.errsol_max == jg.errsol_max
    st = stepped.model.state
    tg.snapshot(stepped.state1)
    jg.snapshot(jstate(stepped.state1))
    snap = stepped.state1
    for k, diags in enumerate((stepped.diags, stepped.window,
                               stepped.diags)):
        rep = _check_both(tg, jg, st, diags)
        if rep.ok and (k + 1) % tg.every == 0:
            snap = st   # validated: the new snapshot
    assert tg.failures == jg.failures
    if tg.failures:
        rt = tg.restore_into(st)
        rj = jg.restore_into(jstate(st))
        for k in tckpt.PRIMARY_VARS:
            np.testing.assert_array_equal(tp.as_numpy(getattr(rt, k)),
                                          np.asarray(getattr(rj, k)))
            assert torch.equal(getattr(rt, k), getattr(snap, k))


def test_guard_reasons_on_bad_states(stepped):
    """Non-finite and negative states and a NaN diagnostic trip both
    guards with the same reasons; without a snapshot no rollback."""
    st = stepped.model.state
    bad = st._replace(t_grnd=st.t_grnd.clone().fill_(float("nan")),
                      h2osno=st.h2osno - 1.0)
    d = stepped.diags._replace(errsol=stepped.diags.errsol * float("nan"))
    tg, jg = tguard.StepGuard(ncol=NCOL), jguard.StepGuard(ncol=NCOL)
    rep = _check_both(tg, jg, bad, d)
    assert not rep.ok and not rep.can_roll_back
    assert rep.reasons[:2] == ["non-finite t_grnd", "negative h2osno"]
    assert rep.reasons[2].startswith("errsol=nan")
    with pytest.raises(RuntimeError, match="no validated snapshot"):
        tg.restore_into(st)


def test_guard_snapshot_stays_on_device_and_is_copied(stepped):
    g = tguard.StepGuard()
    st = stepped.model.state
    g.snapshot(st)
    assert all(v.device == st.t_grnd.device and
               v.data_ptr() != getattr(st, k).data_ptr()
               for k, v in g._snapshot.items())
    a, b = g.restore_into(st), g.restore_into(st)
    assert a.t_soisno.data_ptr() != b.t_soisno.data_ptr()
    assert torch.equal(a.t_soisno, b.t_soisno)


# ---- metrics, history, clock ----------------------------------------------

def test_metrics_match_jax(stepped, tmp_path):
    s = stepped
    tlog, jlog = TMetrics(tmp_path / "t.jsonl"), JMetrics(tmp_path / "j.jsonl")
    pairs = [(tlog.log_step(s.date, s.model.state, s.diags),
              jlog.log_step(jdate(s.date), jstate(s.model.state),
                            jdiags(s.diags))),
             (tlog.log_window(s.date, s.model.state, s.window),
              jlog.log_window(jdate(s.date), jstate(s.model.state),
                              jdiags(s.window)))]
    tlog.close()
    jlog.close()
    lines = [json.loads(x) for x in
             (tmp_path / "t.jsonl").read_text().splitlines()]
    assert lines == [pairs[0][0], pairs[1][0]]
    for rt, rj in pairs:
        rt, rj = dict(rt), dict(rj)
        rt.pop("ts", None), rj.pop("ts", None)
        assert list(rt) == list(rj)
        for k in rt:
            if isinstance(rj[k], str) or isinstance(rj[k], int):
                assert rt[k] == rj[k], k
            else:
                np.testing.assert_allclose(rt[k], rj[k], rtol=1e-10,
                                           atol=0, err_msg=k)
    assert pairs[1][0]["window"] == 2


def test_history_matches_jax(stepped, tmp_path):
    """Both writers record the same steps; the files read back equal,
    time units and all, in two flushes."""
    from scipy.io import netcdf_file
    s = stepped
    fields = ("t_grnd", "eflx_sh_tot", "t_soisno", "snw_rds")
    tw = THistory(str(tmp_path / "t" / "hist.nc"), fields, every=2,
                  ref_date=TDate.from_ymd(1985, 7, 1))
    jw = JHistory(str(tmp_path / "j" / "hist.nc"), fields, every=2,
                  ref_date=JDate.from_ymd(1985, 7, 1))
    date = s.date.copy()
    for _ in range(3):
        tw.record(date, s.model.state, s.diags)
        jw.record(jdate(date), jstate(s.model.state), jdiags(s.diags))
        date.increment_seconds(1800)
    tw.close()
    jw.close()
    assert len(tw.written) == len(jw.written) == 2
    for pt, pj in zip(tw.written, jw.written):
        with netcdf_file(pt, mmap=False) as ft, \
                netcdf_file(pj, mmap=False) as fj:
            assert ft.dimensions == fj.dimensions
            assert set(ft.variables) == set(fj.variables)
            for k in fj.variables:
                assert ft.variables[k].dimensions == \
                    fj.variables[k].dimensions
                np.testing.assert_array_equal(ft.variables[k].data,
                                              fj.variables[k].data)
            assert ft.variables["time"].units == fj.variables["time"].units
    with pytest.raises(KeyError, match="nosuchfield"):
        THistory(str(tmp_path / "x.nc"), ("nosuchfield",)).record(
            s.date, s.model.state, s.diags)


def test_clock_sections():
    c = Clock()
    for _ in range(3):
        with c.time("a"):
            pass
    summ = c.summary()
    assert summ["a"]["count"] == 3
    lo, hi, mean = c.min_max_mean("a")
    assert lo == hi == mean == summ["a"]["mean_s"]


# ---- checkpoint / restart --------------------------------------------------

def test_primary_vars_match_jax(stepped):
    st = stepped.model.state
    assert list(tckpt.primary_vars(st)) == \
        list(jckpt.primary_vars(jstate(st)))


def test_checkpoint_resume_is_bit_for_bit(files, tmp_path):
    """Four steps in one go against two, a checkpoint, a fresh model
    restored from it, and two more: every state field equal."""
    date = TDate.from_ymd(*START)
    ref = tp.torch_model(files, NCOL)
    ref.run(date, 4)
    a = tp.torch_model(files, NCOL)
    a.run(date, 2)
    path = tmp_path / "ck" / "step000002.pt"
    tckpt.save(path, a.state)
    b = tp.torch_model(files, NCOL)
    b.state = tckpt.restore(path, like=b.state)
    later = date.copy()
    later.increment_seconds(2 * 1800)
    b.run(later, 2)
    for k in ref.state._fields:
        assert torch.equal(getattr(ref.state, k), getattr(b.state, k)), k
    # a checkpoint of another width does not fit
    other = tp.torch_model(files, NCOL + 1)
    with pytest.raises(ValueError, match="does not fit"):
        tckpt.restore(path, like=other.state)


def test_restore_without_device_asks_for_a_card(stepped, tmp_path,
                                                monkeypatch):
    """With neither ``like`` nor ``device`` a checkpoint is read onto the
    card, as ``Model`` resolves its device: without one it raises and
    names ``device="cpu"``, never falling back to the CPU.  Asked for the
    CPU, it reads the state that was saved."""
    path = tmp_path / "ck.pt"
    tckpt.save(path, stepped.model.state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.restore(path)
    st = tckpt.restore(path, device="cpu")
    for k in st._fields:
        got, want = getattr(st, k), getattr(stepped.model.state, k)
        assert got.device.type == "cpu" and torch.equal(got, want), k


# ---- the driver ------------------------------------------------------------

def test_run_model_subprocess(files, tmp_path):
    cfg = dict(ncol=2, nsteps=3, device="cpu", pft_path=files[0],
               snicar_path=files[1], start_doy=181, start_sec=43200,
               metrics_path=str(tmp_path / "m.jsonl"),
               history_path=str(tmp_path / "h" / "hist.nc"), history_every=2,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    (tmp_path / "run.json").write_text(json.dumps(cfg))
    out = subprocess.run(
        [sys.executable, "-m", "elmkernels_torch.run_model", "--config",
         str(tmp_path / "run.json")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: 3 steps x 2 cols" in out.stdout
    assert "0 validation failures" in out.stdout
    assert "history: 2 file(s)" in out.stdout
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 3
    st = tckpt.restore(tmp_path / "ck" / "step000002.pt", device="cpu")
    assert st.t_grnd.shape == (2,)
