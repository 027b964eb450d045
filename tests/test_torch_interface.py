"""The port's ATS-style coupling interface (``elmkernels_torch.driver.
interface``), on the CPU: the four cases of ``tests/test_interface.py`` on
the port, and the exchange fluxes of eight host-forced steps against the
JAX package's ``MinimalInterface`` built from the same synthetic files.

The JAX comparison runs the reference-exact flags (float64 solvers, cold
starts), where the two packages agree at 1e-10 (``test_torch_step.py``);
under the production flags' float32 interiors they agree at 1e-5 only.
"""

import types

import numpy as np
import pytest
import torch

import torch_parity as tp
from elmkernels_torch import constants as c
from elmkernels_torch.driver.interface import (HostForcing, HostPhenology,
                                               MinimalInterface)
from elmkernels_torch.utils.dates import Date
from elmkernels_torch.utils.guard import StepGuard

torch.set_num_threads(1)

NCOL = 3
EXACT = dict(mixed_radiation=False, warm_start=False, mixed_canopy=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tp.write_files(tmp_path_factory.mktemp("torch_iface"))


def _iface(files, **flags):
    return MinimalInterface(ncol=NCOL, model_kw=dict(
        pft_path=files[0], snicar_path=files[1], device="cpu",
        **flags)).setup()


def _interp(pair, wt1, wt2):
    return wt1 * np.asarray(pair[0]) + wt2 * np.asarray(pair[1])


def _host_inputs(iface, date):
    """The interface's own providers interpolated on the host: the ATS
    host model's part."""
    m = iface.model
    w = m.forcing.window(date, m.dtime)
    p = m.phenology.window(date)
    atm = HostForcing(
        atm_tbot=_interp(w.tbot, w.wt1, w.wt2),
        atm_pbot=_interp(w.pbot, w.wt1, w.wt2),
        atm_qbot=_interp(w.qbot, w.wt1, w.wt2),
        atm_flds=_interp(w.flds, w.wt1, w.wt2),
        atm_fsds=np.asarray(w.fsds), atm_prec=np.asarray(w.prec),
        atm_wind=_interp(w.wind, w.wt1, w.wt2),
        atm_zbot=np.full(NCOL, 30.0))
    phen = HostPhenology(
        lai=_interp(p.mlai, p.wt1, p.wt2), sai=_interp(p.msai, p.wt1, p.wt2),
        htop=_interp(p.mhtop, p.wt1, p.wt2),
        hbot=_interp(p.mhbot, p.wt1, p.wt2))
    return atm, phen


def test_advance_exports_exchange_fluxes(files):
    iface = _iface(files)
    fl = iface.advance(Date.from_ymd(1985, 7, 1, 6 * 3600), 1800.0)
    assert isinstance(fl.qflx_rootsoi, np.ndarray)
    assert fl.qflx_rootsoi.shape == (NCOL, c.NLEVGRND)
    for name in ("qflx_top_soil", "qflx_evap_tot", "eflx_sh_tot",
                 "eflx_lh_tot", "eflx_lwrad_out"):
        v = getattr(fl, name)
        assert v.shape == (NCOL,) and np.all(np.isfinite(v)), name


def test_host_forcing_matches_internal_managers(files):
    """The host pathway fed the internal providers' own interpolated
    values reproduces the internal-mode trajectory (the degenerate bracket
    makes the step's time interpolation exact; what is left is host numpy
    against device interpolation rounding)."""
    date = Date.from_ymd(1985, 7, 1, 6 * 3600)
    a, b = _iface(files), _iface(files)
    for _ in range(8):
        fa = a.advance(date, 1800.0)
        atm, phen = _host_inputs(b, date)
        fb = b.advance_with_forcing(date, 1800.0, atm, phen)
        date.increment_seconds(1800)
    np.testing.assert_allclose(fb.eflx_sh_tot, fa.eflx_sh_tot, rtol=1e-9,
                               atol=1e-9)
    for name in a.model.state._fields:
        np.testing.assert_allclose(
            tp.as_numpy(getattr(b.model.state, name)),
            tp.as_numpy(getattr(a.model.state, name)), rtol=1e-9,
            atol=1e-12, err_msg=name)


def test_host_forcing_shape_guard(files):
    iface = _iface(files)
    atm, phen = _host_inputs(iface, Date.from_ymd(1985, 7, 1))
    bad = atm._replace(atm_tbot=np.zeros(NCOL + 1))
    with pytest.raises(ValueError, match="shape"):
        iface.advance_with_forcing(Date.from_ymd(1985, 7, 1), 1800.0, bad,
                                   phen)


def test_host_forcing_recovery_roundtrip(files):
    """Host forcing, a poisoned step that trips the guard, restore, and a
    re-advance with good forcing equal to an undisturbed twin bit for
    bit; the PrimaryVars snapshot round-trips and copies."""
    date = Date.from_ymd(1985, 7, 1, 6 * 3600)
    iface, twin = _iface(files), _iface(files)
    atm, phen = _host_inputs(iface, date)
    iface.advance_with_forcing(date, 1800.0, atm, phen)
    twin.advance_with_forcing(date, 1800.0, atm, phen)
    date.increment_seconds(1800)

    pv = iface.get_primary_vars()
    assert set(pv) >= {"snl", "t_soisno", "h2osoi_liq", "h2osno", "dz"}
    assert pv["t_soisno"].data_ptr() != \
        iface.model.state.t_soisno.data_ptr()

    snap = iface.snapshot()
    guard = StepGuard(ncol=NCOL)
    atm2, phen2 = _host_inputs(iface, date)
    bad = atm2._replace(atm_tbot=np.asarray(atm2.atm_tbot) * np.nan)
    iface.advance_with_forcing(date, 1800.0, bad, phen2)
    clean = types.SimpleNamespace(
        **{k: np.zeros(NCOL) for k in ("errh2o", "errh2o_led", "errh2osno",
                                       "errsol", "errseb")})
    rep = guard.check(iface.model.state, clean)
    assert not rep.ok and any("non-finite" in r for r in rep.reasons)

    # restore twice from the same snapshot: it is never aliased
    for _ in range(2):
        iface.restore(snap)
        iface.advance_with_forcing(date, 1800.0, atm2, phen2)
    twin.advance_with_forcing(date, 1800.0, atm2, phen2)
    for name in twin.model.state._fields:
        assert torch.equal(getattr(twin.model.state, name),
                           getattr(iface.model.state, name)), name
    iface.set_primary_vars(pv)
    assert torch.equal(iface.model.state.t_soisno, pv["t_soisno"])


def test_host_step_converts_no_humidity(files, monkeypatch):
    """The host pathway passes qbot_is_rh=False and every other flag of
    the model to the step, whatever the model's own provider says."""
    from elmkernels_torch.driver import step as step_mod
    iface = _iface(files, elm_correct_seb=True)
    iface.model.forcing.qbot_is_rh = True
    seen = {}
    orig = step_mod.advance

    def spy(*args, **kw):
        seen.update(kw)
        return orig(*args, **kw)
    monkeypatch.setattr(step_mod, "advance", spy)
    atm, phen = _host_inputs(iface, Date.from_ymd(1985, 7, 1))
    iface.advance_with_forcing(Date.from_ymd(1985, 7, 1), 1800.0, atm, phen)
    m = iface.model
    assert seen == dict(
        psn_mode=m.psn_mode, qbot_is_rh=False,
        mixed_radiation=m.mixed_radiation, elm_correct_seb=True,
        warm_start=m.warm_start, mixed_canopy=m.mixed_canopy,
        het_ltype=m.het_ltype,
        elm_correct_snow_aging=m.elm_correct_snow_aging)


def test_exchange_fluxes_match_jax(files):
    """Eight host-forced steps from the same host inputs through the JAX
    package's MinimalInterface and the port's: the exchange fluxes and the
    state at 1e-10."""
    from elmkernels_tpu.driver.interface import HostForcing as JForcing
    from elmkernels_tpu.driver.interface import HostPhenology as JPhen
    from elmkernels_tpu.driver.interface import \
        MinimalInterface as JInterface
    from elmkernels_tpu.utils.dates import Date as JDate
    import jax
    with jax.default_device(jax.devices("cpu")[0]):
        j = JInterface(ncol=NCOL, model_kw=dict(
            pft_path=files[0], snicar_path=files[1], **EXACT)).setup()
    t = _iface(files, **EXACT)
    date = Date.from_ymd(1985, 7, 1, 10 * 3600)
    jdate = JDate.from_ymd(1985, 7, 1, 10 * 3600)
    for _ in range(8):
        atm, phen = _host_inputs(t, date)
        ft = t.advance_with_forcing(date, 1800.0, atm, phen)
        fj = j.advance_with_forcing(jdate, 1800.0, JForcing(*atm),
                                    JPhen(*phen))
        for name in ft._fields:
            np.testing.assert_allclose(getattr(ft, name), getattr(fj, name),
                                       rtol=tp.RTOL, atol=tp.ATOL,
                                       err_msg=name)
        date.increment_seconds(1800)
        jdate.increment_seconds(1800)
    tp.assert_close(j.model.state, t.model.state, path="state")
