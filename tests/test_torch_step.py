"""The whole coupled step of the PyTorch port against the JAX package's, on
the CPU, from the same synthetic parameter files: the state and every
``StepDiagnostics`` field after each step, and the solvers' iteration
counts; plus the conservation contracts on the port's own winter drive."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from elmkernels_torch.utils.dates import Date as TDate
from elmkernels_tpu.utils.dates import Date as JDate

torch.set_num_threads(1)

NCOL = 6
EXACT = dict(mixed_radiation=False, warm_start=False, mixed_canopy=False)
PRODUCTION = dict(mixed_radiation=True, warm_start=True, mixed_canopy=True)
# the err* diagnostics are residuals of balances whose terms are
# O(1e2..1e3) W/m2 or mm, cancelling to ~1e-2 or less: they are held to an
# absolute 1e-9, i.e. ~1e-12 of the terms


def exact_atol(name):
    return 1e-9 if name.startswith("err") else tp.ATOL


# the production flags run the canopy loop and the radiative transfer in
# float32 (eps 6e-8), where XLA's and PyTorch's exp/log/pow round
# differently.  Over one summer day the gaps stay below a tenth of these
# bounds: 1e-5 relative, with absolute floors of 1e-9 mm/s for water
# fluxes, 1e-3 W/m2 for energy fluxes and energy-balance residuals, 1e-6
# mm for water residuals and 1e-7 (K, mm, Pa) for states.  The canopy
# iteration counts agree exactly; the f32 ci solves, warm-started from
# f32 roots, may take a couple of secant steps more or fewer.
PROD_RTOL = 1e-5
PROD_CI_ITERS_GAP = 4


def prod_atol(name):
    if name.startswith(("qflx", "mflx")):
        return 1e-9
    if name.startswith(("eflx", "fsa", "fsr", "netrad", "errsol", "errlon",
                        "errseb", "errsoi")):
        return 1e-3
    if name.startswith("err"):
        return 1e-6
    return 1e-7


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tp.write_files(tmp_path_factory.mktemp("torch_step"))


def _lockstep(jm, tm, month, day, nsteps, rtol, atol_of, start_steps=0,
              ci_iters_gap=0):
    """Advance both models from the same date and compare the state and
    the diagnostics field by field after every step (``atol_of(name)`` is
    each field's absolute floor, ``ci_iters_gap`` the allowed gap in
    ``niters_ci``); returns the last pair of diagnostics."""
    jd, td = JDate.from_ymd(1985, month, day), TDate.from_ymd(1985, month,
                                                              day)
    for _ in range(start_steps):
        jd.increment_seconds(1800)
        td.increment_seconds(1800)
    jdg = tdg = None
    for i in range(nsteps):
        jdg = jm.advance(jd)
        tdg = tm.advance(td)
        jd.increment_seconds(1800)
        td.increment_seconds(1800)
        for kind, j, t in (("state", jm.state, tm.state),
                           ("diags", jdg, tdg)):
            for name in j._fields:
                tol = ci_iters_gap if name == "niters_ci" else None
                if tol:
                    gap = np.abs(getattr(t, name).numpy()
                                 - np.asarray(getattr(j, name)))
                    assert gap.max() <= tol, (i, name, gap)
                    continue
                tp.assert_close(getattr(j, name), getattr(t, name), rtol,
                                atol_of(name), f"step {i} {kind}.{name}")
    return jdg, tdg


def test_advance_summer_day_exact_flags(files):
    """48 summer steps, reference-exact flags: 1e-10 and equal counts."""
    jm = tp.jax_model(files, NCOL, **EXACT)
    tm = tp.torch_model(files, NCOL, **EXACT)
    jdg, _ = _lockstep(jm, tm, 7, 1, 48, tp.RTOL, exact_atol)
    assert int(np.asarray(jdg.niters_canopy).max()) > 0


def test_advance_summer_day_production_flags(files):
    """48 summer steps with the production flags (f32 interiors)."""
    jm = tp.jax_model(files, NCOL, **PRODUCTION)
    tm = tp.torch_model(files, NCOL, **PRODUCTION)
    _lockstep(jm, tm, 7, 1, 48, PROD_RTOL, prod_atol,
              ci_iters_gap=PROD_CI_ITERS_GAP)


def test_snow_layer_case(files):
    """The JAX model's state after a 700-step January drive (snow layers
    form after ~550 steps with the synthetic forcing) carried across, then
    10 more steps in lockstep at 1e-10: combine/divide under parity."""
    jm = tp.jax_model(files, 2, **EXACT)
    jm.run(JDate.from_ymd(1985, 1, 1), 700)
    assert int(np.asarray(jm.state.snl).max()) > 0
    tm = tp.torch_model(files, 2, **EXACT)
    tp.carry_model(jm, tm)
    _lockstep(jm, tm, 1, 1, 10, tp.RTOL, exact_atol, start_steps=700)
    assert int(tm.state.snl.max()) > 0


def test_snow_layer_case_through_k5(files, tmp_path, monkeypatch):
    """The snow-layer case with the step's snow-hydrology block run by K5
    (``csrc/snow_hydrology.cu``) built for the host, as
    ``test_torch_snow_kernel.py`` builds it, in place of the plain block:
    routed as a card routes it (``snow_hydrology_block`` to
    ``ops.snow.snow_hydrology``), once a step, 10 steps in lockstep with
    the JAX step at 1e-10."""
    from elmkernels_torch.ops import snow
    from elmkernels_torch.physics import snow_hydrology as tsh
    from test_torch_snow_kernel import build_host_lib, host_block
    lib = build_host_lib(tmp_path)
    calls = []

    def k5(**args):
        calls.append(int(args["snl"].max()))
        return host_block(lib, args)
    monkeypatch.setattr(tsh, "_on_card", lambda t: True)
    monkeypatch.setattr(snow, "snow_hydrology", k5)
    jm = tp.jax_model(files, 2, **EXACT)
    jm.run(JDate.from_ymd(1985, 1, 1), 700)
    tm = tp.torch_model(files, 2, **EXACT)
    tp.carry_model(jm, tm)
    _lockstep(jm, tm, 1, 1, 10, tp.RTOL, exact_atol, start_steps=700)
    assert len(calls) == 10 and max(calls) > 0



def test_snow_layer_case_through_k7(files, tmp_path, monkeypatch):
    """The snow-layer case with the step's soil temperature module run by
    K7 (``csrc/soil_temperature.cu``) built for the host, as
    ``test_torch_soil_temperature_kernel.py`` builds it, in place of the
    plain chain: routed as a card routes it (``soil_temperature_block`` to
    ``ops.soil_temperature.soil_temperature``), once a step, 10 steps in
    lockstep with the JAX step at 1e-10."""
    from elmkernels_torch.ops import soil_temperature as k7
    from elmkernels_torch.physics import soil_temperature as tst
    from test_torch_soil_temperature_kernel import build_host_lib, host_module
    lib = build_host_lib(tmp_path)
    calls = []

    def kernel(**args):
        calls.append(int(args["snl"].max()))
        return host_module(lib, args)
    monkeypatch.setattr(tst, "_on_card", lambda t: True)
    monkeypatch.setattr(k7, "soil_temperature", kernel)
    jm = tp.jax_model(files, 2, **EXACT)
    jm.run(JDate.from_ymd(1985, 1, 1), 700)
    tm = tp.torch_model(files, 2, **EXACT)
    tp.carry_model(jm, tm)
    _lockstep(jm, tm, 1, 1, 10, tp.RTOL, exact_atol, start_steps=700)
    assert len(calls) == 10 and max(calls) > 0

def test_port_winter_drive_contracts(files):
    """The port's own 100-step winter drive (production flags) meets the
    JAX package's test_driver contracts."""
    tm = tp.torch_model(files, 4, **PRODUCTION)
    worst = {"errh2o_led": 0.0, "errlon": 0.0, "errh2osno": 0.0,
             "errsol": 0.0}

    def cb(date, state, d):
        for k in worst:
            worst[k] = max(worst[k], float(getattr(d, k).abs().max()))

    tm.run(TDate.from_ymd(1985, 1, 1), 100, cb)
    st = tm.state
    t = st.t_soisno[st.t_soisno != 0.0]
    assert bool(((t > 150.0) & (t < 350.0)).all())
    assert bool((st.h2osno >= 0.0).all()) and bool((st.snl >= 0).all())
    assert bool(torch.isfinite(st.t_grnd).all())
    assert worst["errh2o_led"] < 1e-9, worst
    assert worst["errlon"] < 1e-8, worst
    assert worst["errh2osno"] < 1e-7, worst
    assert worst["errsol"] < 1e-5, worst
