"""Each landunit-dependent function of the port and ELM's snow grain aging,
against the JAX package on the CPU, on the calls of a recorded winter step.

A JAX model of five columns, one of each class the step runs (soil, crop,
ice sheet, ice sheet with elevation classes, wetland), with per-column
land types and ``elm_correct_snow_aging`` on the synthetic ``snicar_drdt``
tables, is built and advanced 700 January steps (snow layers form after
~550), then one more step is recorded call by call under
``jax.disable_jit`` (``test_torch_physics._Recorder``).  Every
landunit-dependent function of the port, the SNICAR call on the aged
radii, ``snow_aging`` with both clamps and the step's phases replay the
recorded calls at ``torch_parity.RTOL``/``ATOL`` (the step's balance
residuals at ``test_torch_step.exact_atol``).  ``convert`` carries the
JAX model's per-column ``ltype`` and aging tables across.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import test_torch_physics as tph
import test_torch_step as ts
import torch_parity as tp
from elmkernels_torch import constants as tc
from elmkernels_torch import convert
from elmkernels_torch.data import synthetic
from elmkernels_tpu.utils.dates import Date as JDate

torch.set_num_threads(1)

LTYPES5 = [tc.ISTSOIL, tc.ISTCROP, tc.ISTICE, tc.ISTICE_MEC, tc.ISTWET]
VTYPES5 = [12, 19, 0, 0, 0]
WINTER_STEPS = 700


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_landunits")
    pft, snicar = tp.write_files(d)
    aging = str(d / "snicar_drdt_synthetic.nc")
    synthetic.write_snow_aging_tables(aging)
    return pft, snicar, aging


@pytest.fixture(scope="module")
def recorded(files):
    """(the JAX model, {phase: {(module, function): calls}}) for the
    set-up and a winter step with snow layers of the five-class batch."""
    rec = tph._Recorder()
    rec.install()
    try:
        jm = rec.record(lambda: tp.jax_model(
            files[:2], len(LTYPES5), ltype=np.array(LTYPES5), vtype=VTYPES5,
            elm_correct_snow_aging=True, snow_aging_path=files[2],
            **ts.EXACT))
        phases = {"set-up": rec.take()}
        jm.run(JDate.from_ymd(1985, 1, 1), WINTER_STEPS)
        date = JDate.from_ymd(1985, 1, 1)
        date.increment_seconds(1800 * WINTER_STEPS)
        rec.record(lambda: jm.advance(date))
        phases["winter"] = rec.take()
    finally:
        rec.uninstall()
    return jm, phases


# every function of the port that selects on the landunit type, and the
# calls downstream of the aged radii; each is reached by the recording
LANDUNIT_CASES = {
    "physics.init_state": ["init_soil_temp", "init_soilh2o_state",
                           "init_melt_factor", "init_timestep"],
    "physics.soil_thermal": ["calc_soil_tk", "calc_soil_heat_capacity",
                             "thermal_properties"],
    "physics.surface_resistance": ["calc_soilevap_stress"],
    "physics.surface_albedo": ["soil_albedo", "flux_absorption_factor",
                               "two_stream_solver", "ground_albedo"],
    "physics.canopy_hydrology": ["interception", "snow_init",
                                 "fraction_h2osfc", "fraction_wet",
                                 "ground_flux"],
    "physics.canopy_temperature": ["calc_soilalpha", "calc_soilbeta",
                                   "humidities", "ground_properties",
                                   "forcing_height"],
    "physics.soil_temperature": ["_assemble_system", "pdma_solve",
                                 "phase_change_soisno"],
    "physics.snow_hydrology": ["snow_compaction", "combine_layers",
                               "snow_water", "divide_layers", "snow_aging"],
    "physics.snow_snicar": ["snicar_ad_rt_both"],
    "data.params": ["default_params"],
    "driver.step": ["advance", "surface_phase", "flux_phase",
                    "column_phase"],
}


def _calls(phases, module, name):
    calls = [c for by_fn in phases.values()
             for c in by_fn.get((module, name), [])]
    assert calls, f"the recording never reached {module}.{name}"
    return calls


def _replay(module, name, call):
    """A recorded call through the port function of the same name."""
    args, kwargs, _ = call
    jax_fn = getattr(importlib.import_module(f"elmkernels_tpu.{module}"),
                     name)
    port_fn = getattr(importlib.import_module(f"elmkernels_torch.{module}"),
                      name)
    a, k = tph._port_arguments(jax_fn, port_fn, args, kwargs, name)
    return port_fn(*tph._port_value(a, False), **tph._port_value(k, False))


@pytest.mark.parametrize("module,name", [
    (m, f) for m, fs in LANDUNIT_CASES.items() for f in fs])
def test_landunit_function_matches_jax(recorded, module, name):
    _, phases = recorded
    for call in _calls(phases, module, name):
        # advance takes the domain's int LandType and swaps in the
        # per-column params.ltype (het_ltype); the functions below it see
        # the [ncol] one
        land = [v for v in (*call[0], *call[1].values())
                if type(v).__name__ == "LandType"]
        assert not land or name == "advance" or not isinstance(
            land[0].ltype, int), "recorded with a static land type"
        got = _replay(module, name, call)
        if module == "driver.step" and name != "surface_phase" \
                and name != "flux_phase":
            # (state, diagnostics): the balance residuals cancel terms of
            # up to ~1e3 mm (a water-filled wetland column), so they are
            # held to test_torch_step's absolute floor
            tp.assert_close(call[2][0], got[0], path=f"{name} state")
            for k in call[2][1]._fields:
                tp.assert_close(getattr(call[2][1], k), getattr(got[1], k),
                                tp.RTOL, ts.exact_atol(k),
                                f"{name} diagnostics.{k}")
        else:
            tp.assert_close(call[2], got, path=f"{module}.{name}")


def test_recorded_step_ages_and_layers(recorded):
    """The recording covers what it is for: snow layers on the ground, the
    five classes, and radii aged past fresh snow feeding SNICAR (rows of
    the Mie tables the pinned radius never reads)."""
    jm, phases = recorded
    assert int(np.asarray(jm.state.snl).max()) > 0
    np.testing.assert_array_equal(np.asarray(jm.params.ltype), LTYPES5)
    (args, kwargs, _), = _calls(phases, "physics.snow_snicar",
                                "snicar_ad_rt_both")[:1]
    from elmkernels_tpu.physics import snow_snicar
    bound = inspect.signature(snow_snicar.snicar_ad_rt_both).bind(
        *args, **kwargs).arguments
    assert float(np.max(bound["snw_rds"])) > tc.SNW_RDS_MIN + 1.0


@pytest.mark.parametrize("clamp", [False, True])
def test_snow_aging_matches_jax(recorded, clamp):
    """Both clamps on the step's recorded aging inputs: the reference's
    double clamp pins every active layer to SNW_RDS_MIN, ELM's lets the
    grains grow, up to SNW_RDS_MAX."""
    from elmkernels_tpu.physics import snow_hydrology as jsh
    _, phases = recorded
    (args, kwargs, _), = _calls(phases, "physics.snow_hydrology",
                                "snow_aging")[:1]
    kwargs = dict(kwargs, elm_correct_clamp=clamp)
    want = jsh.snow_aging(*args, **kwargs)
    got = _replay("physics.snow_hydrology", "snow_aging",
                  (args, kwargs, None))
    tp.assert_close(want, got, path=f"snow_aging clamp={clamp}")
    snl = np.asarray(args[1])
    lev = np.arange(tc.NLEVSNO)[None, :]
    active = (lev >= tc.NLEVSNO - snl[:, None]) & (snl[:, None] > 0)
    assert active.any()
    rds = got.numpy()[active]
    assert rds.min() >= tc.SNW_RDS_MIN and rds.max() <= tc.SNW_RDS_MAX
    assert (rds.max() > tc.SNW_RDS_MIN) == clamp


def test_params_round_trip_ltype_and_aging_tables(recorded, files):
    """``convert.params_from_numpy`` carries the JAX parameters' per-column
    integer ltype and the aging tables across, and they equal the port's
    own reading of the same files."""
    jm, _ = recorded
    d = tp.nt_numpy(jm.params)
    p = convert.params_from_numpy(d)
    assert p.ltype.dtype == torch.int64
    np.testing.assert_array_equal(p.ltype.numpy(), LTYPES5)
    back = convert.to_numpy(p)
    for k in ("ltype", "snowage_tau", "snowage_kappa", "snowage_drdt0"):
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    tm = tp.torch_model(files[:2], len(LTYPES5), ltype=np.array(LTYPES5),
                        vtype=VTYPES5, elm_correct_snow_aging=True,
                        snow_aging_path=files[2], **ts.EXACT)
    tp.assert_close(jm.params, tm.params)
    # unvegetated ice and wetland columns: the same traits and pathway
    assert tm.psn_mode == jm.psn_mode
    tp.assert_close(jm.psnveg, tm.psnveg)
    np.testing.assert_array_equal(
        tm.params.snowage_drdt0.numpy(),
        synthetic.snow_aging_tables()["drdsdt0"])
