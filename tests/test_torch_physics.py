"""Each function of the port's physics, the step's three phases and the
model set-up against the JAX package's, on the CPU, on the inputs the JAX
model really gives them.

The JAX model is built, then advanced one summer step at noon and one
winter step with snow layers on the ground, each under ``jax.disable_jit``
with every function of the modules below wrapped to record its arguments
and result (the first two calls of each).  Each case replays the recorded
calls through the port function of the same module and name and holds the
result to the golden tolerance (``torch_parity.RTOL``/``ATOL``).  The
models run with the reference-exact flags (f64 throughout, no warm start).
"""

import dataclasses
import functools
import importlib
import inspect
import sys
import types

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from elmkernels_torch import constants as tc
from elmkernels_torch import convert
from elmkernels_tpu.utils.dates import Date as JDate

torch.set_num_threads(1)

EXACT = dict(mixed_radiation=False, warm_start=False, mixed_canopy=False)
NCOL = 4
RECORDED_CALLS = 2

MODULES = [f"physics.{m}" for m in (
    "atm_physics", "bareground_fluxes", "canopy_fluxes", "canopy_hydrology",
    "canopy_temperature", "conservation", "friction_velocity", "init_state",
    "math_utils", "phenology", "photosynthesis", "qsat", "snow_hydrology",
    "snow_snicar", "soil_moist_stress", "soil_temperature", "soil_texture",
    "soil_thermal", "solar", "surface_albedo", "surface_fluxes",
    "surface_radiation", "surface_resistance")] + [
    "driver.step", "data.params", "data.state"]

# the JAX package calls these with Python-float constants or PFT traits
# where the port passes 0-d tensors
FLOAT_ARGS_AS_TENSORS = {"stability_func1", "stability_func2", "fth25"}
# port functions under another name: the ci solve's plain version takes
# the JAX signature's out_init
RENAMED = {"hybrid_solve": "hybrid_solve_plain"}

# module -> functions, every one reached by the recorded runs
CASES = {
    "physics.atm_physics": [
        "derive_forc_pco2", "derive_forc_po2", "derive_forc_rho",
        "derive_forc_vp", "interp_forcing", "process_flds", "process_fsds",
        "process_pbot", "process_prec", "process_qbot", "process_tbot",
        "process_wind", "process_zbot"],
    "physics.bareground_fluxes": ["compute_flux", "initialize_flux",
                                  "stability_iteration"],
    "physics.canopy_fluxes": ["compute_flux", "initialize_flux",
                              "stability_iteration"],
    "physics.canopy_hydrology": ["fraction_h2osfc", "fraction_wet",
                                 "ground_flux", "interception", "snow_init"],
    "physics.canopy_temperature": [
        "calc_soilalpha", "calc_soilbeta", "forcing_height",
        "ground_properties", "ground_temp", "humidities", "old_ground_temp"],
    "physics.conservation": [
        "column_water_balance_error", "column_water_mass_tracked",
        "net_radiation", "snow_water_balance_error",
        "solar_longwave_balance_error", "solar_shortwave_balance_error",
        "surface_energy_balance_error"],
    "physics.friction_velocity": [
        "_profile_factor", "_safe_log", "_safe_npow",
        "friction_velocity_humidity", "friction_velocity_humidity2m",
        "friction_velocity_temp", "friction_velocity_temp2m",
        "friction_velocity_wind", "monin_obukhov_length", "stability_func1",
        "stability_func2"],
    "physics.init_state": ["init_melt_factor", "init_micro_sigma",
                           "init_timestep", "init_topo_slope",
                           "init_vegrootfr"],
    "physics.math_utils": ["gather_layers", "safe_div", "safe_tanh",
                           "take_layer"],
    "physics.phenology": ["compute_phenology"],
    "physics.photosynthesis": ["_sel_out", "ci_func", "ft", "fth", "fth25",
                               "hybrid_solve", "photosynthesis",
                               "psn_mode_of", "quadratic_roots"],
    "physics.qsat": ["_horner", "qsat"],
    "physics.snow_hydrology": [
        "_combine_vals", "_rebuild_snow_mesh", "_shift_down",
        "aerosol_phase_change", "combine_layers",
        "compute_aerosol_deposition", "divide_layers", "prune_snow_layers",
        "snow_aging_pinned", "snow_compaction", "snow_water", "transpiration",
        "update_aerosol_mass_and_concen"],
    "physics.snow_snicar": ["_radiation_factor", "_snicar_core",
                            "snicar_ad_rt_both"],
    "physics.soil_moist_stress": [
        "calc_effective_soilporosity", "calc_root_moist_stress",
        "calc_volumetric_h2oliq", "soil_suction"],
    "physics.soil_temperature": [
        "_assemble_system", "calc_dhsdT", "calc_diffusive_heat_flux",
        "calc_dlwrad_emit", "calc_heat_flux_matrix_factor",
        "calc_lwrad_emit", "calc_surface_heat_flux", "check_absorbed_solar",
        "pdma_solve", "phase_change_h2osfc", "phase_change_soisno",
        "update_t_grnd", "update_temperature"],
    "physics.soil_texture": ["init_soil_hydraulics", "pedotransfer",
                             "soil_hydraulic_params"],
    "physics.soil_thermal": [
        "calc_face_tk_full", "calc_h2osfc_heat_capacity",
        "calc_h2osfc_height", "calc_h2osfc_tk", "calc_snow_heat_capacity",
        "calc_snow_tk", "calc_soil_heat_capacity", "calc_soil_tk",
        "thermal_properties"],
    "physics.solar": ["_ensure_tan_defined", "average_cosz", "daylength",
                      "declination_angle_sin", "max_daylength"],
    "physics.surface_albedo": [
        "canopy_layer_lai", "flux_absorption_factor", "ground_albedo",
        "init_timestep", "soil_albedo", "two_stream_solver"],
    "physics.surface_fluxes": [
        "initial_flux_calc", "lwrad_outgoing", "prev_tgrnd",
        "soil_energy_balance", "update_surface_fluxes"],
    "physics.surface_radiation": [
        "canopy_sunshade_fractions", "layer_absorbed_radiation",
        "reflected_radiation", "total_absorbed_radiation"],
    "physics.surface_resistance": ["calc_soilevap_stress"],
    "driver.step": ["advance", "surface_phase", "flux_phase", "column_phase"],
    "data.params": ["default_params", "default_snow_aging_tables",
                    "load_pft_alb", "load_pft_psn"],
    "data.state": ["cold_start"],
}


def _to_numpy(x):
    if isinstance(x, jax.Array):
        return np.asarray(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to_numpy(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


class _Recorder:
    """Wraps every function defined in the JAX modules of ``MODULES``,
    wherever it is bound, and records calls while ``on``."""

    def __init__(self, max_calls=RECORDED_CALLS):
        self.max_calls = max_calls
        self.on = False
        self.calls = {}
        self._patched = []

    def install(self):
        owners = {}
        for m in MODULES:
            mod = importlib.import_module(f"elmkernels_tpu.{m}")
            for name, f in vars(mod).items():
                if (isinstance(f, types.FunctionType)
                        and f.__module__ == mod.__name__):
                    owners[f] = (m, name)
        for mod in list(sys.modules.values()):
            if not getattr(mod, "__name__", "").startswith("elmkernels_tpu"):
                continue
            for name, f in list(vars(mod).items()):
                if isinstance(f, types.FunctionType) and f in owners:
                    self._patched.append((mod, name, f))
                    setattr(mod, name, self._wrap(f, owners[f]))

    def uninstall(self):
        for mod, name, f in self._patched:
            setattr(mod, name, f)
        self._patched = []

    def _wrap(self, f, key):
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            out = f(*args, **kwargs)
            calls = self.calls.setdefault(key, [])
            if self.on and len(calls) < self.max_calls:
                calls.append((_to_numpy(args), _to_numpy(kwargs),
                              _to_numpy(out)))
            return out
        return wrapped

    def take(self):
        """The calls recorded so far, keyed (module, function); resets."""
        calls = {k: v for k, v in self.calls.items() if v}
        self.calls = {}
        return calls

    def record(self, fn):
        self.on = True
        try:
            with jax.disable_jit():
                return fn()
        finally:
            self.on = False


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """{phase: {(module, function): [(args, kwargs, result), ...]}} for
    the model's set-up, a winter step with snow layers and a summer noon
    step."""
    files = tp.write_files(tmp_path_factory.mktemp("torch_physics"))
    rec = _Recorder()
    rec.install()
    phases = {}
    try:
        winter = rec.record(lambda: tp.jax_model(files, NCOL, **EXACT))
        phases["set-up"] = rec.take()
        # the synthetic January forcing builds snow layers after ~550 steps
        winter.run(JDate.from_ymd(1985, 1, 1), 700)
        assert int(np.asarray(winter.state.snl).max()) > 0
        rec.record(lambda: winter.advance(_date(1, 700)))
        phases["winter"] = rec.take()
        # noon, when the canopy photosynthesizes
        summer = tp.jax_model(files, NCOL, **EXACT)
        summer.run(JDate.from_ymd(1985, 7, 1), 24)
        rec.record(lambda: summer.advance(_date(7, 24)))
        phases["summer"] = rec.take()
    finally:
        rec.uninstall()
    return phases


def _date(month, steps):
    d = JDate.from_ymd(1985, month, 1)
    d.increment_seconds(1800 * steps)
    return d


def _port_class(jax_cls):
    """The port's twin of a JAX NamedTuple class: same name, in the port
    module of the same path."""
    module = jax_cls.__module__.replace("elmkernels_tpu", "elmkernels_torch",
                                        1)
    return getattr(importlib.import_module(module), jax_cls.__name__)


# JAX NamedTuples whose port form differs (PFTAlbParams' per-band tuples)
# or that carry integer fields: through the converters
_CONVERTERS = {"PFTPsnParams": convert.psn_from_numpy,
               "PFTAlbParams": convert.alb_from_numpy,
               "SnicarTables": convert.snicar_from_numpy,
               "ModelParams": convert.params_from_numpy,
               "ModelState": convert.state_from_numpy}
_DTYPES = {np.dtype(np.float64): torch.float64,
           np.dtype(np.float32): torch.float32}


def _off(value) -> bool:
    """An input the port has not taken over yet, left off in the recorded
    runs: an option at None or False (``organic_max``), or a forcing the
    step reads only for its monthly aerosol rates, which are None."""
    return value is None or value is False or (
        type(value).__name__ == "StepForcing" and value.aero is None)


def _ported(values: dict, names, where):
    """``values`` without the names the port does not take, each off."""
    extra = {k: v for k, v in values.items() if k not in names}
    assert all(_off(v) for v in extra.values()), (where, sorted(extra))
    return {k: v for k, v in values.items() if k in names}


def _port_arguments(jax_fn, port_fn, args, kwargs, where):
    """A recorded JAX call's arguments, in order, as the port function
    takes them (positional stays positional)."""
    bound = inspect.signature(jax_fn).bind(*args, **kwargs).arguments
    kept = _ported(bound, inspect.signature(port_fn).parameters, where)
    return ([v for k, v in kept.items() if k not in kwargs],
            {k: v for k, v in kept.items() if k in kwargs})


def _port_value(x, floats_as_tensors, keep_dtypes=False):
    """A recorded JAX argument as the port takes it: floating arrays in
    float64, or in their recorded type with ``keep_dtypes`` (the
    production flags' float32 interiors)."""
    def conv(v):
        if isinstance(v, (np.ndarray, np.generic)):
            if keep_dtypes and np.asarray(v).dtype == np.float32:
                return torch.as_tensor(np.array(v))
            return tp.to_torch(v)
        if isinstance(v, np.dtype) or (isinstance(v, type)
                                       and issubclass(v, np.generic)):
            return _DTYPES[np.dtype(v)]
        if isinstance(v, float) and floats_as_tensors:
            return torch.tensor(v, dtype=torch.float64)
        if dataclasses.is_dataclass(v) and type(v).__name__ == "LandType":
            land = {f.name: getattr(v, f.name)
                    for f in dataclasses.fields(v)}
            if not isinstance(land["ltype"], int):  # per-column [ncol]
                land["ltype"] = tp.to_torch(land["ltype"])
            return tc.LandType(**land)
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            name = type(v).__name__
            if name in _CONVERTERS:
                fields = {k: np.asarray(f) for k, f in v._asdict().items()}
                kinds = {f.dtype for f in fields.values()
                         if f.dtype.kind == "f"}
                dtype = (torch.float32 if keep_dtypes
                         and kinds == {np.dtype(np.float32)}
                         else torch.float64)
                return _CONVERTERS[name](fields, dtype=dtype)
            cls = _port_class(type(v))
            return cls(**{k: conv(f) for k, f in _ported(
                v._asdict(), cls._fields, name).items()})
        if isinstance(v, (tuple, list)):
            return type(v)(conv(f) for f in v)
        if isinstance(v, dict):
            return {k: conv(f) for k, f in v.items()}
        return v
    return conv(x)


@pytest.mark.parametrize("module,name", [(m, f) for m, fs in CASES.items()
                                         for f in fs])
def test_port_function_matches_jax(recorded, module, name):
    jax_fn = getattr(importlib.import_module(f"elmkernels_tpu.{module}"),
                     name)
    port_fn = getattr(importlib.import_module(f"elmkernels_torch.{module}"),
                      RENAMED.get(name, name))
    calls = [(phase, call) for phase, by_fn in recorded.items()
             for call in by_fn.get((module, name), [])]
    assert calls, f"the recorded runs never reached {module}.{name}"
    as_tensors = name in FLOAT_ARGS_AS_TENSORS
    for phase, (args, kwargs, out) in calls:
        where = f"{phase} {module}.{name}"
        args, kwargs = _port_arguments(jax_fn, port_fn, args, kwargs, where)
        got = port_fn(*_port_value(args, as_tensors),
                      **_port_value(kwargs, as_tensors))
        tp.assert_close(out, got, path=where)


def test_snow_water_negative_liquid_walk_matches_jax():
    """A ground-evaporation debit larger than the top layer's liquid: the
    walk zeroes the negative liquid and exports it as ``mflx_neg_snow``,
    which the water ledger re-charges.  The recorded runs never reach it;
    a global grid's cold July columns do (the port once read the zeroed
    row back and exported nothing)."""
    from elmkernels_torch.data.state import cold_start
    from elmkernels_torch.physics import snow_hydrology as tsh
    from elmkernels_tpu import constants as jc
    from elmkernels_tpu.physics import snow_hydrology as jsh
    ncol, dtime = 4, 1800.0
    st = {k: v.numpy() for k, v in cold_start(ncol)._asdict().items()}
    liq = st["h2osoi_liq"].copy()
    liq[:, tc.NLEVSNO] = 0.5
    z = np.zeros(ncol)
    args = dict(
        do_capsnow=np.zeros(ncol, np.int32), snl=np.zeros(ncol, np.int32),
        dtime=dtime, frac_sno_eff=np.array([1.0, 0.5, 0.2, 0.0]),
        h2osno=np.array([0.03, 0.02, 0.01, 0.0]), qflx_sub_snow=z,
        qflx_evap_grnd=np.array([1e-3, 1e-3, 1e-4, 1e-3]),
        qflx_dew_snow=z, qflx_dew_grnd=z, qflx_rain_grnd=z,
        qflx_snomelt=z, qflx_snow_melt=z, int_snow=z,
        frac_sno=np.array([1.0, 0.5, 0.2, 0.0]), h2osoi_liq=liq,
        h2osoi_ice=st["h2osoi_ice"],
        mss={k: st["mss_" + k] for k in ("bcphi", "bcpho", "dst1", "dst2",
                                         "dst3", "dst4")},
        dz=st["dz"])
    land = dict(ltype=1, ctype=1, vtype=12)
    want = jsh.snow_water(jc.LandType(**land), **args)
    got = tsh.snow_water(tc.LandType(**land), **_port_value(args, False))
    assert float(np.abs(np.asarray(want.mflx_neg_snow)).max()) > 0.0
    tp.assert_close(want, got, path="snow_water")
