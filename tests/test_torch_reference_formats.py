"""The reference's file formats and defaults in the port, and the JAX
package's last helpers, on the CPU.

- SNICAR optics from the reference's SnowOptics text fixture
  (``params.load_snicar_from_text``): the synthetic optics written as text
  (``ops.testing.write_snow_optics_text``) read back equal, bit for bit,
  to the JAX package's reader of the same file and to the port's NetCDF
  reader of the same tables; a table of the wrong size, or none, raises
  naming it.
- The default parameter paths name the JAX package's files; a missing
  default raises ``FileNotFoundError`` naming it; with synthetic files in
  the default directory, ``Model`` and ``RunConfig`` build.
- A 4-column model on the text optics against the NetCDF-optics model, bit
  for bit, and against the JAX ``Model`` on the same text file at rtol
  1e-10 with equal iteration counts.
- ``snicar_ad_rt``, the single-flag sweep, against the JAX package's at
  rtol 1e-10 and against the matching half of ``snicar_ad_rt_both``
  exactly (equal on the CPU as it stands: no scalar-tail rounding gap
  between the 5-row and the 10-row sweeps showed on these inputs).
- Each small helper against its JAX counterpart on seeded inputs.

The JAX package is imported inside the tests, so that the ``cuda`` test
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_reference_formats.py
"""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from elmkernels_torch import config as tconfig
from elmkernels_torch import constants as c
from elmkernels_torch.data import params as tparams
from elmkernels_torch.data import synthetic
from elmkernels_torch.driver import model as tmodel
from elmkernels_torch.ops import testing
from elmkernels_torch.physics import snow_snicar as sn
from elmkernels_torch.utils.dates import Date as TDate

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
LAND = c.LandType(ltype=1, ctype=1, vtype=12)
SNICAR_ARGS = ("coszen", "h2osno", "snl", "h2osoi_liq", "h2osoi_ice",
               "snw_rds", "albsoi", "mss_cnc_aer")
NCOL = 4
NSTEPS = 12
SNICAR_NCOL = 96
EXACT = dict(mixed_radiation=False, warm_start=False, mixed_canopy=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("reference_formats")
    out = dict(pft=d / "clm_params.nc", nc=d / "snicar_optics.nc",
               txt=d / "SnowOptics_synthetic.txt")
    synthetic.write_clm_params(out["pft"])
    synthetic.write_snicar_optics(out["nc"])
    testing.write_snow_optics_text(out["txt"])
    return {k: str(v) for k, v in out.items()}


def _synthetic_slots() -> dict:
    return tparams.snicar_slots(synthetic.snicar_tables(), "synthetic")


# ---- the SnowOptics text fixture --------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_text_optics_equal_netcdf_and_jax(files, dtype):
    from elmkernels_tpu.data import params as jparams
    txt = tparams.load_snicar_from_text(files["txt"], dtype)
    nc = tparams.read_snicar_data(files["nc"], dtype)
    jt = jparams.load_snicar_from_text(files["txt"])
    slots = _synthetic_slots()
    assert set(txt._fields) == set(slots) == set(jt._fields)
    for k in txt._fields:
        a = getattr(txt, k)
        assert a.dtype == dtype and a.shape == slots[k].shape, k
        assert torch.equal(a, getattr(nc, k)), k
        want = np.asarray(getattr(jt, k)).astype(a.numpy().dtype)
        np.testing.assert_array_equal(a.numpy(), want, err_msg=k)
        np.testing.assert_array_equal(a.numpy(), slots[k].astype(want.dtype),
                                      err_msg=k)


@pytest.mark.parametrize("fault", ["short", "long", "missing"])
def test_bad_table_raises_naming_it(tmp_path, fault):
    from elmkernels_tpu.data import params as jparams
    name = "asm_prm_snw_dfs"
    slots = _synthetic_slots()
    flat = slots[name].reshape(-1)
    if fault == "missing":
        del slots[name]
    else:
        slots[name] = flat[:-1] if fault == "short" else np.append(flat, 0.5)
    path = tmp_path / "SnowOptics_bad.txt"
    testing.write_snow_optics_text(path, slots)
    with pytest.raises(KeyError if fault == "missing" else ValueError,
                       match=name) as err:
        tparams.load_snicar_from_text(path)
    assert str(path) in str(err.value)
    # the JAX package's reader refuses the same file
    with pytest.raises(KeyError if fault == "missing" else ValueError):
        jparams.load_snicar_from_text(str(path))


# ---- the default parameter paths --------------------------------------------

def _port(code: str, env: dict) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter with ``env`` added, the port's
    module constants read anew."""
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, **env), capture_output=True,
                          text=True, timeout=300)


DEFAULTS_CODE = """
import dataclasses, json
from elmkernels_torch.config import RunConfig
from elmkernels_torch.driver import model
f = {c.__name__: {x.name: x.default for x in dataclasses.fields(c)}
     for c in (model.Model, RunConfig)}
print(json.dumps({k: [v["pft_path"], v["snicar_path"]] for k, v in f.items()}
                 | {"module": [model.DEFAULT_PFT_PATH,
                               model.DEFAULT_SNICAR_PATH]}))
"""


def test_default_paths_are_the_jax_packages():
    from elmkernels_tpu.config import RunConfig as JRunConfig
    from elmkernels_tpu.driver import model as jmodel
    want = [jmodel.DEFAULT_PFT_PATH, jmodel.DEFAULT_SNICAR_PATH]
    for mine, theirs in zip((tmodel.DEFAULT_PFT_PATH,
                             tmodel.DEFAULT_SNICAR_PATH), want):
        assert os.path.basename(mine) == os.path.basename(theirs)
    jcfg = JRunConfig()
    assert [jcfg.pft_path, jcfg.snicar_path] == want
    out = _port(DEFAULTS_CODE,
                {"ELM_INPUT_DATA_DIR": os.path.dirname(want[0])})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == {"Model": want, "RunConfig": want,
                                      "module": want}


def test_missing_default_file_raises_naming_it(tmp_path, files):
    code = ("from elmkernels_torch.driver.model import Model\n"
            "try:\n    Model(ncol=2, device='cpu')\n"
            "except FileNotFoundError as e:\n    print(e)\n")
    out = _port(code, {"ELM_INPUT_DATA_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert repr(str(tmp_path / "clm_params_c180524.nc")) in out.stdout
    assert "synthetic.parameter_files()" in out.stdout
    # an explicit path is held to the same rule
    missing = tmp_path / "SnowOptics_none.txt"
    with pytest.raises(FileNotFoundError, match=re.escape(str(missing))):
        tmodel.Model(ncol=2, device="cpu", pft_path=files["pft"],
                     snicar_path=str(missing))


def test_defaults_in_their_directory_build(tmp_path, files):
    """Synthetic files under the default names, in the default directory:
    ``Model`` and ``RunConfig().make_model()`` build with no paths given,
    and read the text optics as the NetCDF's tables."""
    shutil.copy(files["pft"], tmp_path / "clm_params_c180524.nc")
    shutil.copy(files["txt"], tmp_path / "SnowOptics_IN.txt")
    code = f"""
import torch
from elmkernels_torch.config import RunConfig
from elmkernels_torch.data.params import read_snicar_data
from elmkernels_torch.driver.model import Model
from elmkernels_torch.utils.dates import Date
ref = read_snicar_data({files["nc"]!r})
for m in (Model(ncol=3, device="cpu"),
          RunConfig(ncol=3, device="cpu").make_model()):
    assert all(torch.equal(a, b) for a, b in zip(m.snicar, ref))
    d = m.advance(Date(1985, 181, 43200))
    assert bool(torch.isfinite(d.errh2o).all())
print("built")
"""
    out = _port(code, {"ELM_INPUT_DATA_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "built"


def test_jax_run_config_naming_text_optics(files, tmp_path):
    """A JAX RunConfig JSON that names a SnowOptics text file: the JAX
    package takes it, and the port's RunConfig builds a model on the same
    tables."""
    from elmkernels_tpu.config import RunConfig as JRunConfig
    data = dict(ncol=3, nsteps=2, pft_path=files["pft"],
                snicar_path=files["txt"], mixed_canopy=False)
    assert JRunConfig.from_dict(data).snicar_path == files["txt"]
    (tmp_path / "run.json").write_text(json.dumps(data))
    cfg = tconfig.RunConfig.from_file(tmp_path / "run.json")
    cfg.device = "cpu"
    m = cfg.make_model()
    ref = tparams.read_snicar_data(files["nc"])
    assert all(torch.equal(a, b) for a, b in zip(m.snicar, ref))


# ---- the model on the text optics -------------------------------------------

def _start(cls):
    d = cls.from_ymd(1985, 7, 1)
    d.increment_seconds(24 * 1800)
    return d


@pytest.mark.parametrize("flags", ["production", "exact"])
def test_text_model_equals_netcdf_model(files, flags):
    kw = EXACT if flags == "exact" else {}
    runs = []
    for optics in ("txt", "nc"):
        m = tmodel.Model(ncol=NCOL, pft_path=files["pft"],
                         snicar_path=files[optics], device="cpu", **kw)
        d = m.run_windows(_start(TDate), NSTEPS, window=NSTEPS, series=True)
        runs.append((m.state, d))
    (st, dt), (sn_, dn) = runs
    for k in st._fields:
        assert torch.equal(getattr(st, k), getattr(sn_, k)), k
    for k in dt._fields:
        assert torch.equal(getattr(dt, k), getattr(dn, k)), k
    assert int(dt.niters_canopy_max.max()) > 0


def test_text_model_matches_jax(files):
    """The JAX Model on the same text file, in lockstep for 12 steps under
    the reference-exact flags: 1e-10 and equal iteration counts."""
    import test_torch_step as ts
    import torch_parity as tp
    paths = (files["pft"], files["txt"])
    jm = tp.jax_model(paths, NCOL, **EXACT)
    tm = tp.torch_model(paths, NCOL, **EXACT)
    jdg, tdg = ts._lockstep(jm, tm, 7, 1, NSTEPS, tp.RTOL, ts.exact_atol,
                            start_steps=24)
    assert int(tdg.niters_canopy.max()) > 0
    assert int(tdg.niters_ci.max()) > 0


# ---- the single-flag SNICAR sweep -------------------------------------------

def _snicar_inputs(ncol, dtype, device=None):
    a = testing.snicar_problem(ncol, 11)
    t = {k: torch.as_tensor(v, device=device) for k, v in a.items()}
    t = {k: (v.to(dtype) if v.is_floating_point() else v)
         for k, v in t.items()}
    slots = _synthetic_slots()
    tabs = sn.SnicarTables(**{k: torch.tensor(v, dtype=dtype, device=device)
                              for k, v in slots.items()})
    return a, [t[k] for k in SNICAR_ARGS], tabs


@pytest.mark.parametrize("flag", [1, 2])
def test_snicar_ad_rt_matches_jax(flag):
    import jax.numpy as jnp
    import torch_parity as tp
    from elmkernels_tpu import constants as jc
    from elmkernels_tpu.physics import snow_snicar as jsn
    a, args, tabs = _snicar_inputs(SNICAR_NCOL, torch.float64)
    jtabs = jsn.SnicarTables(**{k: jnp.asarray(v.numpy())
                                for k, v in tabs._asdict().items()})
    want = jsn.snicar_ad_rt(jc.LandType(ltype=1, ctype=1, vtype=12), flag,
                            *(jnp.asarray(a[k]) for k in SNICAR_ARGS),
                            jtabs)
    got = sn.snicar_ad_rt(LAND, flag, *args, tabs)
    tp.assert_close(want, got, path=f"snicar_ad_rt({flag})")
    # the inputs reach every branch: active, thin and no snow
    snl = a["snl"]
    assert set(snl.tolist()) == set(range(6))
    assert float(np.abs(np.asarray(want.albout)).max()) > 0.5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_snicar_ad_rt_equals_half_of_both(dtype):
    _, args, tabs = _snicar_inputs(SNICAR_NCOL + 1, dtype)
    both = sn.snicar_ad_rt_both(LAND, *args, tabs)
    for flag, half in zip((1, 2), both):
        one = sn.snicar_ad_rt(LAND, flag, *args, tabs)
        for name in one._fields:
            assert torch.equal(getattr(one, name), getattr(half, name)), (
                flag, name)


def test_snicar_ad_rt_refuses_other_flags():
    _, args, tabs = _snicar_inputs(6, torch.float64)
    with pytest.raises(ValueError, match="flg_slr_in"):
        sn.snicar_ad_rt(LAND, 3, *args, tabs)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's reference formats "
                    "phase runs this comparison at 262,144 columns)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_snicar_ad_rt_equals_half_of_both_on_the_card(card, dtype):
    _, args, tabs = _snicar_inputs(4097, dtype, card)
    both = sn.snicar_ad_rt_both(LAND, *args, tabs)
    for flag, half in zip((1, 2), both):
        one = sn.snicar_ad_rt(LAND, flag, *args, tabs)
        for name in one._fields:
            assert torch.equal(getattr(one, name), getattr(half, name)), (
                flag, name)


# ---- the small helpers ------------------------------------------------------

def _rng():
    return np.random.default_rng(5)


def test_init_energy_fluxes_matches_jax():
    import jax.numpy as jnp
    import torch_parity as tp
    from elmkernels_tpu import constants as jc
    from elmkernels_tpu.physics import canopy_temperature as jct
    from elmkernels_torch.physics import canopy_temperature as tct
    x = _rng().uniform(250.0, 300.0, 7)
    want = jct.init_energy_fluxes(jc.LandType(ltype=1, ctype=1, vtype=12),
                                  jnp.asarray(x))
    got = tct.init_energy_fluxes(LAND, torch.as_tensor(x))
    assert type(got).__name__ == "InitEnergyFluxesOut"
    tp.assert_close(want, got, rtol=0.0, atol=0.0)


def test_dh2o_dt_matches_jax():
    import jax.numpy as jnp
    import torch_parity as tp
    from elmkernels_tpu.physics import conservation as jce
    from elmkernels_torch.physics import conservation as tce
    r = _rng()
    beg, end = r.uniform(0.0, 500.0, 9), r.uniform(0.0, 500.0, 9)
    want = jce.dh2o_dt(jnp.asarray(beg), jnp.asarray(end), 1800.0)
    got = tce.dh2o_dt(torch.as_tensor(beg), torch.as_tensor(end), 1800.0)
    tp.assert_close(want, got)


def test_safe_sqrt_and_pow_match_jax():
    import jax.numpy as jnp
    import torch_parity as tp
    from elmkernels_tpu.physics import math_utils as jmu
    from elmkernels_torch.physics import math_utils as tmu
    x = np.concatenate([_rng().uniform(-3.0, 3.0, 20), [0.0, -0.0, np.nan]])
    tp.assert_close(jmu.safe_sqrt(jnp.asarray(x)),
                    tmu.safe_sqrt(torch.as_tensor(x)))
    for p in (0.5, 2.0, 3.7):
        tp.assert_close(jmu.safe_pow(jnp.asarray(x), p),
                        tmu.safe_pow(torch.as_tensor(x), p))


def test_model_state_cnc_and_with_mss_match_jax():
    import jax.numpy as jnp
    import torch_parity as tp
    from elmkernels_torch.data.state import AERO_SPECIES, cold_start
    from elmkernels_tpu.data.state import ModelState as JState
    r = _rng()
    ts = cold_start(3, device="cpu")
    ts = ts._replace(**{f"{p}_{k}": torch.as_tensor(r.uniform(
        0.0, 1e-6, (3, c.NLEVSNO))) for k in AERO_SPECIES
        for p in ("mss", "cnc")})
    js = JState(**{k: jnp.asarray(v.numpy()) for k, v in
                   ts._asdict().items()})
    tp.assert_close(js.cnc, ts.cnc)
    tp.assert_close(js.mss, ts.mss)
    mss = {k: r.uniform(0.0, 1e-5, (3, c.NLEVSNO)) for k in AERO_SPECIES}
    cnc = {k: r.uniform(0.0, 1e-5, (3, c.NLEVSNO)) for k in AERO_SPECIES}
    for kw in ({}, {"cnc": cnc}):
        want = js.with_mss({k: jnp.asarray(v) for k, v in mss.items()},
                           **{n: {k: jnp.asarray(v) for k, v in d.items()}
                              for n, d in kw.items()})
        got = ts.with_mss({k: torch.as_tensor(v) for k, v in mss.items()},
                          **{n: {k: torch.as_tensor(v) for k, v in d.items()}
                             for n, d in kw.items()})
        tp.assert_close(tp.nt_numpy(want), got._asdict())


@pytest.mark.parametrize("vtype", [1, 12, 14])
def test_pft_roots_and_roughness_match_jax(files, vtype):
    from elmkernels_tpu.data import params as jparams
    for name in ("load_pft_roots", "load_pft_displar_z0mr"):
        want = getattr(jparams, name)(files["pft"], vtype)
        got = getattr(tparams, name)(files["pft"], vtype)
        assert got == want, name


def test_default_params_organic_max_matches_jax(files):
    """``organic_max`` None reads the file's; a value given is used."""
    import torch_parity as tp
    from elmkernels_tpu.data import params as jparams
    got = {}
    for om in (None, 60.0, 130.0):
        want = jparams.default_params(2, files["pft"], organic_max=om)
        got[om] = tparams.default_params(2, files["pft"], organic_max=om)
        tp.assert_close(want, got[om])
    assert not torch.equal(got[60.0].watsat, got[130.0].watsat)


def test_table_extents_match_jax():
    from elmkernels_tpu.data import params as jparams
    from elmkernels_tpu.data import snicar_data as jsd
    from elmkernels_tpu.physics import snow_hydrology as jsh
    from elmkernels_torch.physics import snow_hydrology as tsh
    for name in ("NUMRAD_SNW", "IDX_MIE_SNW_MX", "N_BC_NCLRDS",
                 "N_BCINT_ICERDS", "N_AGING_T", "N_AGING_TGRD",
                 "N_AGING_RHOS"):
        assert getattr(tparams, name) == getattr(jsd, name), name
    for name in ("IDX_T_MAX", "IDX_TGRD_MAX", "IDX_RHOS_MAX"):
        assert getattr(tsh, name) == getattr(jsh, name), name
    assert tparams.SNOW_AGING_SHAPE == (jsd.N_AGING_T, jsd.N_AGING_TGRD,
                                        jsd.N_AGING_RHOS)
    for name in ("ALBSAT_20", "ALBDRY_20"):
        np.testing.assert_array_equal(getattr(tparams, name),
                                      getattr(jparams, name))
    for slot, (_, shape) in tparams.SNICAR_VARS.items():
        if slot.startswith(("ss_alb_bc", "asm_prm_bc", "ext_cff_mss_bc")):
            assert shape == (jsd.N_BC_NCLRDS, jsd.NUMRAD_SNW), slot
    assert tparams.SNICAR_VARS["bcenh"][1] == (
        jsd.N_BCINT_ICERDS, jsd.N_BC_NCLRDS, jsd.NUMRAD_SNW)
