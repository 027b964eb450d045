"""Per-column landunit types in the port, against the JAX package on the
CPU.

- ``ltype_mask``/``lsel``/``lor`` against the JAX package's, on int and
  [ncol] land types, NamedTuple trees and trailing axes.
- The JAX package's ``test_heterogeneous_ltype.py`` batch (soil, ice
  sheet, wetland, crop at 65 N, 250 E, from January 1) in both packages in
  lockstep for 48 steps: with the reference-exact flags at 1e-10 with
  equal iteration counts, with the production flags at
  ``test_torch_scan.py``'s bounds (a column whose canopy count flips is
  named and left out from then on); and each of its columns against a
  one-column port run of its own class.
- The model's options: a per-column ``ltype`` of the wrong length and
  ``elm_correct_snow_aging`` without tables are refused; the landunit map
  of the card's landunits phase.

``test_torch_landunits_replay.py`` holds each landunit-dependent function
and the snow aging against the JAX package on a recorded winter step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_scan as tsc
import test_torch_step as ts
import torch_parity as tp
from elmkernels_torch import constants as tc
from elmkernels_torch.data import synthetic
from elmkernels_torch.utils.dates import Date as TDate
from elmkernels_tpu import constants as jc
from elmkernels_tpu.utils.dates import Date as JDate

torch.set_num_threads(1)

# one column of each landunit class the step runs
LTYPES5 = [tc.ISTSOIL, tc.ISTCROP, tc.ISTICE, tc.ISTICE_MEC, tc.ISTWET]
# the JAX package's tests/test_heterogeneous_ltype.py batch and site
LTYPES = [tc.ISTSOIL, tc.ISTICE, tc.ISTWET, tc.ISTCROP]
VTYPES = [12, 0, 0, 19]
SITE = dict(lat_deg=65.0, lon_deg=250.0)
NSTEPS = 48


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_landunits")
    pft, snicar = tp.write_files(d)
    aging = str(d / "snicar_drdt_synthetic.nc")
    synthetic.write_snow_aging_tables(aging)
    return pft, snicar, aging


# ---------------------------------------------------------------------------
# ltype_mask / lsel / lor
# ---------------------------------------------------------------------------

def _masks(ltype):
    """(JAX mask, port mask) of the soil/crop classes of ``ltype``."""
    if isinstance(ltype, int):
        return (jc.ltype_mask(jc.LandType(ltype=ltype), 1, 2),
                tc.ltype_mask(tc.LandType(ltype=ltype), 1, 2))
    lt = np.asarray(ltype)
    return (jc.ltype_mask(jc.LandType(ltype=jnp.asarray(lt)), 1, 2),
            tc.ltype_mask(tc.LandType(ltype=torch.as_tensor(lt)), 1, 2))


@pytest.mark.parametrize("ltype", [1, 2, 3, 6, LTYPES5, LTYPES])
def test_ltype_mask_matches_jax(ltype):
    jm, tm = _masks(ltype)
    if isinstance(ltype, int):
        assert type(tm) is bool and tm is jm
    else:
        assert tm.dtype == torch.bool
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("ltype", [1, 3, LTYPES5])
@pytest.mark.parametrize("static", [True, False])
def test_lor_matches_jax(ltype, static):
    jm, tm = _masks(ltype)
    jo, to = jc.lor(jm, static), tc.lor(tm, static)
    if isinstance(jo, bool):
        assert to is jo
    else:
        np.testing.assert_array_equal(tp.as_numpy(to), np.asarray(jo))


@pytest.mark.parametrize("ltype", [1, 3, LTYPES5])
def test_lsel_matches_jax_on_trees_and_trailing_axes(ltype):
    from elmkernels_torch.physics.canopy_hydrology import InterceptionOut
    jm, tm = _masks(ltype)
    rng = np.random.default_rng(7)
    n = len(LTYPES5)
    a = [rng.standard_normal((n,) + s) for s in ((), (3,), (3, 2))]
    b = [rng.standard_normal((n,) + s) for s in ((), (3,), (3, 2))]
    for x, y in zip(a, b):       # arrays, broadcast over trailing axes
        tp.assert_close(jc.lsel(jm, jnp.asarray(x), jnp.asarray(y)),
                        tc.lsel(tm, torch.as_tensor(x), torch.as_tensor(y)),
                        rtol=0.0, atol=0.0)
    # a NamedTuple tree, and a Python number on one side
    jt = [jnp.asarray(rng.standard_normal((n, 3))) for _ in range(6)]
    tt = [torch.as_tensor(np.array(v)) for v in jt]
    from elmkernels_tpu.physics.canopy_hydrology import \
        InterceptionOut as JInterceptionOut
    tp.assert_close(jc.lsel(jm, JInterceptionOut(*jt), JInterceptionOut(
        *jt[::-1])), tc.lsel(tm, InterceptionOut(*tt), InterceptionOut(
            *tt[::-1])), rtol=0.0, atol=0.0)
    tp.assert_close(jc.lsel(jm, jt[0], 0.5), tc.lsel(tm, tt[0], 0.5),
                    rtol=0.0, atol=0.0)


# ---------------------------------------------------------------------------
# the JAX package's heterogeneous batch, in lockstep
# ---------------------------------------------------------------------------

def _lockstep(files, flags, rtol, atol_of, ci_iters_gap, canopy_flips):
    """Both packages' models of the LTYPES batch advanced together from
    January 1, compared after every step as ``test_torch_scan._lockstep``
    compares them; returns (port model, the columns whose canopy count
    differed, by step, each column's largest |errh2o_led|)."""
    kw = dict(ltype=np.array(LTYPES), vtype=VTYPES, **SITE, **flags)
    jm = tp.jax_model(files[:2], len(LTYPES), **kw)
    tm = tp.torch_model(files[:2], len(LTYPES), **kw)
    assert tm.het_ltype and jm.het_ltype
    tp.assert_close(jm.state, tm.state)        # the per-column cold start
    jd, td = JDate.from_ymd(1985, 1, 1), TDate.from_ymd(1985, 1, 1)
    same = np.ones(len(LTYPES), bool)
    flips, ledger = {}, []
    for i in range(NSTEPS):
        jdg, tdg = jm.advance(jd), tm.advance(td)
        jd.increment_seconds(1800)
        td.increment_seconds(1800)
        agree = np.asarray(jdg.niters_canopy) == tdg.niters_canopy.numpy()
        if not agree.all():
            flips[i] = np.flatnonzero(~agree).tolist()
        assert (~agree).sum() <= canopy_flips, (i, agree)
        same &= agree
        ledger.append(tdg.errh2o_led.abs().numpy())
        gap = np.abs(tdg.niters_ci.numpy() - np.asarray(jdg.niters_ci))
        assert gap.max() <= ci_iters_gap, (i, gap)
        for kind, j, t in (("state", jm.state, tm.state),
                           ("diags", jdg, tdg)):
            for name in j._fields:
                if name in ("niters_ci", "niters_canopy"):
                    continue
                tp.assert_close(np.asarray(getattr(j, name))[same],
                                getattr(t, name)[torch.from_numpy(same)],
                                rtol, atol_of(name),
                                f"step {i} {kind}.{name}")
    return tm, flips, np.max(ledger, axis=0)


@pytest.fixture(scope="module")
def exact_lockstep(files):
    return _lockstep(files, ts.EXACT, tp.RTOL, ts.exact_atol, 0, 0)


def test_lockstep_against_jax_exact_flags(exact_lockstep):
    tm, flips, ledger = exact_lockstep
    assert not flips
    tg = tm.state.t_grnd.numpy()
    assert tg[1] < tg[0] - 1.0       # the ice sheet stays colder than soil
    # the closed water ledger holds on soil, ice and crop; the wetland
    # column reads the snow the reference deletes from warm wetland ground
    # (canopy_hydrology.snow_init), equal to the JAX package's (compared
    # above at test_torch_step.exact_atol)
    wet = np.array(LTYPES) == tc.ISTWET
    assert ledger[~wet].max() < 1e-9 and ledger[wet].max() > 1e-3


def test_lockstep_against_jax_production_flags(files):
    """The production flags' float32 interiors, at the global grid's
    bounds; a column whose canopy count flips is named in ``flips`` and
    left out from then on."""
    _, flips, _ = _lockstep(files, ts.PRODUCTION, tsc.PROD_RTOL_HETERO,
                         ts.prod_atol, ts.PROD_CI_ITERS_GAP, 1)
    print("canopy-count flips (step: columns):", flips)


def test_mixed_columns_match_homogeneous_runs(files, exact_lockstep):
    """Each column of the mixed batch against a one-column port run of its
    own class (the JAX package's test_mixed_ltype_columns_match_
    homogeneous_runs tolerance); the largest gap is printed."""
    tm = exact_lockstep[0]
    worst = (0.0, None)
    for i, (lt, vt) in enumerate(zip(LTYPES, VTYPES)):
        homo = tp.torch_model(files[:2], 1, ltype=int(lt), vtype=vt,
                              **SITE, **ts.EXACT)
        homo.run(TDate.from_ymd(1985, 1, 1), NSTEPS)
        for name in homo.state._fields:
            a = getattr(tm.state, name)[i:i + 1].double()
            b = getattr(homo.state, name).double()
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-8, err_msg=f"{name} col {i}")
            gap = float((a - b).abs().max())
            if gap >= worst[0]:
                worst = (gap, f"{name}, column {i}")
    print("largest gap, mixed against homogeneous:", worst)


# ---------------------------------------------------------------------------
# the model's options
# ---------------------------------------------------------------------------

def test_live_aging_needs_its_tables(files):
    """As in the JAX package, the live aging refuses to run on the
    placeholder tables."""
    from elmkernels_tpu.driver.model import Model as JModel
    with pytest.raises(ValueError, match="snow_aging_path"):
        tp.torch_model(files[:2], 2, elm_correct_snow_aging=True)
    with pytest.raises(ValueError, match="snow_aging_path"):
        JModel(ncol=2, pft_path=files[0], snicar_path=files[1],
               elm_correct_snow_aging=True)
    with pytest.raises(ValueError, match="ltype shape"):
        tp.torch_model(files[:2], 3, ltype=np.array(LTYPES))


def test_landunit_map_shares():
    """The landunit map of the card's landunits phase: shares, the ice
    sheet at the highest latitudes, reproducible from its seed."""
    lat = synthetic.land_latitudes(20000)
    lt = synthetic.landunit_map(lat, seed=3)
    share = {k: float(np.mean(lt == k)) for k in np.unique(lt)}
    assert set(share) == {tc.ISTSOIL, tc.ISTCROP, tc.ISTICE,
                          tc.ISTICE_MEC, tc.ISTWET}
    assert 0.82 < share[tc.ISTSOIL] < 0.86
    assert 0.09 < share[tc.ISTCROP] < 0.11
    assert 0.04 < share[tc.ISTWET] < 0.06
    ice = np.isin(lt, (tc.ISTICE, tc.ISTICE_MEC))
    assert ice.sum() == 200 and lat[ice].min() >= lat[~ice].max()
    np.testing.assert_array_equal(lt, synthetic.landunit_map(lat, seed=3))
    vt = synthetic.landunit_vtypes(np.full(lat.shape, 7), lt)
    assert (vt[ice | (lt == tc.ISTWET)] == 0).all()
    assert (vt[~ice & (lt != tc.ISTWET)] == 7).all()
