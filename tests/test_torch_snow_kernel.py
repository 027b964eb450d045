"""K5, the snow-hydrology block as one CUDA kernel
(``csrc/snow_hydrology.cu``), checked on the CPU: the source compiled as
plain C++ by the host compiler (its device code is inline functions; the
kernel and its launch sit under ``__CUDACC__``), driven column by column
through the same argument layout as on the card
(``ops.snow.kernel_inputs``), against

- the JAX package's ten functions of the block (``snow_water`` to
  ``snow_aging``/``snow_aging_pinned``, chained as its ``driver/step.py``
  chains them), on the inputs the JAX step gives them in one summer noon
  step and one winter step with snow layers (recorded under
  ``jax.disable_jit``, as ``test_torch_physics.py`` records them), in both
  aging modes;
- the port's plain block (``snow_hydrology_block_plain``) on seeded inputs
  (``ops.testing.snow_problem``: 0-5 layers, every branch of the block) at
  0, 1, 31, 33 and 4,000 columns, in both aging modes, float64 and
  float32, with per-column and 0-d deposition rates and an urban domain;

and the wrapper's layout (no copies: a 0-d rate goes with a stride of 0),
and the routing of ``physics.snow_hydrology.snow_hydrology_block``.

Tolerance.  float64: the golden tolerance (``torch_parity.RTOL``/``ATOL``,
rtol 1e-10 with a 1e-12 floor), with ``snl`` equal on every column.  Bit
for bit is for the card: PyTorch's CPU ``exp``, ``acos`` and ``pow``
round differently from the host's C library, and its CPU sums add in
another order.  float32: ``snl`` equal on at least 99.5 % of the columns
(a last-bit difference can move a layer across a threshold of combine or
divide), and on those columns every output within 1e-5 of the largest
magnitude of its field (measured on the 4,000 seeded columns: 1.8e-7 at
most, ``snl`` equal on every column).  Skips where no ``g++``
is installed.
"""

import ctypes
import functools
import inspect
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import torch_parity as tp
from elmkernels_torch import constants as tc
from elmkernels_torch.data.state import AERO_SPECIES
from elmkernels_torch.ops import snow, testing
from elmkernels_torch.physics import snow_hydrology as tsh
from test_torch_physics import EXACT, NCOL, _date, _port_value

torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "elmkernels_torch"
          / "csrc" / "snow_hydrology.cu")
N = 4000

# K5's column routine over every column in turn, on doubles and floats, and
# the kernel's layout sizes, for holding them against the wrapper's
HARNESS = r"""
#include "SOURCE"
#define PARAMS                                                              \
  long long n, const void* const* in, const long long* in_stride,          \
      const void* const* lay, const long long* lay_stride,                 \
      const void* snl, const void* do_capsnow, long long capsnow_stride,   \
      const void* imelt, long long imelt_stride, const void* soil_like,    \
      long long soil_like_stride, const void* soil_crop,                   \
      long long soil_crop_stride, const void* tau, const void* kappa,      \
      const void* drdt0, int n_t, int n_tgrd, int n_rhos, int nlevtot,     \
      double dtime, const double* consts, void* snl_out, void* const* out, \
      void* const* lay_out
#define ENTRY(NAME, T)                                                      \
  extern "C" void NAME(int elm, PARAMS) {                                  \
    const Args<T> A = make_args<T>(                                        \
        n, in, in_stride, lay, lay_stride, snl, do_capsnow,                \
        capsnow_stride, imelt, imelt_stride, soil_like, soil_like_stride,  \
        soil_crop, soil_crop_stride, tau, kappa, drdt0, n_t, n_tgrd,       \
        n_rhos, nlevtot, dtime, consts, snl_out, out, lay_out);            \
    for (long long i = 0; i < n; ++i) {                                    \
      if (elm) run_column<T, true>(A, i);                                  \
      else run_column<T, false>(A, i);                                     \
    }                                                                      \
  }
ENTRY(snow_host_f64, double)
ENTRY(snow_host_f32, float)
extern "C" void layout(int* out) {
  out[0] = kIn;
  out[1] = kLay;
  out[2] = kOut;
  out[3] = kLayOut;
  out[4] = kConsts;
}
"""


def build_host_lib(d: pathlib.Path):
    """K5's host build (HARNESS) in directory ``d``, loaded; skips where no
    ``g++`` is installed."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    (d / "harness.cpp").write_text(HARNESS.replace("SOURCE", str(SOURCE)))
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(d / "libharness.so"),
                    str(d / "harness.cpp")], check=True, timeout=300)
    lib = ctypes.CDLL(str(d / "libharness.so"))
    for name in ("snow_host_f64", "snow_host_f32"):
        getattr(lib, name).argtypes = snow.ARGTYPES[:-1]  # no stream
        getattr(lib, name).restype = None
    lib.layout.restype = None
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory.mktemp("snow_kernel"))


def host_block(lib, args: dict) -> tsh.SnowBlockOut:
    """K5's host build on ``snow_hydrology_block``'s arguments."""
    k = snow.kernel_inputs(args)
    outs = k.outputs()
    name = "snow_host_f64" if k.dtype == torch.float64 else "snow_host_f32"
    getattr(lib, name)(int(k.elm), *k.pointers(*outs))
    return k.result(*outs)


def _expanded(args: dict) -> dict:
    """The arguments with 0-d deposition rates expanded to [ncol], as the
    plain block takes them."""
    n = args["snl"].shape[0]
    aero = {k: v.expand(n) for k, v in args["aero_in"].items()}
    return dict(args, aero_in=aero)


def _as_dict(out: tsh.SnowBlockOut) -> dict:
    d = out._asdict()
    for k in ("mss", "cnc"):
        d.update({f"{k}_{s}": v for s, v in d.pop(k).items()})
    return d


def _assert_same(got, want):
    """Bit for bit: every field, NaNs in the same places."""
    g, w = _as_dict(got), _as_dict(want)
    for f in w:
        a, b = g[f], w[f]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b)), f
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        assert torch.equal(a, b), f


def _assert_f64_close(got, want, path):
    assert torch.equal(got.snl, want.snl), path
    tp.assert_close({k: tp.as_numpy(v) for k, v in _as_dict(want).items()},
                    {k: tp.as_numpy(v) for k, v in _as_dict(got).items()},
                    path=path)


def _assert_f32_close(got, want):
    """The module docstring's float32 tolerance."""
    same = got.snl == want.snl
    assert int(same.sum()) >= 0.995 * same.numel()
    g, w = _as_dict(got), _as_dict(want)
    for f in w:
        a, b = g[f][same], w[f][same]
        if not a.is_floating_point():
            assert torch.equal(a, b), f
            continue
        assert a.dtype == b.dtype == torch.float32, f
        assert torch.equal(torch.isnan(a), torch.isnan(b)), f
        fin = torch.isfinite(b)
        if not bool(fin.any()):
            continue
        err = float((a[fin] - b[fin]).abs().max())
        assert err <= 1e-5 * float(b[fin].abs().max()), (f, err)


def test_layout_matches_the_wrapper(host_lib):
    """The kernel's sizes are the wrapper's, and the wrapper hands the
    inputs over without copies: a 0-d deposition rate as itself with a
    stride of 0, each [ncol] input and each layered one as itself with its
    stride; the outputs are fresh tensors."""
    out = (ctypes.c_int * 5)()
    host_lib.layout(out)
    assert list(out) == [len(snow.IN_FIELDS), len(snow.LAYER_FIELDS),
                         len(snow.OUT_FIELDS), 7 + 2 * len(AERO_SPECIES),
                         len(snow.CONSTS)]
    assert set(snow.OUT_FIELDS) | {
        "snl", "t_soisno", "h2osoi_ice", "h2osoi_liq", "dz", "z", "zi",
        "snw_rds", "mss", "cnc"} == set(tsh.SnowBlockOut._fields)
    args = testing.snow_problem(64, 2, aero_scalar=True)
    k = snow.kernel_inputs(args)
    for name, t, stride in zip(snow.IN_FIELDS, k.fields, k.strides):
        v = (args["aero_in"][name[5:]] if name.startswith("aero_")
             else args[name])
        assert t.data_ptr() == v.data_ptr(), name
        assert stride == (0 if v.ndim == 0 else v.stride(0)), name
    layered = dict(args, **{"mss_" + s: v for s, v in args["mss"].items()})
    for name, t, stride in zip(snow.LAYER_FIELDS, k.layers, k.row_strides):
        assert t.data_ptr() == layered[name].data_ptr(), name
        assert stride == layered[name].stride(0), name
    assert k.snl.data_ptr() == args["snl"].data_ptr()
    assert k.imelt.data_ptr() == args["imelt"].data_ptr()
    # a view of a wider layer array reads as the same values
    wide = torch.cat([args["swe_old"], args["swe_old"]], 1)[:, :5]
    assert wide.stride(0) == 10
    got = host_block(host_lib, dict(args, swe_old=wide))
    _assert_same(got, host_block(host_lib, args))
    # no input is written
    before = {k: v.clone() for k, v in layered.items()
              if isinstance(v, torch.Tensor)}
    host_block(host_lib, args)
    for name, v in before.items():
        assert torch.equal(v, layered[name]), name


# ---- against the JAX package's functions -----------------------------------

# the JAX functions whose calls hold the block's inputs, by module
_RECORDED = {"snow_hydrology": ("snow_water", "compute_aerosol_deposition",
                                "snow_compaction", "combine_layers",
                                "update_aerosol_mass_and_concen"),
             "canopy_hydrology": ("ground_flux",),
             "soil_temperature": ("phase_change_soisno",)}


@pytest.fixture(scope="module")
def jax_blocks(tmp_path_factory):
    """The block's arguments in a winter step with snow layers and a summer
    noon step of the JAX model (4 columns, the exact flags), as numpy:
    [(phase, JAX LandType, {argument: value})]."""
    import importlib
    import jax
    from test_torch_physics import _to_numpy
    files = tp.write_files(tmp_path_factory.mktemp("snow_kernel_jax"))
    from elmkernels_tpu.utils.dates import Date as JDate
    winter = tp.jax_model(files, NCOL, **EXACT)
    winter.run(JDate.from_ymd(1985, 1, 1), 700)
    assert int(np.asarray(winter.state.snl).max()) > 0
    summer = tp.jax_model(files, NCOL, **EXACT)
    summer.run(JDate.from_ymd(1985, 7, 1), 24)
    blocks = []
    for phase, model, date in (("winter", winter, _date(1, 700)),
                               ("summer", summer, _date(7, 24))):
        calls, patched = {}, []
        for mod_name, names in _RECORDED.items():
            mod = importlib.import_module(f"elmkernels_tpu.physics."
                                          f"{mod_name}")
            for name in names:
                f = getattr(mod, name)

                def wrapped(*a, f=f, name=name, **kw):
                    out = f(*a, **kw)
                    bound = inspect.signature(f).bind(*a, **kw).arguments
                    calls.setdefault(name, (dict(bound), out))
                    return out
                patched.append((mod, name, f))
                setattr(mod, name, wrapped)
        try:
            with jax.disable_jit():
                model.advance(date)
        finally:
            for mod, name, f in patched:
                setattr(mod, name, f)
        calls = _to_numpy(calls)
        sw, _ = calls["snow_water"]
        dep, _ = calls["compute_aerosol_deposition"]
        comp, _ = calls["snow_compaction"]
        cb, _ = calls["combine_layers"]
        upd, _ = calls["update_aerosol_mass_and_concen"]
        _, gf = calls["ground_flux"]
        _, pc2 = calls["phase_change_soisno"]
        st = cb["st"]
        p = model.params
        args = dict(
            dtime=sw["dtime"], do_capsnow=sw["do_capsnow"], snl=sw["snl"],
            frac_sno_eff=sw["frac_sno_eff"], frac_sno=sw["frac_sno"],
            h2osno=sw["h2osno"], snow_depth=cb["snow_depth"],
            int_snow=sw["int_snow"], qflx_sub_snow=sw["qflx_sub_snow"],
            qflx_evap_grnd=sw["qflx_evap_grnd"],
            qflx_dew_snow=sw["qflx_dew_snow"],
            qflx_dew_grnd=sw["qflx_dew_grnd"],
            qflx_rain_grnd=sw["qflx_rain_grnd"],
            qflx_snomelt=sw["qflx_snomelt"],
            qflx_snow_melt=sw["qflx_snow_melt"],
            h2osoi_liq=sw["h2osoi_liq"], h2osoi_ice=sw["h2osoi_ice"],
            t_soisno=comp["t_soisno"], dz=sw["dz"], z=st.z, zi=st.zi,
            mss=sw["mss"], aero_in=dep["aero_in"], n_melt=comp["n_melt"],
            imelt=comp["imelt"], swe_old=comp["swe_old"],
            frac_iceold=comp["frac_iceold"], snw_rds=st.rds,
            qflx_snwcp_ice=upd["qflx_snwcp_ice"],
            qflx_snow_grnd=np.asarray(gf.qflx_snow_grnd),
            qflx_snofrz_lyr=np.asarray(pc2.qflx_snofrz_lyr),
            snowage_tau=np.asarray(p.snowage_tau),
            snowage_kappa=np.asarray(p.snowage_kappa),
            snowage_drdt0=np.asarray(p.snowage_drdt0))
        # the recorded inputs are the step's: the layer state compaction
        # and combine saw is the one snow_water was given
        np.testing.assert_array_equal(comp["snl"], args["snl"])
        blocks.append((phase, sw["land"], args))
    return blocks


def _jax_block(land, a: dict, elm: bool) -> tsh.SnowBlockOut:
    """The JAX package's block: its ten functions chained as its
    ``driver/step.py`` chains them, on the CPU under ``jax.disable_jit``,
    as the port's ``SnowBlockOut`` of numpy arrays."""
    import jax
    import jax.numpy as jnp
    from elmkernels_tpu.physics import snow_hydrology as sh
    with jax.disable_jit():
        a = jax.tree_util.tree_map(jnp.asarray, a)
        snl, dtime, fse = a["snl"], float(a["dtime"]), a["frac_sno_eff"]
        sw = sh.snow_water(
            land, a["do_capsnow"], snl, dtime, fse, a["h2osno"],
            a["qflx_sub_snow"], a["qflx_evap_grnd"], a["qflx_dew_snow"],
            a["qflx_dew_grnd"], a["qflx_rain_grnd"], a["qflx_snomelt"],
            a["qflx_snow_melt"], a["int_snow"], a["frac_sno"],
            a["h2osoi_liq"], a["h2osoi_ice"], a["mss"], a["dz"])
        mss = sh.compute_aerosol_deposition(dtime, snl, a["aero_in"], sw.mss)
        bcphi, bcpho = sh.aerosol_phase_change(
            snl, dtime, a["qflx_sub_snow"], sw.h2osoi_liq, sw.h2osoi_ice,
            mss["bcphi"], mss["bcpho"])
        mss = dict(mss, bcphi=bcphi, bcpho=bcpho)
        dz = sh.snow_compaction(land, snl, dtime, sw.int_snow, a["n_melt"],
                                sw.frac_sno, a["imelt"], a["swe_old"],
                                sw.h2osoi_liq, sw.h2osoi_ice, a["t_soisno"],
                                a["frac_iceold"], sw.dz)
        st = sh.SnowState(snl, a["t_soisno"], sw.h2osoi_ice, sw.h2osoi_liq,
                          a["snw_rds"], mss, dz, a["z"], a["zi"])
        cb = sh.combine_layers(land, dtime, st, a["h2osno"],
                               a["snow_depth"], fse, sw.frac_sno,
                               sw.int_snow)
        nolyr = snl == 0
        cb = cb._replace(
            h2osno=jnp.where(nolyr, a["h2osno"], cb.h2osno),
            snow_depth=jnp.where(nolyr, a["snow_depth"], cb.snow_depth),
            frac_sno=jnp.where(nolyr, sw.frac_sno, cb.frac_sno),
            frac_sno_eff=jnp.where(nolyr, fse, cb.frac_sno_eff),
            int_snow=jnp.where(nolyr, sw.int_snow, cb.int_snow),
            qflx_sl_top_soil=jnp.where(nolyr, 0.0, cb.qflx_sl_top_soil),
            qflx_snow2topsoi=jnp.where(nolyr, 0.0, cb.qflx_snow2topsoi),
            mflx_snowlyr_col=jnp.where(nolyr, 0.0, cb.mflx_snowlyr_col))
        st = sh.divide_layers(cb.frac_sno, cb.state)
        st = sh.prune_snow_layers(st)
        mss2, cnc = sh.update_aerosol_mass_and_concen(
            dtime, st.snl, a["do_capsnow"], a["qflx_snwcp_ice"], st.ice,
            st.liq, st.mss)
        if elm:
            rds = sh.snow_aging(
                a["do_capsnow"], st.snl, cb.frac_sno, dtime,
                a["qflx_snwcp_ice"], a["qflx_snow_grnd"], cb.h2osno, st.dz,
                st.liq, st.ice, st.t, a["qflx_snofrz_lyr"],
                a["snowage_tau"], a["snowage_kappa"], a["snowage_drdt0"],
                st.rds, elm_correct_clamp=True)
        else:
            rds = sh.snow_aging_pinned(st.snl, cb.h2osno, st.rds)
        out = tsh.SnowBlockOut(
            st.snl, st.t, st.ice, st.liq, st.dz, st.z, st.zi, rds, mss2, cnc,
            cb.h2osno, cb.snow_depth, cb.frac_sno, cb.frac_sno_eff,
            cb.int_snow, sw.qflx_snow_melt, sw.qflx_top_soil,
            cb.qflx_sl_top_soil, cb.qflx_snow2topsoi, cb.mflx_snowlyr_col,
            sw.mflx_neg_snow)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("elm", [False, True], ids=["pinned", "elm"])
def test_host_build_matches_jax_on_the_recorded_step(host_lib, jax_blocks,
                                                     elm):
    """The block's inputs in the JAX step through K5's host build: equal to
    the JAX package's ten functions and to the port's plain block at the
    golden tolerance, with equal layer counts, in both aging modes (the
    recorded runs age with the pinned radius; ELM's aging runs on the same
    inputs)."""
    for phase, jland, a in jax_blocks:
        want = _jax_block(jland, a, elm)
        args = _port_value(dict(a, land=jland), False)
        args["elm_correct_snow_aging"] = elm
        got = host_block(host_lib, args)
        tp.assert_close({k: np.asarray(v) for k, v in
                         _as_dict(want).items()},
                        {k: tp.as_numpy(v) for k, v in _as_dict(got).items()},
                        path=f"{phase} host K5 vs JAX")
        plain = tsh.snow_hydrology_block_plain(**args)
        _assert_f64_close(got, plain, f"{phase} host K5 vs plain")
    winter = jax_blocks[0][2]
    assert int(np.asarray(winter["snl"]).max()) > 0  # live layers


@functools.lru_cache(maxsize=None)
def _plain(n, dtype, elm, aero_scalar=False, urbpoi=False, seed=7):
    """A seeded problem and the plain block's result on it (shared by the
    tests; neither is modified)."""
    args = testing.snow_problem(n, seed, dtype, elm, aero_scalar, urbpoi)
    return args, tsh.snow_hydrology_block_plain(**_expanded(args))


@pytest.mark.parametrize("elm", [False, True], ids=["pinned", "elm"])
@pytest.mark.parametrize("n", [0, 1, 31, 33, N])
def test_host_build_matches_plain_f64(host_lib, n, elm):
    args, want = _plain(n, torch.float64, elm)
    got = host_block(host_lib, args)
    _assert_f64_close(got, want, f"n={n} host K5 vs plain")
    assert got.snl.shape == (n,) and got.zi.shape == (n, tc.NLEVTOT + 1)


@pytest.mark.parametrize("variant", ["aero_scalar", "urbpoi"])
@pytest.mark.parametrize("elm", [False, True], ids=["pinned", "elm"])
def test_host_build_matches_plain_variants(host_lib, variant, elm):
    """0-d deposition rates (read with a stride of 0; the plain block takes
    them expanded) and an urban domain, where every column is soil-like."""
    args, want = _plain(N, torch.float64, elm, **{variant: True})
    got = host_block(host_lib, args)
    _assert_f64_close(got, want, f"{variant} host K5 vs plain")
    if variant == "aero_scalar":
        _assert_same(got, host_block(host_lib, _expanded(args)))


@pytest.mark.parametrize("elm", [False, True], ids=["pinned", "elm"])
def test_host_build_matches_plain_f32(host_lib, elm):
    args, want = _plain(N, torch.float32, elm)
    got = host_block(host_lib, args)
    assert got.h2osno.dtype == torch.float32
    _assert_f32_close(got, want)


def test_problem_reaches_every_branch():
    """What ``snow_problem`` promises, read off the plain block's result:
    every layer count before and after, packs that lose layers (merged or
    dissolved) and that gain them (divided, up to 5), layerless packs,
    negative liquid exported, a bottom layer merged into the soil and a
    dissolved pack's liquid handed to it, capped snow, ELM aging that
    moves the radius inside [SNW_RDS_MIN, SNW_RDS_MAX]."""
    args, out = _plain(N, torch.float64, True)
    snl0, snl1 = args["snl"], out.snl
    assert set(snl0.tolist()) == set(snl1.tolist()) == set(range(6))
    assert bool((snl1 < snl0).any()) and bool((snl1 > snl0).any())
    assert bool(((snl0 > 1) & (snl1 == 0)).any())
    assert bool(((snl0 == 0) & (args["h2osno"] > 0)).any())
    assert bool((out.mflx_neg_snow != 0).any())
    assert bool((out.qflx_sl_top_soil != 0).any())
    assert bool((out.qflx_snow2topsoi != 0).any())
    assert bool((args["do_capsnow"] != 0).any())
    live = out.snw_rds[snl1 > 0]
    assert bool(((live > tc.SNW_RDS_MIN) & (live < tc.SNW_RDS_MAX)).any())
    lt = args["land"].ltype
    for t in (tc.ISTSOIL, tc.ISTCROP, tc.ISTICE, tc.ISTWET, tc.ISTURB_MIN):
        assert bool((lt == t).any())


def test_routing(monkeypatch):
    """``snow_hydrology_block`` routes by rule: CUDA tensors that carry no
    tangent to K5, CPU tensors and differentiated calls
    (``torch.func.jvp``) to the plain block.  The device test is stubbed
    so that CPU tensors count as the card's; K5 is replaced by a spy."""
    args, want = _plain(16, torch.float64, False)
    assert not tsh.uses_kernel(args)     # CPU tensors: the plain block
    monkeypatch.setattr(tsh, "_on_card", lambda t: True)
    calls = []

    def spy(**kw):
        calls.append(kw)
        return tsh.snow_hydrology_block_plain(**kw)
    monkeypatch.setattr(snow, "snow_hydrology", spy)
    out = tsh.snow_hydrology_block(**args)
    assert len(calls) == 1
    _assert_same(out, want)

    def run(h2osno):
        return tsh.snow_hydrology_block(**dict(args, h2osno=h2osno)).h2osno
    h, dh = torch.func.jvp(run, (args["h2osno"],),
                           (torch.ones_like(args["h2osno"]),))
    assert len(calls) == 1               # the tangent went to the plain block
    assert torch.equal(h, want.h2osno)
    assert bool((dh != 0).any())
    # a differentiated species mass routes the same way
    mss = dict(args["mss"], dst1=args["mss"]["dst1"].clone()
               .requires_grad_())
    assert not tsh.uses_kernel(dict(args, mss=mss))
    assert tsh.uses_kernel(args)


def test_wrapper_refuses_cpu_tensors():
    args, _ = _plain(4, torch.float64, False)
    with pytest.raises(ValueError, match="CUDA"):
        snow.snow_hydrology(**args)
