"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card.  The
module imports neither JAX nor the JAX package, so that it runs on a
machine that has only PyTorch; there, from the root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels.py
"""

import pytest
import torch

from elmkernels_torch.ops import testing
from elmkernels_torch.physics import photosynthesis as tpsn
from elmkernels_torch.physics import soil_temperature as tst

N = 4096


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels run only "
                    "there; chip_smoke.py runs these comparisons too)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,dtype", [("c3", torch.float64),
                                        ("c4", torch.float64),
                                        ("mixed", torch.float64),
                                        ("c3", torch.float32),
                                        ("mixed", torch.float32)])
def test_ci_kernel_matches_plain(card, mode, dtype):
    from elmkernels_torch.ops.ci_solver import ci_hybrid_solve
    x0, env, en = testing.ci_problem_tensors(N, 11, mode, dtype, card)
    ck, ok, ik = ci_hybrid_solve(x0, env, mode, en)
    cp, op, ip = tpsn.hybrid_solve_plain(x0, env, mode, en)
    torch.testing.assert_close(ik, ip, rtol=0, atol=0)
    torch.testing.assert_close(ck, cp, rtol=1e-12, atol=0, equal_nan=True)
    for a, b in zip(ok, op):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0, equal_nan=True)


# odd and even counts below, at and past the kernel's 32-column tile, the
# winter path's and the main path's widths; an offset of 1 makes lhs and rhs
# views one column into their storage, off 16-byte alignment
PDMA_CASES = [(n, 0) for n in (1, 2, 3, 63, 64, 65, 8192, 8193, 262144,
                               262145)] + [(65, 1), (262144, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("ncol,offset", PDMA_CASES)
def test_pdma_kernel_matches_plain(card, ncol, offset):
    """Bit for bit: the kernel runs the plain version's operations in its
    order, without contracted multiply-adds."""
    from elmkernels_torch.ops.pdma import pdma_solve
    lhs, rhs = testing.pdma_problem(ncol + offset, 5)
    lhs, rhs = torch.tensor(lhs, device=card), torch.tensor(rhs, device=card)
    lhs, rhs = lhs[offset:], rhs[offset:]
    assert (lhs.data_ptr() % 16 != 0) == bool(offset)
    torch.testing.assert_close(pdma_solve(lhs, rhs),
                               tst.pdma_solve_plain(lhs, rhs), rtol=0,
                               atol=0)


@pytest.mark.cuda
def test_pdma_kernel_matches_plain_on_ice_sheet_systems(card, tmp_path,
                                                       monkeypatch):
    """Bit for bit on the systems soil_temperature assembles for ice-sheet
    and wetland columns (ice- or water-filled heat capacity and
    conductivity, no supercooled water), captured from one January step
    of a mixed CPU batch."""
    from elmkernels_torch import constants as tc
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.ops.pdma import pdma_solve
    from elmkernels_torch.utils.dates import Date
    synthetic.write_clm_params(tmp_path / "p.nc")
    synthetic.write_snicar_optics(tmp_path / "s.nc")
    seen = []

    def capture(lhs, rhs):
        seen.append((lhs.clone(), rhs.clone()))
        return tst.pdma_solve_plain(lhs, rhs)
    monkeypatch.setattr(tst, "pdma_solve", capture)
    ltype = [tc.ISTICE, tc.ISTICE_MEC, tc.ISTWET, tc.ISTSOIL] * 16
    vtype = [0, 0, 0, 12] * 16
    m = Model(ncol=len(ltype), ltype=ltype, vtype=vtype,
              pft_path=str(tmp_path / "p.nc"),
              snicar_path=str(tmp_path / "s.nc"), device="cpu")
    m.advance(Date.from_ymd(1985, 1, 1))
    lhs, rhs = (t.to(card) for t in seen[0])
    torch.testing.assert_close(pdma_solve(lhs, rhs),
                               tst.pdma_solve_plain(lhs, rhs), rtol=0,
                               atol=0)


def _assert_tangent_kernel_is_plain(card, mode, n, dry_share, seed=13,
                                    view=slice(None)):
    from elmkernels_torch.ops.ci_solver import ci_hybrid_solve_jvp
    x0, env, en = testing.ci_problem_tensors(n, seed, mode, torch.float64,
                                             card, dry_share=dry_share)
    dx0, denv = testing.ci_tangents(x0, env, seed + 4)
    x0, dx0, en = x0[view], dx0[view], en[view]
    env = tpsn.CiEnv(*(v[view] for v in env))
    denv = tpsn.CiEnv(*(v[view] for v in denv))
    ck, ok, ik, dck, dok = ci_hybrid_solve_jvp(x0, dx0, env, denv, mode, en)
    cp, op, ip, dcp, dop = tpsn.hybrid_solve_jvp_plain(x0, dx0, env, denv,
                                                       mode, en)
    torch.testing.assert_close(ik, ip, rtol=0, atol=0)
    for a, b in zip((ck, *ok, dck, *dok), (cp, *op, dcp, *dop)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dry_share", [0.25, 1.0])
@pytest.mark.parametrize("n", [2 * 65536, 2 * 262144])
@pytest.mark.parametrize("mode", ["c3", "c4", "mixed"])
def test_ci_tangent_kernel_matches_plain(card, mode, n, dry_share):
    """K1-T against torch.func.jvp of the plain solve on 2 x 65,536 and
    the sensitivity path's 2 x 262,144 leaves, a quarter or all of them
    dry-air leaves: values and tangents bit for bit (NaNs where the plain
    version has them) with equal iteration counts."""
    _assert_tangent_kernel_is_plain(card, mode, n, dry_share)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_ci_tangent_kernel_edges(card, n):
    """K1-T's chunks of 32 leaves: counts that leave a part chunk, fewer
    leaves than a warp's lanes, and views one leaf into their storage
    (``enabled`` off 4-byte alignment), bit for bit."""
    _assert_tangent_kernel_is_plain(card, "mixed", n, 0.25)
    _assert_tangent_kernel_is_plain(card, "mixed", n + 1, 0.25,
                                    view=slice(1, None))


@pytest.mark.cuda
def test_ci_tangent_kernel_on_two_streams(card):
    """Two K1-T launches that may overlap, one on each of two streams:
    each launch claims its chunks from its own counters, so both are bit
    for bit with the plain jvp, and each counts its own warps' steps."""
    from elmkernels_torch.ops.ci_solver import ci_hybrid_solve_jvp
    probs = []
    for seed in (21, 23):
        x0, env, en = testing.ci_problem_tensors(2 * 65536, seed, "mixed",
                                                 torch.float64, card,
                                                 dry_share=0.25)
        dx0, denv = testing.ci_tangents(x0, env, seed + 4)
        probs.append((x0, dx0, env, denv, "mixed", en))
    streams = [torch.cuda.Stream(card) for _ in probs]
    scheds = [torch.zeros(2, dtype=torch.int64, device=card) for _ in probs]
    torch.cuda.synchronize(card)
    got = []
    for args, stream, sched in zip(probs, streams, scheds):
        with torch.cuda.stream(stream):
            got.append(ci_hybrid_solve_jvp(*args, sched=sched))
    torch.cuda.synchronize(card)
    for args, (ck, ok, ik, dck, dok), sched in zip(probs, got, scheds):
        cp, op, ip, dcp, dop = tpsn.hybrid_solve_jvp_plain(*args)
        torch.testing.assert_close(ik, ip, rtol=0, atol=0)
        for a, b in zip((ck, *ok, dck, *dok), (cp, *op, dcp, *dop)):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        assert int(sched[1]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ncol", sorted({n for n, _ in PDMA_CASES}))
def test_pdma_tangent_rule_matches_plain(card, ncol):
    """PdmaSolve's jvp (K4 twice) against torch.func.jvp through the plain
    elimination."""
    from elmkernels_torch.ops import pdma
    lhs, rhs = testing.pdma_problem(ncol, 5)
    lhs, rhs = torch.tensor(lhs, device=card), torch.tensor(rhs, device=card)
    g = torch.Generator(device=card).manual_seed(0)
    dl = torch.randn(lhs.shape, generator=g, dtype=lhs.dtype,
                     device=card) * (lhs != 0)
    dr = torch.randn(rhs.shape, generator=g, dtype=rhs.dtype, device=card)
    before = pdma.pdma_solve.launches
    xk, tk = torch.func.jvp(pdma.PdmaSolve.apply, (lhs, rhs), (dl, dr))
    assert pdma.pdma_solve.launches - before == 2
    xp, tpl = torch.func.jvp(tst.pdma_solve_plain, (lhs, rhs), (dl, dr))
    torch.testing.assert_close(xk, xp, rtol=0, atol=0)
    torch.testing.assert_close(tk, tpl, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
def test_wrappers_refuse_tangent_tensors(card):
    """A kernel wrapper handed a differentiated tensor raises and names
    the Function to call, instead of dropping the tangent."""
    import torch.autograd.forward_ad as fwAD
    from elmkernels_torch.ops.ci_solver import ci_hybrid_solve
    from elmkernels_torch.ops.pdma import pdma_solve
    x0, env, en = testing.ci_problem_tensors(64, 0, "c3", torch.float64,
                                             card)
    with pytest.raises(RuntimeError, match="CiSolve"):
        torch.func.jvp(lambda x: ci_hybrid_solve(x, env, "c3", en)[0],
                       (x0,), (torch.ones_like(x0),))
    lhs, rhs = (torch.tensor(a, device=card)
                for a in testing.pdma_problem(64, 0))
    with fwAD.dual_level(), pytest.raises(RuntimeError, match="PdmaSolve"):
        pdma_solve(lhs, fwAD.make_dual(rhs, torch.ones_like(rhs)))
    with pytest.raises(RuntimeError, match="PdmaSolve"):
        pdma_solve(lhs.clone().requires_grad_(), rhs)


@pytest.mark.cuda
def test_ci_function_jvp_on_card(card):
    """torch.func.jvp through CiSolve on the card: its forward launches
    K1, its jvp K1-T, and the tangents equal the plain version's."""
    from elmkernels_torch.ops import ci_solver
    x0, env, en = testing.ci_problem_tensors(4096, 19, "mixed",
                                             torch.float64, card)
    dx0, denv = testing.ci_tangents(x0, env, 23)
    k1, k1t = (ci_solver.ci_hybrid_solve.launches,
               ci_solver.ci_hybrid_solve_jvp.launches)
    out, tan = torch.func.jvp(
        lambda x, *e: ci_solver.CiSolve.apply("mixed", x, en, *e),
        (x0, *env), (dx0, *denv))
    assert ci_solver.ci_hybrid_solve.launches == k1 + 1
    assert ci_solver.ci_hybrid_solve_jvp.launches == k1t + 1
    cp, op, ip, dcp, dop = tpsn.hybrid_solve_jvp_plain(x0, dx0, env, denv,
                                                       "mixed", en)
    torch.testing.assert_close(out[-1], ip, rtol=0, atol=0)
    for a, b in zip((*out[:-1], *tan[:-1]), (cp, *op, dcp, *dop)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("ncol,offset", PDMA_CASES)
def test_pdma_f32_kernel_matches_plain(card, ncol, offset):
    """K4 in float32, bit for bit: the same operations in the same order,
    each rounded to float32, as the plain version run in float32.  A
    one-column offset (420 B, 84 B) is off 16-byte alignment too."""
    from elmkernels_torch.ops.pdma import pdma_solve_f32
    lhs, rhs = testing.pdma_problem(ncol + offset, 5)
    lhs = torch.tensor(lhs, device=card, dtype=torch.float32)[offset:]
    rhs = torch.tensor(rhs, device=card, dtype=torch.float32)[offset:]
    assert (lhs.data_ptr() % 16 != 0) == bool(offset)
    torch.testing.assert_close(pdma_solve_f32(lhs, rhs),
                               tst.pdma_solve_plain(lhs, rhs), rtol=0,
                               atol=0)


@pytest.mark.cuda
def test_pdma_function_dispatches_by_dtype(card):
    """The step's entry point launches the float32 kernel for float32
    systems and the float64 one for float64; its tangent rule refuses
    float32."""
    from elmkernels_torch.ops import pdma
    lhs, rhs = testing.pdma_problem(4096, 9)
    for dtype, wrapper in ((torch.float32, pdma.pdma_solve_f32),
                           (torch.float64, pdma.pdma_solve)):
        lt = torch.tensor(lhs, device=card, dtype=dtype)
        rt = torch.tensor(rhs, device=card, dtype=dtype)
        before = wrapper.launches
        x = pdma.solve(lt, rt)
        assert wrapper.launches == before + 1 and x.dtype == dtype
        torch.testing.assert_close(x, tst.pdma_solve_plain(lt, rt), rtol=0,
                                   atol=0)
    lt = torch.tensor(lhs, device=card, dtype=torch.float32)
    rt = torch.tensor(rhs, device=card, dtype=torch.float32)
    with pytest.raises(TypeError, match="float64"):
        torch.func.jvp(pdma.PdmaSolve.apply, (lt, rt),
                       (torch.zeros_like(lt), torch.ones_like(rt)))


def _same(a, b) -> bool:
    """Equal bit for bit, NaNs in the same places."""
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a, 0.0),
                                torch.nan_to_num(b, 0.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [N, 4001, 31, 1])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["c3", "c4", "mixed"])
def test_canopy_kernel_matches_plain(card, mode, dtype, warm, n):
    """K2 against the plain loop at atol 0: every output, the iteration
    counts and the ci carry, NaNs in the same places; at a multiple of the
    warp's 32 columns, past one and below one; and a second launch on the
    same inputs equal to the first bit for bit."""
    from elmkernels_torch.ops import canopy
    from elmkernels_torch.physics import canopy_fluxes as tcf
    args = testing.canopy_problem(n, 13, mode, dtype, warm, device=card)
    got = canopy.canopy_stability(**args)
    again = canopy.canopy_stability(**args)
    want = tcf.stability_iteration_plain(**args)
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert _same(a, b), f
        assert _same(a, getattr(again, f)), f


@pytest.mark.cuda
def test_canopy_kernel_on_two_streams(card):
    """Two K2 launches that may overlap, one on each of two streams: each
    claims its chunks from its own counters, so both are bit for bit with
    the plain loop."""
    from elmkernels_torch.ops import canopy
    from elmkernels_torch.physics import canopy_fluxes as tcf
    probs = [testing.canopy_problem(65536, seed, "mixed", torch.float64,
                                    False, device=card) for seed in (13, 19)]
    streams = [torch.cuda.Stream(card) for _ in probs]
    torch.cuda.synchronize(card)
    got = []
    for args, stream in zip(probs, streams):
        with torch.cuda.stream(stream):
            got.append(canopy.canopy_stability(**args))
    torch.cuda.synchronize(card)
    for args, out in zip(probs, got):
        want = tcf.stability_iteration_plain(**args)
        for f in out._fields:
            assert _same(getattr(out, f), getattr(want, f)), f


@pytest.mark.cuda
def test_canopy_dispatch_on_card(card):
    """On the card ``stability_iteration`` launches K2 once and no K1;
    under ``torch.func.jvp`` it runs the plain loop (K1 and K1-T), and a
    differentiated tensor handed to K2's wrapper raises."""
    from elmkernels_torch.ops import canopy, ci_solver
    from elmkernels_torch.physics import canopy_fluxes as tcf
    args = testing.canopy_problem(1024, 17, "mixed", torch.float64,
                                  device=card)
    k1 = ci_solver.ci_hybrid_solve.launches
    k2 = canopy.canopy_stability.launches
    tcf.stability_iteration(**args)
    assert canopy.canopy_stability.launches == k2 + 1
    assert ci_solver.ci_hybrid_solve.launches == k1
    k1t = ci_solver.ci_hybrid_solve_jvp.launches
    torch.func.jvp(
        lambda t: tcf.stability_iteration(**dict(args, t_veg=t)).t_veg,
        (args["t_veg"],), (torch.ones_like(args["t_veg"]),))
    assert canopy.canopy_stability.launches == k2 + 1
    assert ci_solver.ci_hybrid_solve.launches > k1
    assert ci_solver.ci_hybrid_solve_jvp.launches > k1t
    with pytest.raises(RuntimeError, match="stability_iteration"):
        canopy.canopy_stability(**dict(
            args, t_veg=args["t_veg"].clone().requires_grad_()))


# ---- K5, the snow-hydrology block -------------------------------------------


def _snow_fields(out) -> dict:
    d = out._asdict()
    for k in ("mss", "cnc"):
        d.update({f"{k}_{s}": v for s, v in d.pop(k).items()})
    return d


def _plain_snow_args(args: dict) -> dict:
    n = args["snl"].shape[0]
    return dict(args, aero_in={k: v.expand(n)
                               for k, v in args["aero_in"].items()})


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rows", "views", "interleaved"])
@pytest.mark.parametrize("n", [N, 4001, 129, 127, 33, 31, 1])
@pytest.mark.parametrize("aero_scalar", [False, True],
                         ids=["aero_col", "aero_0d"])
@pytest.mark.parametrize("elm", [False, True], ids=["pinned", "elm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_snow_kernel_matches_plain(card, dtype, elm, aero_scalar, n, layout):
    """K5 against the plain block at atol 0: every output, NaNs in the same
    places (0-d deposition rates against the plain block on them
    expanded); and a second launch on the same inputs equal to the first
    bit for bit.  Widths around K5's 128-column blocks (127, 129, 4001);
    the layered inputs as fresh rows, as views of wider arrays (a row
    stride twice the width: ``testing.snow_layers_as_views``), or the
    columns reordered so that every warp mixes packs of 0-5 layers
    (``testing.snow_columns_interleaved``)."""
    from elmkernels_torch.ops import snow
    from elmkernels_torch.physics import snow_hydrology as tsh
    args = testing.snow_problem(n, 13, dtype, elm, aero_scalar, device=card)
    if layout == "views":
        args = testing.snow_layers_as_views(args)
    elif layout == "interleaved":
        args = testing.snow_columns_interleaved(args)
    got = _snow_fields(snow.snow_hydrology(**args))
    again = _snow_fields(snow.snow_hydrology(**args))
    want = _snow_fields(tsh.snow_hydrology_block_plain(
        **_plain_snow_args(args)))
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        assert _same(got[f], want[f]), f
        assert _same(got[f], again[f]), f


@pytest.mark.cuda
def test_snow_kernel_captured_and_replayed(card):
    """A K5 call captured in a CUDA graph and replayed on new inputs
    written into the captured ones: equal to an eager call on those
    inputs bit for bit; the capture counts one launch, as a replay adds
    through the step's graphs."""
    from elmkernels_torch.ops import snow
    from elmkernels_torch.physics import snow_hydrology as tsh
    args = testing.snow_problem(N, 21, torch.float64, True, device=card)
    other = testing.snow_problem(N, 22, torch.float64, True, device=card)
    snow.snow_hydrology(**args)          # built and warm
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        snow.snow_hydrology(**args)
    torch.cuda.current_stream(card).wait_stream(side)
    before = snow.snow_hydrology.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = snow.snow_hydrology(**args)
    assert snow.snow_hydrology.launches == before + 1
    for k, v in args.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            v.copy_(other[k])
        elif isinstance(v, dict):
            for s, t in v.items():
                t.copy_(other[k][s])
    graph.replay()
    torch.cuda.synchronize(card)
    want = _snow_fields(tsh.snow_hydrology_block_plain(**args))
    got = _snow_fields(captured)
    for f in want:
        assert _same(got[f], want[f]), f


@pytest.mark.cuda
def test_snow_dispatch_on_card(card):
    """On the card ``snow_hydrology_block`` launches K5 once; under
    ``torch.func.jvp`` it runs the plain block, and a differentiated
    tensor handed to K5's wrapper raises."""
    from elmkernels_torch.ops import snow
    from elmkernels_torch.physics import snow_hydrology as tsh
    args = testing.snow_problem(1024, 17, torch.float64, device=card)
    k5 = snow.snow_hydrology.launches
    tsh.snow_hydrology_block(**args)
    assert snow.snow_hydrology.launches == k5 + 1
    torch.func.jvp(
        lambda h: tsh.snow_hydrology_block(**dict(args, h2osno=h)).h2osno,
        (args["h2osno"],), (torch.ones_like(args["h2osno"]),))
    assert snow.snow_hydrology.launches == k5 + 1
    with pytest.raises(RuntimeError, match="snow_hydrology_block"):
        snow.snow_hydrology(**dict(
            args, h2osno=args["h2osno"].clone().requires_grad_()))



# ---- K7, the soil temperature module -----------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [N, 4001, 65, 63, 1])
@pytest.mark.parametrize("land,kind", [("column", "mixed"),
                                       ("soil", "july"), ("soil", "spring"),
                                       ("ice", "mixed")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_soil_temperature_kernel_matches_plain(card, dtype, land, kind, n):
    """K7 against the plain chain at atol 0: every output, NaNs in the same
    places; a second launch on the same inputs equal to the first bit for
    bit; a launch captured in a CUDA graph and replayed on new inputs
    equal to an eager one on them.  Widths around K7's 64-column blocks;
    per-column and 0-d land masks; July-like, spring-like and mixed
    problems."""
    from elmkernels_torch.ops import soil_temperature as k7
    args = testing.soil_temperature_problem(n, 19, dtype, land, kind,
                                            device=card)
    got = k7.soil_temperature(**args)._asdict()
    again = k7.soil_temperature(**args)._asdict()
    want = tst.soil_temperature_block_plain(**args)._asdict()
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        assert _same(got[f], want[f]), f
        assert _same(got[f], again[f]), f
    other = testing.soil_temperature_problem(n, 20, dtype, land, kind,
                                             device=card)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        k7.soil_temperature(**args)
    torch.cuda.current_stream(card).wait_stream(side)
    launches = k7.soil_temperature.launches
    with torch.cuda.graph(graph):
        captured = k7.soil_temperature(**args)
    assert k7.soil_temperature.launches == launches + 1
    for k, v in args.items():
        if isinstance(v, torch.Tensor) and v.dim():
            v.copy_(other[k])
    graph.replay()
    torch.cuda.synchronize(card)
    want = tst.soil_temperature_block_plain(**args)._asdict()
    for f, v in captured._asdict().items():
        assert _same(v, want[f]), f


@pytest.mark.cuda
def test_soil_temperature_dispatch_on_card(card):
    """On the card ``soil_temperature_block`` launches K7 once and K4 not
    at all; under ``torch.func.jvp`` it runs the plain chain (K4 through
    ``PdmaSolve``), and a differentiated tensor handed to K7's wrapper
    raises."""
    from elmkernels_torch.ops import pdma
    from elmkernels_torch.ops import soil_temperature as k7
    args = testing.soil_temperature_problem(1024, 17, device=card)
    n7, n4 = k7.soil_temperature.launches, pdma.pdma_solve.launches
    tst.soil_temperature_block(**args)
    assert k7.soil_temperature.launches == n7 + 1
    assert pdma.pdma_solve.launches == n4
    torch.func.jvp(
        lambda t: tst.soil_temperature_block(**dict(args, t_grnd=t)).t_grnd,
        (args["t_grnd"],), (torch.ones_like(args["t_grnd"]),))
    assert k7.soil_temperature.launches == n7 + 1
    assert pdma.pdma_solve.launches > n4
    with pytest.raises(RuntimeError, match="soil_temperature_block"):
        k7.soil_temperature(**dict(
            args, t_grnd=args["t_grnd"].clone().requires_grad_()))

# ---- K3, SNICAR's adding-doubling sweep --------------------------------------

_K3_TYPES = [(torch.float64, torch.float64, torch.float64),
             (torch.float64, torch.float32, torch.float64),
             (torch.float32, torch.float32, torch.float64),
             (torch.float32, torch.float32, torch.float32)]


def _snicar_args(n, seed, dtype, card, views=False) -> dict:
    """``snicar_problem``'s inputs on the card (``snl`` int64) with the
    synthetic optics; with ``views``, the layered inputs as views of
    arrays twice as wide."""
    from elmkernels_torch.data import params, synthetic
    from elmkernels_torch.physics.snow_snicar import SnicarTables
    a = testing.snicar_problem(n, seed)
    t = {k: torch.as_tensor(v, device=card) for k, v in a.items()}
    t = {k: (v.to(dtype) if v.is_floating_point() else v.to(torch.int64))
         for k, v in t.items()}
    if views:
        for k in ("h2osoi_liq", "h2osoi_ice", "snw_rds"):
            t[k] = torch.cat([t[k], t[k]], 1)[:, :t[k].shape[1]]
    slots = params.snicar_slots(synthetic.snicar_tables(), "synthetic")
    t["tables"] = SnicarTables(**{
        k: torch.tensor(v, dtype=dtype, device=card)
        for k, v in slots.items()})
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("views", [False, True], ids=["rows", "views"])
@pytest.mark.parametrize("n", [N + 1, 129, 65, 64, 63, 1])
@pytest.mark.parametrize("types", _K3_TYPES, ids=lambda t: "/".join(
    str(x).replace("torch.float", "f") for x in t))
def test_snicar_kernel_matches_plain(card, types, n, views):
    """K3 against the plain sweep at atol 0 in each instantiation (inputs,
    sweep, weights), NaNs in the same places; a second launch on the same
    inputs equal to the first.  Widths around K3's 64-column blocks; the
    layered inputs as rows or as views of wider arrays."""
    from elmkernels_torch.ops import snicar
    from elmkernels_torch.physics import snow_snicar as sn
    from elmkernels_torch import constants as c
    args = _snicar_args(n, 31, types[0], card, views)
    kw = dict(weight_dtype=types[2],
              sweep_dtype=types[1] if types[1] != types[0] else None)
    got, again = snicar.snicar(**args, **kw), snicar.snicar(**args, **kw)
    want = sn.snicar_ad_rt_both_plain(c.LandType(ltype=1, ctype=1, vtype=12), **args, **kw)
    for g, a, w in zip(got, again, want):
        for f in w._fields:
            assert getattr(g, f).dtype == getattr(w, f).dtype, f
            assert _same(getattr(g, f), getattr(w, f)), f
            assert _same(getattr(g, f), getattr(a, f)), f


@pytest.mark.cuda
def test_snicar_dispatch_on_card(card):
    """On the card ``snicar_ad_rt_both`` launches K3 once, and its counter
    adds the swept columns; under ``torch.func.jvp`` it runs the plain
    sweep; the wrapper refuses a differentiated tensor and a type it has
    no instantiation for."""
    from elmkernels_torch.ops import snicar
    from elmkernels_torch.physics import snow_snicar as sn
    from elmkernels_torch import constants as c
    land = c.LandType(ltype=1, ctype=1, vtype=12)
    args = _snicar_args(1024, 17, torch.float64, card)
    k3 = snicar.snicar.launches
    snicar.snicar(**args)                # the counter exists
    snicar.reset_swept()
    sn.snicar_ad_rt_both(land, **args)
    assert snicar.snicar.launches == k3 + 2
    cz, h = args["coszen"], args["h2osno"]
    assert snicar.swept() == int(((cz > 0) & (h > sn.MIN_SNW)).sum())
    torch.func.jvp(
        lambda x: sn.snicar_ad_rt_both(land, **dict(args, coszen=x))[0]
        .albout, (cz,), (torch.ones_like(cz),))
    assert snicar.snicar.launches == k3 + 2
    with pytest.raises(RuntimeError, match="snicar_ad_rt_both"):
        snicar.snicar(**dict(args, coszen=cz.clone().requires_grad_()))
    with pytest.raises(TypeError, match="instantiation"):
        snicar.snicar(**args, weight_dtype=torch.float32)


# ---- the captured step (driver/graphs.py) --------------------------------

GRAPH_NCOL, GRAPH_STEPS = 4096, 6


@pytest.fixture(scope="module")
def graph_grid(tmp_path_factory):
    """The 4,096-cell global grid with NetCDF forcing, phenology and
    aerosol files (64 x 64 forcing cells)."""
    from elmkernels_torch.data import synthetic
    d = tmp_path_factory.mktemp("graph_grid")
    synthetic.write_clm_params(d / "p.nc")
    synthetic.write_snicar_optics(d / "s.nc")
    inputs = synthetic.write_global_inputs(d, GRAPH_NCOL,
                                           forcing_grid=(64, 64))
    return dict(inputs, pft_path=str(d / "p.nc"), snicar_path=str(d / "s.nc"))


def _graph_model(grid, **kw):
    from elmkernels_torch.driver.model import Model
    grid = dict(grid)
    return Model.from_surfdata(grid.pop("surfdata"), GRAPH_NCOL, **grid,
                               **kw)


def _graph_loop(m, loop, nsteps=GRAPH_STEPS, start=None):
    from elmkernels_torch.driver.model import reduce_diags
    from elmkernels_torch.utils.dates import Date
    date = start or Date.from_ymd(1985, 7, 1, 9 * 3600)
    if loop == "run":
        per = []
        m.run(date, nsteps, lambda d_, s, d: per.append(reduce_diags(d)))
        return type(per[0])(*(torch.cat(v) for v in zip(*per)))
    if loop.startswith("run_windows"):
        return m.run_windows(date, nsteps, window=nsteps // 2,
                             series=loop.endswith("series"))
    return getattr(m, loop)(date, nsteps)


def _assert_same(a, b):
    for k, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("loop", ["run", "run_scan", "run_scan_series",
                                  "run_windows", "run_windows_series"])
def test_graph_replay_is_the_eager_loop(card, graph_grid, loop, packed):
    """Each entry point replays the captured step (one warm-up step, one
    capture, the rest replays, K2 once a step) bit for bit with its eager
    run under disable_graphs()."""
    from elmkernels_torch.driver.graphs import disable_graphs
    from elmkernels_torch.ops import canopy
    eager = _graph_model(graph_grid, packed_carry=packed)
    with disable_graphs():
        want = _graph_loop(eager, loop)
    m = _graph_model(graph_grid, packed_carry=packed)
    canopy.canopy_stability.launches = 0
    got = _graph_loop(m, loop)
    torch.cuda.synchronize()
    assert canopy.canopy_stability.launches == GRAPH_STEPS
    assert len(m._graphs.captures) == 1
    assert m._graphs.replays == GRAPH_STEPS - 1
    _assert_same(eager.state, m.state)
    _assert_same(want, got)


@pytest.mark.cuda
def test_k2_counters_read_the_captured_launch(card, graph_grid):
    from elmkernels_torch.ops import canopy
    m = _graph_model(graph_grid)
    _graph_loop(m, "run_scan", nsteps=3)
    sched = m._graphs.sched
    assert sched is not None and canopy._last_sched is sched
    c = canopy.counters()
    # every column's chunk was claimed, by the replay's own launch
    assert c["chunks"] >= GRAPH_NCOL // 32 and c["lane_rounds"] > 0
    sched.zero_()
    m._graphs.graph.replay()
    assert canopy.counters()["chunks"] >= GRAPH_NCOL // 32


@pytest.mark.cuda
def test_replaced_params_recapture(card, graph_grid):
    """A model whose parameters were replaced (new tensors, new values)
    captures again and gives the eager result."""
    from elmkernels_torch.driver.graphs import disable_graphs
    from elmkernels_torch.utils.dates import Date
    a, b = _graph_model(graph_grid), _graph_model(graph_grid)
    later = Date.from_ymd(1985, 7, 1, 12 * 3600)
    with disable_graphs():
        _graph_loop(a, "run_scan", nsteps=3)
    _graph_loop(b, "run_scan", nsteps=3)
    for m in (a, b):
        m.params = m.params._replace(watsat=m.params.watsat * 0.95)
    with disable_graphs():
        want = _graph_loop(a, "run_scan_series", 4, later)
    got = _graph_loop(b, "run_scan_series", 4, later)
    assert len(b._graphs.captures) == 2
    _assert_same(a.state, b.state)
    _assert_same(want, got)
