"""The port's tangent-linear model (``elmkernels_torch.driver.sensitivity``)
against the JAX package's ``run_jvp``, on the CPU, and the forward-mode
rules of the two kernels' ``torch.autograd.Function``\\ s.

``run_jvp`` differentiates two daylight steps (the ci solve and the canopy
loop iterate), seeded by the air temperature and by the soil
porosity: every floating tangent and primal field agrees with the JAX
package's at rtol 1e-8, with ``test_torch_step.py``'s absolute floors.  On
the CPU the step's tangents flow through the plain solvers; on the card
through ``CiSolve`` (whose ``jvp`` launches the tangent kernel) and
``PdmaSolve`` (whose ``jvp`` solves again).  Here both Functions run with
their plain backends, in isolation and inside the whole step, so that a
tangent they dropped would show on the CPU too.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from elmkernels_torch.driver import sensitivity as tsens
from elmkernels_torch.ops import ci_solver, pdma, tangents, testing
from elmkernels_torch.physics import photosynthesis as tpsn
from elmkernels_torch.physics import soil_temperature as tst
from elmkernels_torch.utils.dates import Date as TDate

torch.set_num_threads(1)

NCOL, NSTEPS = 3, 2
START = (1985, 7, 1, 14 * 3600)     # in the synthetic forcing's daylight
SITE = dict(lat_deg=40.0, lon_deg=255.0, mixed_radiation=False)
SEEDS = {"tbot": "forcing", "watsat": "params"}
RTOL = 1e-8


def atol_of(name):
    return 1e-9 if name.startswith("err") else tp.ATOL


def _seed(mod, name):
    kind = "seed_forcing" if SEEDS[name] == "forcing" else "seed_params"
    return {kind: mod.seed_field(name)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tp.write_files(tmp_path_factory.mktemp("torch_sens"))


@pytest.fixture(scope="module")
def model(files):
    return tp.torch_model(files, NCOL, **SITE)


@pytest.fixture(scope="module")
def windows(model):
    return model.stack_windows(TDate.from_ymd(*START), NSTEPS)


@pytest.fixture(scope="module")
def port(model, windows):
    return {name: tsens.run_jvp(model, None, NSTEPS, forc_stack=windows[0],
                                phen_stack=windows[1], **_seed(tsens, name))
            for name in SEEDS}


@pytest.fixture(scope="module")
def jax_results(files):
    """The JAX package's run_jvp for each seed (one compiled executable:
    the direction is data)."""
    from elmkernels_tpu.driver import sensitivity as jsens
    from elmkernels_tpu.utils.dates import Date as JDate
    jm = tp.jax_model(files, NCOL, **SITE)
    return {name: jsens.run_jvp(jm, JDate.from_ymd(*START), NSTEPS,
                                **_seed(jsens, name))
            for name in SEEDS}


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_run_jvp_matches_jax(port, jax_results, seed):
    t, j = port[seed], jax_results[seed]
    compared = 0
    for kind in ("d_state", "d_diags", "state", "diags"):
        jt, tt = getattr(j, kind), getattr(t, kind)
        assert tuple(jt._fields) == tuple(tt._fields)
        for name in jt._fields:
            a = np.asarray(getattr(jt, name))
            if a.dtype.kind != "f":     # float0 tangents, integer fields
                continue
            tp.assert_close(a, getattr(tt, name), RTOL, atol_of(name),
                            f"{seed} {kind}.{name}")
            compared += 1
    assert compared > 100
    # the ci solve ran on both steps
    assert int(t.diags.niters_ci.max()) > 0
    assert float(t.d_diags.eflx_sh_tot.abs().max()) > 0.0


def test_forcing_jvp_matches_finite_differences(model, windows, port):
    """d(fluxes)/d(T_atm) against central differences at h = 1 mK, on the
    columns whose solver iteration counts agree between the two
    perturbed runs (the JAX package's test_forcing_jvp_matches_fd)."""
    forc, phen = windows
    h = 1e-3
    _, hi = tsens.trajectory(model, forc._replace(tbot=forc.tbot + h), phen)
    _, lo = tsens.trajectory(model, forc._replace(tbot=forc.tbot - h), phen)
    same = ((hi.niters_canopy == lo.niters_canopy).all(0)
            & (hi.niters_ci == lo.niters_ci).all(0))
    assert int(same.sum()) >= 1
    res = port["tbot"]
    for name in ("eflx_sh_tot", "eflx_lh_tot", "t_ref2m", "eflx_lwrad_out"):
        got = getattr(res.d_diags, name)[:, same]
        fd = (getattr(hi, name) - getattr(lo, name))[:, same] / (2.0 * h)
        assert bool(torch.isfinite(got).all()), name
        if name == "t_ref2m":
            assert bool((got > 0.0).all())
        torch.testing.assert_close(got, fd, rtol=2e-3, atol=1e-4,
                                   msg=name)


def test_seeding_leaves_primal_and_model_alone(model, windows, port):
    """The primal does not depend on the direction, nor on being
    differentiated, and run_jvp leaves model.state as it was."""
    before = [v.clone() for v in model.state]
    fin, diags = tsens.trajectory(model, *windows)
    for k in diags._fields:
        assert torch.equal(getattr(port["tbot"].diags, k),
                           getattr(port["watsat"].diags, k)), k
        assert torch.equal(getattr(port["tbot"].diags, k),
                           getattr(diags, k)), k
    for a, b in zip(before, model.state):
        assert torch.equal(a, b)
    assert torch.equal(fin.t_soisno, port["tbot"].state.t_soisno)


def test_tangents_propagate_into_the_state(port):
    assert bool((port["watsat"].d_state.t_grnd != 0.0).any())
    dt = port["tbot"].d_state.t_soisno
    assert bool((dt != 0.0).any()) and bool(torch.isfinite(dt).all())


# ---- the Functions' forward-mode rules, with their plain backends --------

@pytest.mark.parametrize("mode", ["c3", "c4", "mixed"])
def test_ci_function_jvp_equals_jvp_of_plain(mode):
    """CiSolve's jvp (the tangent kernel's plain version) equals
    torch.func.jvp through the masked-batch loop bit for bit, with the
    same iteration counts."""
    x0, env, en = testing.ci_problem_tensors(3000, 3, mode, torch.float64,
                                             "cpu")
    dx0, denv = testing.ci_tangents(x0, env, 5)

    def through_function(x, *e):
        return ci_solver.CiSolve.apply(mode, x, en, *e)

    def plain(x, *e):
        ci, out, it = tpsn.hybrid_solve_plain(x, tpsn.CiEnv(*e), mode, en)
        return (ci, *out, it)
    pf, tf = torch.func.jvp(through_function, (x0, *env), (dx0, *denv))
    pp, tpl = torch.func.jvp(plain, (x0, *env), (dx0, *denv))
    assert torch.equal(pf[-1], pp[-1])
    for a, b in zip(pf[:-1] + tf[:-1], pp[:-1] + tpl[:-1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert float(tf[0].nan_to_num().abs().max()) > 0.0


def test_pdma_function_tangent_rule():
    """PdmaSolve's tangent, A^-1 (db - dA x), against torch.func.jvp
    through the elimination; its primal bit for bit."""
    lhs, rhs = (torch.tensor(a) for a in testing.pdma_problem(500, 1))
    g = torch.Generator().manual_seed(0)
    dl = torch.randn(lhs.shape, generator=g, dtype=lhs.dtype) * (lhs != 0)
    dr = torch.randn(rhs.shape, generator=g, dtype=rhs.dtype)
    xa, ta = torch.func.jvp(pdma.PdmaSolve.apply, (lhs, rhs), (dl, dr))
    xb, tb = torch.func.jvp(tst.pdma_solve_plain, (lhs, rhs), (dl, dr))
    assert torch.equal(xa, xb)
    torch.testing.assert_close(ta, tb, rtol=1e-10, atol=1e-12)
    # the band mat-vec is A x
    n = tst.NSYS
    dense = torch.zeros(lhs.shape[0], n, n, dtype=lhs.dtype)
    rows = torch.arange(n)
    for band, off in enumerate((2, 1, 0, -1, -2)):
        cols = rows + off
        ok = (cols >= 0) & (cols < n)
        dense[:, rows[ok], cols[ok]] = lhs[:, rows[ok], band]
    torch.testing.assert_close(tst.band_matvec(lhs, xa),
                               (dense @ xa[:, :, None])[:, :, 0],
                               rtol=1e-12, atol=1e-9)


def _plain_only(launch):
    """``launch`` after checking that every tensor handed to it has
    storage and carries no tangent, as a kernel's ctypes call needs."""
    def checked(*args):
        flat = [a for x in args for a in (x if isinstance(x, tuple) else
                                          (x,))]
        for t in flat:
            if isinstance(t, torch.Tensor):
                t.data_ptr()
                assert not tangents.carries_tangent(t)
        return launch(*args)
    return checked


def test_step_through_the_functions(model, windows, port, monkeypatch):
    """The whole tangent-linear run with the step routed through CiSolve
    and PdmaSolve (as on the card, plain backends here) equals the plain
    run: nothing between the Functions and the step drops a tangent."""
    calls = {"ci": 0, "pdma": 0}

    def ci(x0, env, mode, enabled):
        calls["ci"] += 1
        return ci_solver.solve(x0, env, mode, enabled)

    def pd(lhs, rhs):
        calls["pdma"] += 1
        return pdma.solve(lhs, rhs)
    monkeypatch.setattr(tpsn, "hybrid_solve", ci)
    monkeypatch.setattr(tst, "pdma_solve", pd)
    # what reaches a launch must be plain, as a kernel reads data_ptr()
    for mod, name in ((ci_solver, "_solve"), (ci_solver, "_solve_jvp"),
                      (pdma, "_solve")):
        monkeypatch.setattr(mod, name, _plain_only(getattr(mod, name)))
    res = tsens.run_jvp(model, None, NSTEPS, forc_stack=windows[0],
                        phen_stack=windows[1], **_seed(tsens, "tbot"))
    assert calls["ci"] > 0 and calls["pdma"] == NSTEPS
    ref = port["tbot"]
    for kind in ("d_state", "d_diags"):
        for name in getattr(ref, kind)._fields:
            a, b = getattr(getattr(ref, kind), name), \
                getattr(getattr(res, kind), name)
            if not a.is_floating_point():
                continue
            torch.testing.assert_close(b, a, rtol=1e-9,
                                       atol=atol_of(name) * 1e-3,
                                       msg=f"{kind}.{name}")


def test_a_dropped_tangent_is_refused():
    """What the kernel wrappers check before a launch: a tensor that
    requires grad, carries a forward-mode tangent or is wrapped by a
    torch.func transform is refused with the Function to use."""
    import torch.autograd.forward_ad as fwAD
    x = torch.ones(4, dtype=torch.float64)
    assert not tangents.carries_tangent(x)
    assert tangents.carries_tangent(x.clone().requires_grad_())
    with fwAD.dual_level():
        assert tangents.carries_tangent(fwAD.make_dual(x, x))
    seen = []
    torch.func.jvp(lambda v: seen.append(tangents.carries_tangent(v)) or v,
                   (x,), (x,))
    assert seen == [True]
    with pytest.raises(RuntimeError, match="CiSolve"):
        tangents.refuse("ci_hybrid_solve",
                        "elmkernels_torch.ops.ci_solver.CiSolve",
                        (x.clone().requires_grad_(),))


def test_reverse_mode_is_refused():
    lhs, rhs = (torch.tensor(a) for a in testing.pdma_problem(4, 0))
    lhs.requires_grad_()
    with pytest.raises(NotImplementedError, match="jvp"):
        pdma.PdmaSolve.apply(lhs, rhs).sum().backward()
    x0, env, en = testing.ci_problem_tensors(8, 0, "c3", torch.float64,
                                             "cpu")
    x0.requires_grad_()
    with pytest.raises(NotImplementedError, match="jvp"):
        ci_solver.CiSolve.apply("c3", x0, en, *env)[0].sum().backward()
