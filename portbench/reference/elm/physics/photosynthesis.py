"""Farquhar C3/C4 photosynthesis with Ball-Berry stomatal conductance —
batched over columns.

Counterpart of ``elmkernels_tpu/physics/photosynthesis.py`` (reference
``src/physics/photosynthesis_impl.hh:5-651``).  The per-leaf hybrid
secant + Brent root solve for intracellular CO2 has two implementations
with one arithmetic:

- :func:`hybrid_solve_plain` — the masked-batch loop of the JAX package,
  in PyTorch; each iteration's ``any(active)`` test is a host sync.  It
  runs for tensors on the CPU, and as the yardstick of the kernel.
- ``elmkernels_torch.ops.ci_solver.ci_hybrid_solve`` — the CUDA kernel,
  one thread per leaf running the same per-leaf sequence to its end.

:func:`hybrid_solve` picks by the device of its input.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c
from portbench.reference.elm.physics.math_utils import rdiv

_THETA_IP = 0.95
_FNPS = 0.15
_THETA_PSII = 0.7
_SCO = 0.5 * 0.209 / (42.75 / 1.e06)
_RSMAX0 = 2.0e4

# secant / Brent controls of the reference's ``hybrid``/``brent``
SECANT_EPS, SECANT_EPS1, SECANT_ITMAX = 1.0e-2, 1.0e-4, 40
BRENT_EPS, BRENT_ITMAX = 1.0e-2, 20


class PFTPsnParams(NamedTuple):
    """Photosynthesis PFT traits (reference ``PFTDataPSN``).  Each field is
    a 0-d tensor for a homogeneous (single-PFT) domain, an [ncol] tensor
    for per-column vegetation."""
    fnr: torch.Tensor
    act25: torch.Tensor
    kcha: torch.Tensor
    koha: torch.Tensor
    cpha: torch.Tensor
    vcmaxha: torch.Tensor
    jmaxha: torch.Tensor
    tpuha: torch.Tensor
    lmrha: torch.Tensor
    vcmaxhd: torch.Tensor
    jmaxhd: torch.Tensor
    tpuhd: torch.Tensor
    lmrhd: torch.Tensor
    lmrse: torch.Tensor
    qe: torch.Tensor
    theta_cj: torch.Tensor
    bbbopt: torch.Tensor
    mbbopt: torch.Tensor
    c3psn: torch.Tensor
    slatop: torch.Tensor
    leafcn: torch.Tensor
    flnr: torch.Tensor
    fnitr: torch.Tensor
    dleaf: torch.Tensor
    smpso: torch.Tensor
    smpsc: torch.Tensor
    tc_stress: torch.Tensor


def ft(tl, ha):
    """Arrhenius temperature response.  Reference: lines 622-625."""
    return torch.exp(ha / (c.RGAS * 1.0e-3 * (c.TFRZ + 25.0))
                     * (1.0 - rdiv(c.TFRZ + 25.0, tl)))


def fth(tl, hd, se, scale):
    """High-temperature inhibition.  Reference: lines 627-630."""
    return scale / (1.0 + torch.exp((-hd + se * tl) / (c.RGAS * 1.0e-3 * tl)))


def fth25(hd, se):
    """Reference: lines 632-635."""
    return 1.0 + torch.exp((-hd + se * (c.TFRZ + 25.0))
                           / (c.RGAS * 1.0e-3 * (c.TFRZ + 25.0)))


def quadratic_roots(a, b, c_):
    """Numerically stable quadratic roots.  Reference: lines 285-302."""
    disc = torch.sqrt(b * b - 4.0 * a * c_)
    q = torch.where(b >= 0.0, -0.5 * (b + disc), -0.5 * (b - disc))
    r1 = q / a
    r2 = torch.where(q != 0.0, c_ / torch.where(q != 0.0, q, 1.0), 1.0e36)
    return r1, r2


def psn_mode_of(p: PFTPsnParams) -> str:
    """Photosynthesis pathway for a trait set: ``"c3"``, ``"c4"`` or
    ``"mixed"`` (both pathways, selected per leaf by ``c3psn``)."""
    v = torch.as_tensor(p.c3psn).reshape(-1)
    if bool((v == v[0]).all()):
        return "c3" if round(float(v[0])) == 1 else "c4"
    return "mixed"


def tile_traits(p: PFTPsnParams, reps: int) -> PFTPsnParams:
    """Per-column traits repeated ``reps`` times along the column axis
    (for the stacked sun+shade batch); 0-d traits pass through."""
    return PFTPsnParams(*(v.repeat(reps) if v.ndim >= 1 else v for v in p))


class CiEnv(NamedTuple):
    """Per-leaf environment of the ci residual function ([n] each).  The
    trailing four fields carry PFT traits per leaf: expanded scalars for a
    homogeneous domain, each leaf's own column's trait for per-column
    vegetation."""
    gb_mol: torch.Tensor
    je: torch.Tensor
    cair: torch.Tensor
    oair: torch.Tensor
    lmr_z: torch.Tensor
    par_z: torch.Tensor
    rh_can: torch.Tensor
    vcmax_z: torch.Tensor
    forc_pbot: torch.Tensor
    cp: torch.Tensor
    kc: torch.Tensor
    ko: torch.Tensor
    tpu_z: torch.Tensor
    kp_z: torch.Tensor
    bbb: torch.Tensor
    qe: torch.Tensor        # PFT trait (c4 light-response slope)
    theta_cj: torch.Tensor  # PFT trait (colimitation shape)
    mbbopt: torch.Tensor    # PFT trait (Ball-Berry slope)
    c3frac: torch.Tensor    # c3psn per leaf (used when mode == "mixed")


class PsnOut(NamedTuple):
    gs_mol: torch.Tensor
    ac: torch.Tensor
    aj: torch.Tensor
    ap: torch.Tensor
    ag: torch.Tensor
    an: torch.Tensor


def _sel_out(mask, new: PsnOut, old: PsnOut, log=None,
             kind: str = "") -> PsnOut:
    """``new`` where ``mask`` (the leaves that commit this evaluation),
    else ``old``; ``(kind, mask)`` is appended to ``log`` if one is given."""
    if log is not None:
        log.append((kind, mask))
    return PsnOut(*(torch.where(mask, n, o) for n, o in zip(new, old)))


def ci_func(ci, prev: PsnOut, env: CiEnv, mode: str):
    """Residual f(ci) = ci - (ca - an*(1.4gs+1.6gb)/(gb*gs)*patm) and the
    photosynthesis rates/conductance at this ci (reference lines 307-390).
    On ``an < 0`` the residual is 0 and gs_mol carries the previous value.
    """
    if mode != "c4":
        ac3 = (env.vcmax_z * torch.clamp(ci - env.cp, min=0.0)
               / (ci + env.kc * (1.0 + env.oair / env.ko)))
        aj3 = (env.je * torch.clamp(ci - env.cp, min=0.0)
               / (4.0 * ci + 8.0 * env.cp))
        ap3 = 3.0 * env.tpu_z
    if mode != "c3":
        ac4 = env.vcmax_z
        aj4 = env.qe * env.par_z * 4.6
        ap4 = env.kp_z * torch.clamp(ci, min=0.0) / env.forc_pbot
    if mode == "c3":
        ac, aj, ap = ac3, aj3, ap3
    elif mode == "c4":
        ac, aj, ap = ac4, aj4, ap4
    else:
        isc3 = env.c3frac >= 0.5
        ac = torch.where(isc3, ac3, ac4)
        aj = torch.where(isc3, aj3, aj4)
        ap = torch.where(isc3, ap3, ap4)

    r1, r2 = quadratic_roots(env.theta_cj.expand_as(ac), -(ac + aj), ac * aj)
    ai = torch.minimum(r1, r2)
    r1, r2 = quadratic_roots(torch.full_like(ac, _THETA_IP), -(ai + ap),
                             ai * ap)
    ag = torch.minimum(r1, r2)
    an = ag - env.lmr_z

    neg = an < 0.0
    cs = torch.clamp(env.cair - rdiv(1.4, env.gb_mol) * an * env.forc_pbot,
                     min=1.e-6)
    r1, r2 = quadratic_roots(
        cs, cs * (env.gb_mol - env.bbb) - env.mbbopt * an * env.forc_pbot,
        -env.gb_mol * (cs * env.bbb
                       + env.mbbopt * an * env.forc_pbot * env.rh_can))
    gs_new = torch.maximum(r1, r2)
    gs_mol = torch.where(neg, prev.gs_mol, gs_new)
    gs_safe = torch.where(gs_mol != 0.0, gs_mol, 1.0)
    fval = torch.where(
        neg, 0.0,
        ci - env.cair + an * env.forc_pbot
        * (1.4 * gs_mol + 1.6 * env.gb_mol) / (env.gb_mol * gs_safe))
    return fval, PsnOut(gs_mol, ac, aj, ap, ag, an)


def _any(mask) -> bool:
    return bool(mask.any())


def hybrid_solve_plain(x0_init, env: CiEnv, mode: str, enabled,
                       out_init: PsnOut | None = None, log=None):
    """Masked-batch port of the reference's ``hybrid`` (lines 516-620) +
    ``brent`` (lines 395-511), the JAX package's ``hybrid_solve``.
    Returns ``(ci, PsnOut, secant iterations per leaf)``.  Given a list
    ``log``, appends ``(kind, mask)`` for every residual evaluation, the
    mask of the leaves that commit it; kind is "start", "secant",
    "overflow" or "brent"."""
    eps, eps1, itmax = SECANT_EPS, SECANT_EPS1, SECANT_ITMAX
    if out_init is None:
        zero = torch.zeros_like(x0_init)
        out_init = PsnOut(zero, zero, zero, zero, zero, zero)

    f0, o = ci_func(x0_init, out_init, env, mode)
    out = _sel_out(enabled, o, out_init, log, "start")
    done = (~enabled) | (f0 == 0.0)
    xfin = x0_init
    minx, minf = x0_init, f0

    x1 = x0_init * 0.99
    f1, o = ci_func(x1, out, env, mode)
    out = _sel_out(~done, o, out, log, "start")
    newly = (~done) & (f1 == 0.0)
    xfin = torch.where(newly, x1, xfin)
    done = done | newly
    upd = (~done) & (f1 < minf)
    minx = torch.where(upd, x1, minx)
    minf = torch.where(upd, f1, minf)

    x0 = x0_init
    zeros = torch.zeros_like(x0_init)
    over = torch.zeros_like(done)
    brent = torch.zeros_like(done)
    ba = bb = bfa = bfb = btol = zeros
    it = torch.zeros(x0_init.shape, dtype=torch.int32, device=x0.device)

    while _any(~done & ~brent):
        act = ~done & ~brent
        it = it + act.to(torch.int32)
        den = f1 - f0
        dx = -f1 * (x1 - x0) / torch.where(den != 0.0, den, 1.0)
        x = x1 + dx
        tol = torch.abs(x) * eps
        conv = act & (torch.abs(dx) < tol)
        xfin = torch.where(conv, x, xfin)
        done = done | conv
        act2 = act & ~conv
        x0n = torch.where(act2, x1, x0)
        f0n = torch.where(act2, f1, f0)
        x1n = torch.where(act2, x, x1)
        f1e, o2 = ci_func(x1n, out, env, mode)
        out = _sel_out(act2, o2, out, log, "secant")
        f1n = torch.where(act2, f1e, f1)
        updm = act2 & (f1n < minf)
        minx = torch.where(updm, x1n, minx)
        minf = torch.where(updm, f1n, minf)
        close = act2 & (torch.abs(f1n) <= eps1)
        xfin = torch.where(close, x1n, xfin)
        done = done | close
        act3 = act2 & ~close
        trig = act3 & (f1n * f0n < 0.0)
        brent = brent | trig
        ba = torch.where(trig, x0n, ba)
        bb = torch.where(trig, x1n, bb)
        bfa = torch.where(trig, f0n, bfa)
        bfb = torch.where(trig, f1n, bfb)
        btol = torch.where(trig, tol, btol)
        act4 = act3 & ~trig
        overn = act4 & (it > itmax)
        over = over | overn
        # reference: on iteration overflow, x0 keeps the post-shift value
        xfin = torch.where(overn, x0n, xfin)
        done = done | overn
        x0, f0, x1, f1 = x0n, f0n, x1n, f1n

    # overflow leaves: final evaluation at the minimum-f point (line 615)
    _, o_over = ci_func(minx, out, env, mode)
    out = _sel_out(over, o_over, out, log, "overflow")

    # ---- Brent phase for leaves that bracketed a root ----
    a, b, fa, fb = ba, bb, bfa, bfb
    cc, fc, d, e = bb, bfb, zeros, zeros
    bdone = ~brent
    bit = 0
    while _any(~bdone) and bit != BRENT_ITMAX:
        act = ~bdone
        bit += 1
        cond1 = act & (((fb > 0.0) & (fc > 0.0)) | ((fb < 0.0) & (fc < 0.0)))
        cc = torch.where(cond1, a, cc)
        fc = torch.where(cond1, fa, fc)
        d = torch.where(cond1, b - a, d)
        e = torch.where(cond1, b - a, e)
        cond2 = act & (torch.abs(fc) < torch.abs(fb))
        a = torch.where(cond2, b, a)
        bb_ = torch.where(cond2, cc, b)
        ccn = torch.where(cond2, a, cc)
        fa = torch.where(cond2, fb, fa)
        fb = torch.where(cond2, fc, fb)
        fcn = torch.where(cond2, fa, fc)
        tol1 = 2.0 * BRENT_EPS * torch.abs(bb_) + 0.5 * btol
        xm = 0.5 * (ccn - bb_)
        convb = act & ((torch.abs(xm) <= tol1) | (fb == 0.0))
        xfin = torch.where(convb, bb_, xfin)
        bdone = bdone | convb
        act2 = act & ~convb

        interp_ok = (torch.abs(e) >= tol1) & (torch.abs(fa) > torch.abs(fb))
        sr = fb / torch.where(fa != 0.0, fa, 1.0)
        aeqc = a == ccn
        p1 = 2.0 * xm * sr
        q1 = 1.0 - sr
        fcs = torch.where(fcn != 0.0, fcn, 1.0)
        q2 = fa / fcs
        r2 = fb / fcs
        p2 = sr * (2.0 * xm * q2 * (q2 - r2) - (bb_ - a) * (r2 - 1.0))
        q2b = (q2 - 1.0) * (r2 - 1.0) * (sr - 1.0)
        pp = torch.where(aeqc, p1, p2)
        qq = torch.where(aeqc, q1, q2b)
        qq = torch.where(pp > 0.0, -qq, qq)
        pp = torch.abs(pp)
        accept = interp_ok & (
            2.0 * pp < torch.minimum(3.0 * xm * qq - torch.abs(tol1 * qq),
                                     torch.abs(e * qq)))
        d_int = pp / torch.where(qq != 0.0, qq, 1.0)
        d_next = torch.where(accept, d_int, xm)
        e_next = torch.where(accept, d, xm)

        signed_tol = torch.where(xm >= 0.0, tol1, -tol1)
        step = torch.where(torch.abs(d_next) > tol1, d_next, signed_tol)
        b_next = bb_ + step

        fbe, ob = ci_func(b_next, out, env, mode)
        out = _sel_out(act2, ob, out, log, "brent")
        fb_next = torch.where(act2, fbe, fb)
        hit = act2 & (fb_next == 0.0)
        xfin = torch.where(hit, b_next, xfin)
        bdone = bdone | hit

        a = torch.where(act2, bb_, a)
        b = torch.where(act2, b_next, bb_)
        fa = torch.where(act2, fb, fa)
        fb = fb_next
        cc, fc = ccn, fcn
        d = torch.where(act2, d_next, d)
        e = torch.where(act2, e_next, e)

    # leaves that exhausted Brent's ITMAX: x = b (line 510)
    exhausted = brent & ~bdone
    xfin = torch.where(exhausted, b, xfin)
    return xfin, out, it


def hybrid_solve_jvp_plain(x0_init, dx0, env: CiEnv, denv: CiEnv,
                           mode: str, enabled):
    """``torch.func.jvp`` of :func:`hybrid_solve_plain` along ``(dx0,
    denv)``: ``(ci, PsnOut, iterations, dci, tangent PsnOut)``, the plain
    version of the tangent kernel."""
    def solve(x0, *fields):
        return hybrid_solve_plain(x0, CiEnv(*fields), mode, enabled)
    # expanded (stride-0) scalars cannot carry a tangent of their own
    (ci, out, it), (dci, dout, _) = torch.func.jvp(
        solve, tuple(t.contiguous() for t in (x0_init, *env)),
        tuple(t.contiguous() for t in (dx0, *denv)))
    return ci, out, it, dci, dout


def hybrid_solve(x0_init, env: CiEnv, mode: str, enabled):
    """The ci root solve: the plain masked-batch loop, on any device (the
    program runs its kernel K1 in its place on a card)."""
    return hybrid_solve_plain(x0_init, env, mode, enabled)


class PhotosynthesisOut(NamedTuple):
    rs: torch.Tensor       # canopy stomatal resistance (s/m)
    ci_z: torch.Tensor     # [ncol, nlevcan]
    ci_root: torch.Tensor  # hybrid-solve root [ncol]; warm-start carry
    ci_iters: torch.Tensor  # i32 [ncol] secant iterations used


def photosynthesis(p: PFTPsnParams, nrad, forc_pbot, t_veg, t10, esat_tv,
                   eair, oair, cair, rb, btran, dayl_factor, thm, tlai_z,
                   vcmaxcint, par_z, lai_z, enabled,
                   mode: str | None = None,
                   ci_init=None) -> PhotosynthesisOut:
    """Leaf photosynthesis + stomatal resistance for one canopy phase
    (reference lines 7-282, nlevcan == 1 big-leaf path).  ``enabled``
    masks the leaves whose result is used; ``ci_init`` optionally
    warm-starts the ci solve where it is positive and finite."""
    if mode is None:
        mode = psn_mode_of(p)
    c3 = mode == "c3"
    mixed = mode == "mixed"
    if mixed:
        isc3 = p.c3psn >= 0.5

    if vcmaxcint.ndim == 2:
        vcmaxcint = vcmaxcint[:, 0]
    if par_z.ndim == 2:
        par_z = par_z[:, 0]
    if lai_z.ndim == 2:
        lai_z = lai_z[:, 0]

    lnc = 1.0 / (p.slatop * p.leafcn)
    act25 = p.act25 * 1000.0 / 60.0
    vcmax25top = lnc * p.flnr * p.fnr * act25 * dayl_factor * p.fnitr
    t10c = torch.clamp(t10 - c.TFRZ, 11.0, 35.0)
    jmax25top = (2.59 - 0.035 * t10c) * vcmax25top
    tpu25top = 0.167 * vcmax25top
    kp25top = 20000.0 * vcmax25top

    if mixed:
        lmr25top = torch.where(isc3, vcmax25top * 0.015,
                               vcmax25top * 0.025)
    elif c3:
        lmr25top = vcmax25top * 0.015
    else:
        lmr25top = vcmax25top * 0.025

    # single canopy layer (nrad == 1): nscaler = canopy-integrated factor
    nscaler = vcmaxcint
    lmr25 = lmr25top * nscaler
    if mode != "c4":
        lmrc = fth25(p.lmrhd, p.lmrse)
        lmr_z_c3 = lmr25 * ft(t_veg, p.lmrha) * fth(t_veg, p.lmrhd,
                                                    p.lmrse, lmrc)
    if mode != "c3":
        lmr_z_c4 = (lmr25 * 2.0 ** ((t_veg - (c.TFRZ + 25.0)) / 10.0)
                    / (1.0 + torch.exp(1.3 * (t_veg - (c.TFRZ + 55.0)))))
    if c3:
        lmr_z = lmr_z_c3
    elif mixed:
        lmr_z = torch.where(isc3, lmr_z_c3, lmr_z_c4)
    else:
        lmr_z = lmr_z_c4

    par0 = par_z
    day = par0 > 0.0
    vcmax25 = vcmax25top * nscaler
    jmax25 = jmax25top * nscaler
    tpu25 = tpu25top * nscaler
    kp25 = kp25top * nscaler
    vcmaxse = 668.39 - 1.07 * t10c
    jmaxse = 659.70 - 0.75 * t10c
    tpuse = vcmaxse
    vcmaxc = fth25(p.vcmaxhd, vcmaxse)
    jmaxc = fth25(p.jmaxhd, jmaxse)
    tpuc = fth25(p.tpuhd, tpuse)
    vcmax_z = vcmax25 * ft(t_veg, p.vcmaxha) * fth(t_veg, p.vcmaxhd, vcmaxse,
                                                   vcmaxc)
    jmax_z = jmax25 * ft(t_veg, p.jmaxha) * fth(t_veg, p.jmaxhd, jmaxse,
                                                jmaxc)
    tpu_z = tpu25 * ft(t_veg, p.tpuha) * fth(t_veg, p.tpuhd, tpuse, tpuc)
    if mode != "c3":
        vcmax_z_c4 = (vcmax25 * 2.0 ** ((t_veg - (c.TFRZ + 25.0)) / 10.0)
                      / (1.0 + torch.exp(0.2 * ((c.TFRZ + 15.0) - t_veg)))
                      / (1.0 + torch.exp(0.3 * (t_veg - (c.TFRZ + 40.0)))))
        vcmax_z = (torch.where(isc3, vcmax_z, vcmax_z_c4) if mixed
                   else vcmax_z_c4)
    kp_z = kp25 * 2.0 ** ((t_veg - (c.TFRZ + 25.0)) / 10.0)
    vcmax_z = torch.where(day, vcmax_z, 0.0)
    jmax_z = torch.where(day, jmax_z, 0.0)
    tpu_z = torch.where(day, tpu_z, 0.0)
    kp_z = torch.where(day, kp_z, 0.0)

    vcmax_z = vcmax_z * btran
    lmr_z = lmr_z * btran

    cf = forc_pbot / (c.RGAS * 1.0e-3 * thm) * 1.e06
    gb = 1.0 / rb
    gb_mol = gb * cf
    bbb = torch.clamp(p.bbbopt * btran, min=1.0)

    kc25 = (404.9 / 1.e06) * forc_pbot
    ko25 = (278.4 / 1.e03) * forc_pbot
    cp25 = 0.5 * oair / _SCO
    kc = kc25 * ft(t_veg, p.kcha)
    ko = ko25 * ft(t_veg, p.koha)
    cp = cp25 * ft(t_veg, p.cpha)

    # night-time resistance
    rs_night = torch.clamp(1.0 / bbb * cf, max=_RSMAX0)

    # day-time: electron transport + hybrid ci solve
    ceair = torch.minimum(eair, esat_tv)
    rh_can = ceair / esat_tv
    qabs = 0.5 * (1.0 - _FNPS) * par0 * 4.6
    r1, r2 = quadratic_roots(torch.full_like(qabs, _THETA_PSII),
                             -(qabs + jmax_z), qabs * jmax_z)
    je = torch.minimum(r1, r2)

    if mixed:
        ci0 = torch.where(isc3, 0.7 * cair, 0.4 * cair)
    else:
        ci0 = (0.7 if c3 else 0.4) * cair
    if ci_init is not None:
        ok = (ci_init > 0.0) & torch.isfinite(ci_init)
        ci0 = torch.where(ok, ci_init, ci0)

    def cc(v):
        return torch.as_tensor(v, dtype=cair.dtype,
                               device=cair.device).expand_as(cair)

    env = CiEnv(gb_mol, je, cair, oair, lmr_z, par0, rh_can, vcmax_z,
                forc_pbot, cp, kc, ko, tpu_z, kp_z, bbb,
                qe=cc(p.qe), theta_cj=cc(p.theta_cj), mbbopt=cc(p.mbbopt),
                c3frac=cc(p.c3psn))
    ci, out, ci_iters = hybrid_solve(ci0, env, mode, enabled & day)

    gs_mol = torch.where(out.an < 0.0, bbb, out.gs_mol)
    ci_day = (cair - out.an * forc_pbot
              * (1.4 * gs_mol + 1.6 * gb_mol)
              / (gb_mol * torch.where(gs_mol != 0.0, gs_mol, 1.0)))
    gs = gs_mol / cf
    rs_day = torch.clamp(1.0 / torch.where(gs != 0.0, gs, 1.0), max=_RSMAX0)

    rs_z = torch.where(day, rs_day, rs_night)
    ci_out = torch.where(day, ci_day, 0.0)

    # canopy aggregation (single layer)
    lai0 = lai_z
    gscan = lai0 / (rb + rs_z)
    haslai = lai0 > 0.0
    rs = torch.where(haslai,
                     lai0 / torch.where(haslai, gscan, 1.0) - rb, 0.0)
    return PhotosynthesisOut(rs, ci_out[:, None],
                             torch.where(day, ci, 0.0), ci_iters)
