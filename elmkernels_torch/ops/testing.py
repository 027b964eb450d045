"""Seeded inputs for holding the kernels against their plain versions, and
the reference-format files of the tests and ``chip_smoke.py``.

The ci solve's inputs are drawn in the ranges the canopy loop gives them
(leaf boundary-layer conductance, electron transport, Rubisco capacity,
respiration, CO2/O2 partial pressures), with a share of leaves pushed to
the edges where the secant search brackets a root (Brent) or runs out of
iterations.  The pentadiagonal systems are diagonally dominant with 0-5
identity-padded snow rows, like the soil/snow temperature system.  The
SNICAR inputs hold columns with 0-5 snow layers.  Numbers come from
``numpy.random.default_rng(seed)``, so the CPU tests and the card draw the
same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from elmkernels_torch import constants as c
from elmkernels_torch.physics.photosynthesis import CiEnv


def ci_problem(n: int, seed: int, mode: str = "c3", dry_share=0.25):
    """(x0, env fields as a dict of [n] float64 arrays, enabled [n] bool)
    for the ci root solve; ``dry_share`` of the leaves are dry-air leaves
    (below)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform
    pbot = u(7.0e4, 1.03e5, n)
    rb = u(5.0, 150.0, n)
    thm = u(250.0, 310.0, n)
    cf = pbot / (8.31446 * 1.0e-3 * thm) * 1.0e6
    gb_mol = cf / rb
    vcmax = u(0.0, 120.0, n)
    btran = u(0.0, 1.0, n)
    par = np.where(u(0, 1, n) < 0.1, 0.0, u(0.0, 600.0, n))
    env = dict(
        gb_mol=gb_mol, je=u(0.0, 250.0, n) * (par > 0), cair=355e-6 * pbot,
        oair=0.209 * pbot, lmr_z=u(0.0, 3.0, n) * btran, par_z=par,
        rh_can=u(0.2, 1.0, n), vcmax_z=vcmax * btran * (par > 0),
        forc_pbot=pbot, cp=u(2.0, 8.0, n), kc=u(20.0, 120.0, n),
        ko=u(1.5e4, 4.0e4, n), tpu_z=0.167 * vcmax * (par > 0),
        kp_z=2.0e4 * vcmax * u(0.5, 1.5, n) * (par > 0),
        bbb=np.maximum(u(1.0e3, 4.0e4, n) * btran, 1.0),
        qe=np.full(n, 0.05), theta_cj=np.full(n, 0.98), mbbopt=np.full(n, 9.0),
        c3frac=np.ones(n))
    if mode == "c4":
        env.update(theta_cj=np.full(n, 0.8), mbbopt=np.full(n, 4.0),
                   c3frac=np.zeros(n))
    elif mode == "mixed":
        # per-leaf traits, as per-column vegetation gives them: every
        # trait field differs between leaves
        c3 = u(0, 1, n) < 0.5
        env.update(qe=np.where(c3, 0.05, u(0.04, 0.06, n)),
                   theta_cj=np.where(c3, 0.98, 0.8),
                   mbbopt=np.where(c3, 9.0, 4.0), c3frac=c3 * 1.0)
    isc3 = env["c3frac"] >= 0.5
    x0 = np.where(isc3, 0.7, 0.4) * env["cair"]
    # a fifth of the leaves start far from the root (warm-start seeds
    # from another regime), which drives the search into Brent
    far = u(0, 1, n) < 0.2
    x0 = np.where(far, x0 * u(0.01, 50.0, n), x0)
    # a quarter are dry-air leaves near the compensation point (low
    # boundary-layer conductance and respiration, rh_can ~ 1e-3..1e-2),
    # where the secant crawls and some leaves run out of iterations
    dry = u(0, 1, n) < dry_share

    def logu(lo, hi):
        return np.exp(u(np.log(lo), np.log(hi), n))
    for k, (lo, hi) in dict(gb_mol=(1.0e4, 3.0e4), lmr_z=(1.0e-7, 1.0e-5),
                            vcmax_z=(1.0, 10.0), je=(20.0, 200.0),
                            bbb=(300.0, 1000.0), rh_can=(1.0e-3, 1.0e-2),
                            kc=(5.0, 50.0), cp=(0.3, 2.0)).items():
        env[k] = np.where(dry, logu(lo, hi), env[k])
    x0 = np.where(dry, env["cair"] * u(1.0, 2.0, n), x0)
    # 1% have a colimitation shape above 1, whose quadratic has no real
    # root: every residual is NaN and the secant search runs out (the
    # overflow exit in every mode, C4 included)
    env["theta_cj"] = np.where(u(0, 1, n) < 0.01, 1.5, env["theta_cj"])
    enabled = (par > 0) & (u(0, 1, n) < 0.95)
    return x0, env, enabled


def ci_problem_tensors(n: int, seed: int, mode: str, dtype, device,
                       dry_share=0.25):
    """:func:`ci_problem` as tensors: (x0, CiEnv, enabled)."""
    x0, env, enabled = ci_problem(n, seed, mode, dry_share)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)
    return (t(x0), CiEnv(**{k: t(v) for k, v in env.items()}),
            torch.tensor(enabled, device=device))


EVAL_KINDS = ("start", "secant", "overflow", "brent")


def ci_eval_counts(x0, env: CiEnv, mode: str, enabled) -> dict:
    """Residual evaluations each leaf's solve commits, by kind (the two
    starting ones, secant steps, the overflow re-evaluation, Brent's
    steps): {kind: int32 [n]}, counted from the plain solve's masks
    (``hybrid_solve_plain(..., log=)``).  A leaf's values decide its
    branches, so the tangent solve takes the same steps."""
    from elmkernels_torch.physics.photosynthesis import hybrid_solve_plain
    log = []
    hybrid_solve_plain(x0, env, mode, enabled, log=log)
    counts = {k: torch.zeros(x0.shape, dtype=torch.int32, device=x0.device)
              for k in EVAL_KINDS}
    for kind, mask in log:
        counts[kind] += mask.to(torch.int32)
    return counts


def warp_efficiency(evals, lanes: int = 32) -> float:
    """Lane evaluations over the lane slots of warps that hold ``lanes``
    consecutive leaves each and run as long as their longest leaf:
    sum(evals) / sum over warps of (lanes x the warp's largest)."""
    n = evals.shape[0]
    pad = torch.zeros((-n) % lanes, dtype=evals.dtype, device=evals.device)
    per_warp = torch.cat([evals, pad]).view(-1, lanes).amax(1)
    return float(evals.double().sum() / (lanes * per_warp.double().sum()))


def ci_tangents(x0, env: CiEnv, seed: int):
    """Seeded tangents of a ci problem's float inputs: each value times a
    standard normal draw (a relative direction), as (dx0, CiEnv)."""
    rng = np.random.default_rng(seed)

    def t(a):
        d = rng.standard_normal(tuple(a.shape))
        return a * torch.tensor(d, dtype=a.dtype, device=a.device)
    return t(x0), CiEnv(*(t(v) for v in env))


def pdma_problem(ncol: int, seed: int):
    """(lhs [ncol, 21, 5], rhs [ncol, 21]) float64: diagonally dominant
    pentadiagonal systems; column c has c % 6 identity snow rows on top
    (0..5) like the soil/snow temperature system."""
    rng = np.random.default_rng(seed)
    n = 21
    lhs = rng.uniform(-1.0, 1.0, (ncol, n, 5))
    lhs[:, :, 2] = (np.abs(lhs[:, :, [0, 1, 3, 4]]).sum(axis=2)
                    + rng.uniform(0.5, 2.0, (ncol, n)))
    rhs = rng.uniform(-300.0, 300.0, (ncol, n))
    # no coupling outside the matrix
    lhs[:, 0, 3:] = 0.0
    lhs[:, 1, 4] = 0.0
    lhs[:, -1, :2] = 0.0
    lhs[:, -2, 0] = 0.0
    pad = np.arange(ncol) % 6
    rows = np.arange(n)[None, :] < pad[:, None]
    lhs[rows] = np.array([0.0, 0.0, 1.0, 0.0, 0.0])
    rhs[rows] = 0.0
    return lhs, rhs


def snicar_problem(ncol: int, seed: int) -> dict:
    """The inputs of a SNICAR sweep as float64 numpy arrays (``snl``
    int32), keyed by ``snicar_ad_rt``'s argument names: column ``i`` has
    ``i % 6`` snow layers; a snowless column holds 0-5 mm of snow (some
    none, some below MIN_SNW); about a tenth of the sun is below the
    horizon."""
    rng = np.random.default_rng(seed)
    u = rng.uniform
    nsno = c.NLEVSNO
    snl = (np.arange(ncol) % 6).astype(np.int32)
    active = np.arange(nsno)[None, :] >= nsno - snl[:, None]
    ice = np.zeros((ncol, c.NLEVTOT))
    liq = np.zeros((ncol, c.NLEVTOT))
    ice[:, :nsno] = np.where(active, u(0.5, 40.0, (ncol, nsno)), 0.0)
    liq[:, :nsno] = np.where(active & (u(0, 1, (ncol, nsno)) < 0.5),
                             u(0.0, 2.0, (ncol, nsno)), 0.0)
    ice[:, nsno:] = u(0.0, 300.0, (ncol, c.NLEVGRND))
    liq[:, nsno:] = u(0.0, 300.0, (ncol, c.NLEVGRND))
    snw_rds = np.where(active, u(c.SNW_RDS_MIN, c.SNW_RDS_MAX,
                                 (ncol, nsno)), 0.0)
    bare = u(0.0, 5.0, ncol) * (u(0, 1, ncol) < 0.8)
    bare = np.where(u(0, 1, ncol) < 0.05, 1.0e-31, bare)
    h2osno = np.where(snl > 0, (ice + liq)[:, :nsno].sum(axis=1), bare)
    mss = np.exp(u(np.log(1.0e-12), np.log(1.0e-5),
                   (ncol, nsno, c.SNO_NBR_AER)))
    return dict(coszen=u(-0.1, 1.0, ncol), h2osno=h2osno, snl=snl,
                h2osoi_liq=liq, h2osoi_ice=ice, snw_rds=snw_rds,
                albsoi=u(0.05, 0.4, (ncol, 2)),
                mss_cnc_aer=np.where(active[:, :, None], mss, 0.0))


def write_snow_optics_text(path, slots: dict | None = None) -> None:
    """The SNICAR optics ``slots`` ({SnicarTables field: array}; the
    synthetic optics by default) as the reference's SnowOptics text
    fixture: ``NSTEP 0``, then one line per table, its field name and its
    values in C order, each as ``repr(float)``, so that reading them back
    gives the same float64 bits."""
    from elmkernels_torch.data import params, synthetic
    if slots is None:
        slots = params.snicar_slots(synthetic.snicar_tables(), "synthetic")
    lines = ["NSTEP 0"]
    for name, arr in slots.items():
        vals = np.asarray(arr, np.float64).reshape(-1)
        lines.append(" ".join([name, *map(repr, vals.tolist())]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
