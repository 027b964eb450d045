"""Seeded inputs for holding the kernels against their plain versions, and
the reference-format files of the tests and ``chip_smoke.py``.

The ci solve's inputs are drawn in the ranges the canopy loop gives them
(leaf boundary-layer conductance, electron transport, Rubisco capacity,
respiration, CO2/O2 partial pressures), with a share of leaves pushed to
the edges where the secant search brackets a root (Brent) or runs out of
iterations.  The pentadiagonal systems are diagonally dominant with 0-5
identity-padded snow rows, like the soil/snow temperature system.  The
SNICAR inputs hold columns with 0-5 snow layers, and so do the snow
hydrology block's, with every branch of the block reached.  Numbers come from
``numpy.random.default_rng(seed)``, so the CPU tests and the card draw the
same inputs.
"""

from __future__ import annotations

import dataclasses

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
    horizon.  The sweep meets zero layers (``trntdr <= TRMIN`` under the
    thick packs) and, on the ~3 % of columns whose ground reflects all but
    2**-24 of the light, fluxes below PUNY that its clamp zeroes."""
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
    coszen = u(-0.1, 1.0, ncol)
    albsoi = u(0.05, 0.4, (ncol, 2))
    albsoi[u(0, 1, ncol) < 0.03] = 1.0 - 2.0 ** -24
    return dict(coszen=coszen, h2osno=h2osno, snl=snl, h2osoi_liq=liq,
                h2osoi_ice=ice, snw_rds=snw_rds, albsoi=albsoi,
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


def canopy_problem(n: int, seed: int, mode: str = "c3", dtype=torch.float64,
                   warm_start: bool = False, device="cpu") -> dict:
    """Seeded arguments of ``physics.canopy_fluxes.stability_iteration`` for
    ``n`` columns (by name; ``psn_mode=mode``), made in float64 as the
    step's set-up makes them (``initialize_flux``'s formulas for the
    Monin-Obukhov start, qsat of the leaf) and then cast to ``dtype``.

    About a tenth of the columns are bare (``frac_veg_nosno == 0``, with
    the set-up's zeros); a tenth are soybean (the btran boost); a fifth are
    night columns (no sun: no ci solve); the leaf starts up to 15 K from the
    air (Newton steps over 1 K); a third have a dry-air, near-calm surface
    layer whose Monin-Obukhov length flips sign from pass to pass; tall
    sparse canopies (trees) hold some columns at the 40-iteration cap.
    Traits are 0-d for "c3" and "c4" (a uniform grid: C3 grass, C4 grass)
    and per column for "mixed" (trees, C3 and C4 grasses, soybean).  With
    ``warm_start`` the ci carry ``ci_prev`` holds roots from a previous
    step, some 0 or NaN (a cold leaf)."""
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.physics import friction_velocity as fv
    from elmkernels_torch.physics.photosynthesis import PFTPsnParams
    from elmkernels_torch.physics.qsat import qsat
    rng = np.random.default_rng(seed)
    u = rng.uniform
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=f64)

    table = synthetic.pft_table()
    if mode == "mixed":
        pft = rng.choice([1, 4, 7, 10, 12, 14, 23], size=n)
    else:
        pft = np.full(n, 12 if mode == "c3" else 14)
    names = PFTPsnParams._fields
    vals = {k: table[k][pft] if k in table else np.full(n, -2.0)
            for k in names}
    if mode == "mixed":
        p = PFTPsnParams(*(t(vals[k]) for k in names))
    else:
        p = PFTPsnParams(*(t(vals[k][0]) for k in names))
    tree = pft <= 8

    veg = u(0, 1, n) >= 0.1
    soybean = (pft == 23) | (u(0, 1, n) < 0.1)
    night = u(0, 1, n) < 0.2
    snl = rng.integers(0, 6, n).astype(np.int32)
    nlevtot = c.NLEVSNO + c.NLEVGRND
    t_soisno = u(255.0, 300.0, (n, nlevtot))
    frac_sno = np.where(snl > 0, u(0.3, 1.0, n), u(0.0, 0.2, n))
    frac_h2osfc = u(0.0, 0.2, n) * (u(0, 1, n) < 0.5)
    frac_h2osfc = np.minimum(frac_h2osfc, 1.0 - frac_sno)
    forc_t = u(255.0, 310.0, n)
    forc_pbot = u(7.0e4, 1.03e5, n)
    thm = forc_t + 0.0098 * 30.0
    forc_th = forc_t * (1.0e5 / forc_pbot) ** 0.286
    qs_air = qsat(t(forc_t), t(forc_pbot)).qs.numpy()
    calm = u(0, 1, n) < 0.33
    forc_q = qs_air * np.where(calm, u(0.01, 0.1, n), u(0.2, 0.95, n))
    thv = forc_th * (1.0 + 0.61 * forc_q)
    t_grnd = forc_t + u(-8.0, 12.0, n)
    qg = qsat(t(t_grnd), t(forc_pbot)).qs.numpy() * u(0.3, 1.0, n)
    wind = np.where(calm, u(0.0, 1.5, n), u(1.0, 12.0, n))
    forc_u, forc_v = wind * 0.8, wind * 0.6
    htop = np.where(tree, u(8.0, 25.0, n), u(0.2, 1.5, n))
    elai = np.where(tree, u(0.3, 6.0, n), u(0.1, 4.0, n))
    esai = u(0.05, 1.0, n)
    # initialize_flux's roughness, displacement and longwave coefficients
    lt = np.minimum(elai + esai, 2.0)
    egvf = (1.0 - np.exp(-lt)) / (1.0 - np.exp(-2.0))
    z0mg = np.where(snl > 0, 0.0024, 0.01)
    displa = 0.67 * htop * egvf
    z0m = np.where(tree, 0.055, 0.12) * htop
    z0mv = np.exp(egvf * np.log(z0m) + (1.0 - egvf) * np.log(z0mg))
    z0qv = np.where(u(0, 1, n) < 0.1, z0mv * 0.5, z0mv)
    hgt_u = 30.0 + z0m + displa
    hgt_t = np.where(u(0, 1, n) < 0.1, hgt_u - 2.0, hgt_u)
    hgt_q = np.where(u(0, 1, n) < 0.5, hgt_t, hgt_u)
    emv = 1.0 - np.exp(-(elai + esai))
    emg = u(0.94, 0.99, n)
    forc_lwrad = u(180.0, 420.0, n)
    stebol = c.STEBOL
    air = emv * (1.0 + (1.0 - emv) * (1.0 - emg)) * forc_lwrad
    bir = -(2.0 - emv * (1.0 - emg)) * emv * stebol
    cir = emv * emg * stebol
    t_veg = forc_t + u(-15.0, 15.0, n)
    qs = qsat(t(t_veg), t(forc_pbot))
    taf = (t_grnd + thm) / 2.0
    qaf = (forc_q + qg) / 2.0
    ur = np.maximum(np.sqrt(forc_u ** 2 + forc_v ** 2), 1.0)
    dthv = (thm - taf) * (1.0 + 0.61 * forc_q) + 0.61 * forc_th * (
        forc_q - qaf)
    zldis = hgt_u - displa
    mo = fv.monin_obukhov_length(t(ur), t(thv), t(dthv), t(zldis), t(z0mv))

    par_sun = np.where(night, 0.0, u(5.0, 600.0, n))
    par_sha = np.where(night, 0.0, par_sun * u(0.05, 0.4, n))
    fsun = u(0.1, 0.8, n)
    fwet = u(0.0, 0.6, n) * (u(0, 1, n) < 0.5)
    # dry-leaf and wet-leaf columns with leaf water to evaporate
    h2ocan = np.where(fwet > 0.0, u(0.0, 0.5, n), 0.0)
    sabv = np.where(night, 0.0, u(20.0, 700.0, n))
    btran = np.where(u(0, 1, n) < 0.1, 0.0, u(0.05, 1.0, n))

    def w(a):
        """initialize_flux's zero for a bare column."""
        return np.where(veg, a, 0.0)
    args = dict(
        land=c.LandType(ltype=1, ctype=1, vtype=int(pft[0])), p=p,
        dtime=1800.0, snl=torch.as_tensor(snl),
        frac_veg_nosno=torch.as_tensor(veg.astype(np.int32)),
        frac_sno=frac_sno, forc_hgt_u_patch=hgt_u, forc_hgt_t_patch=hgt_t,
        forc_hgt_q_patch=hgt_q, fwet=fwet,
        fdry=(1.0 - fwet) * elai / (elai + esai),
        laisun=elai * fsun, laisha=elai * (1.0 - fsun),
        forc_rho=forc_pbot / (287.04 * forc_t),
        snow_depth=np.where(snl > 0, u(0.05, 1.5, n), u(0.0, 0.03, n)),
        soilbeta=u(0.0, 1.0, n), frac_h2osfc=frac_h2osfc,
        t_h2osfc=u(270.0, 300.0, n), sabv=sabv, h2ocan=h2ocan, htop=htop,
        t_soisno=t_soisno, air=w(air), bir=w(bir), cir=w(cir), ur=w(ur),
        zldis=w(zldis), displa=w(displa), elai=elai, esai=esai,
        t_grnd=t_grnd, forc_pbot=forc_pbot, forc_q=forc_q, forc_th=forc_th,
        z0mg=z0mg, z0mv=w(z0mv), z0hv=w(z0mv), z0qv=w(z0qv), thm=thm,
        thv=thv, qg=qg, nrad=np.ones(n), t10=forc_t + u(-5.0, 5.0, n),
        tlai_z=elai[:, None], vcmaxcintsha=u(0.3, 0.9, n)[:, None],
        vcmaxcintsun=u(0.6, 1.5, n)[:, None], parsha_z=par_sha[:, None],
        parsun_z=par_sun[:, None], laisha_z=(elai * (1.0 - fsun))[:, None],
        laisun_z=(elai * fsun)[:, None], forc_pco2=355e-6 * forc_pbot,
        forc_po2=0.209 * forc_pbot, dayl_factor=u(0.01, 1.0, n),
        btran=w(btran), el=w(qs.es.numpy()), qsatl=w(qs.qs.numpy()),
        qsatldT=w(qs.qsdT.numpy()), taf=w(taf), qaf=w(qaf),
        um=w(mo.um.numpy()), obu=w(mo.obu.numpy()),
        delq=w(qg - qaf), t_veg=np.where(veg, t_veg, forc_t),
        psn_mode=mode, soybean=torch.as_tensor(soybean),
        warm_start=warm_start, ci_prev=None)
    if warm_start:
        ci = 355e-6 * np.concatenate([forc_pbot, forc_pbot]) * u(
            0.3, 0.9, 2 * n)
        ci = np.where(u(0, 1, 2 * n) < 0.1, 0.0, ci)
        args["ci_prev"] = np.where(u(0, 1, 2 * n) < 0.05, np.nan, ci)
    for k, v in args.items():
        if isinstance(v, np.ndarray):
            args[k] = t(v)
    args["p"] = PFTPsnParams(*(v.to(dtype=dtype, device=device) for v in p))
    for k, v in args.items():
        if isinstance(v, torch.Tensor):
            args[k] = v.to(device=device, dtype=dtype
                           if v.is_floating_point() else v.dtype)
    return args


def snow_problem(n: int, seed: int, dtype=torch.float64,
                 elm_correct_snow_aging: bool = False,
                 aero_scalar: bool = False, urbpoi: bool = False,
                 device="cpu") -> dict:
    """Seeded arguments of ``physics.snow_hydrology.snow_hydrology_block``
    for ``n`` columns (by name), made in float64 and cast to ``dtype``.

    Columns hold 0-5 snow layers; some layerless columns carry a pack
    (``h2osno > 0``).  Layers are drawn too thin and too thick for every
    rung of the divide ladder (single layers above 0.03 m, the thickest
    near 1 m), some with ice <= 0.01 at the top or the bottom of the pack
    (and some that dissolve the pack), some with negative liquid at the
    top and some so dense that percolation is blocked; temperatures sit on
    both sides of freezing with melting and refreezing layers
    (``imelt``, ``qflx_snofrz_lyr``).  Land units are drawn per column
    among soil, crop, ice sheet, wetland and urban (``urbpoi`` makes every
    column soil-like, as an urban domain is); a tenth of the columns cap
    their snow (``do_capsnow``).  The deposition rates are [n] (a monthly
    climatology, as the model gives them) or 0-d (``aero_scalar``: the
    kernel reads such a rate with a stride of 0; the plain block takes it
    expanded to [n]).
    Inactive positions hold stale values, which the block carries as the
    step does.  The aging tables are ``data.synthetic``'s."""
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.data.state import AERO_DEP_KEYS, AERO_SPECIES
    rng = np.random.default_rng(seed)
    u = rng.uniform
    ns, nt = c.NLEVSNO, c.NLEVTOT
    snl = rng.integers(0, ns + 1, n)
    top = ns - snl
    pos = np.arange(nt)[None, :]
    act = (pos >= top[:, None]) & (pos < ns)
    # layer thickness: thin, ordinary and thick layers on every rung
    dz = np.where(u(0, 1, (n, nt)) < 0.3, u(0.002, 0.03, (n, nt)),
                  u(0.02, 0.5, (n, nt)))
    dz = np.where(u(0, 1, (n, nt)) < 0.08, u(0.5, 1.0, (n, nt)), dz)
    fse = np.where(u(0, 1, n) < 0.1, 0.0, u(0.05, 1.0, n))
    fse = np.where(u(0, 1, n) < 0.2, 1.0, fse)
    frac_sno = np.where(u(0, 1, n) < 0.5, fse, u(0.0, 1.0, n))
    # bulk density 30-900 kg/m3; a twentieth near ice (percolation blocked)
    rho = u(30.0, 600.0, (n, nt))
    rho = np.where(u(0, 1, (n, nt)) < 0.05, u(880.0, 917.0, (n, nt)), rho)
    wet = u(0, 1, (n, nt)) < 0.4
    liq_share = np.where(wet, u(0.0, 0.15, (n, nt)), 0.0)
    mass = rho * dz * np.maximum(fse, 0.05)[:, None]
    ice = mass * (1.0 - liq_share)
    liq = mass * liq_share
    # ice <= 0.01 at the top and at the bottom of some packs
    tiny = u(0, 1, (n, nt)) < 0.06
    ice = np.where(tiny, u(0.0, 0.01, (n, nt)), ice)
    # negative liquid at the top of some packs
    at_top = pos == top[:, None]
    liq = np.where(at_top & (u(0, 1, (n, nt)) < 0.1),
                   -u(0.0, 0.5, (n, nt)), liq)
    t = np.where(u(0, 1, (n, nt)) < 0.3, u(272.0, 274.5, (n, nt)),
                 u(240.0, 273.1, (n, nt)))
    # soil rows: wet and frozen soil
    soil = pos >= ns
    liq = np.where(soil, u(0.0, 50.0, (n, nt)), liq)
    ice = np.where(soil, u(0.0, 20.0, (n, nt)), ice)
    t = np.where(soil, u(260.0, 290.0, (n, nt)), t)
    dz = np.where(soil, u(0.02, 0.6, (n, nt)), dz)
    # inactive snow positions: zeros, or stale values from earlier steps
    stale = u(0, 1, (n, nt)) < 0.3
    keep = act | soil | stale
    liq, ice, t, dz = (np.where(keep, a, 0.0) for a in (liq, ice, t, dz))
    # the mesh: soil nodes below 0, snow above, from the thicknesses
    zi = np.zeros((n, nt + 1))
    zi[:, ns + 1:] = np.cumsum(dz[:, ns:], axis=1)
    for i in range(ns - 1, -1, -1):
        zi[:, i] = np.where(act[:, i], zi[:, i + 1] - dz[:, i], 0.0)
    z = np.where(act | soil, 0.5 * (zi[:, :-1] + zi[:, 1:]), 0.0)
    h2osno = np.sum(np.where(act, liq + ice, 0.0), axis=1)
    layerless_pack = (snl == 0) & (u(0, 1, n) < 0.5)
    h2osno = np.where(layerless_pack, u(0.0, 30.0, n), h2osno)
    snow_depth = np.where(snl > 0, np.sum(np.where(act, dz, 0.0), 1),
                          h2osno / 250.0)
    int_snow = np.where(u(0, 1, n) < 0.1, 0.0,
                        np.maximum(h2osno, 0.0) * u(1.0, 3.0, n))

    def flux(lo, hi, zero=0.3):
        return np.where(u(0, 1, n) < zero, 0.0, u(lo, hi, n))
    melt = u(0, 1, (n, nt)) < 0.25
    imelt = np.where(melt, 1, np.where(u(0, 1, (n, nt)) < 0.15, 2, 0))
    wx = ice[:, :ns] + liq[:, :ns]
    swe_old = np.where(u(0, 1, (n, ns)) < 0.5, wx * u(1.0, 1.3, (n, ns)),
                       wx * u(0.7, 1.0, (n, ns)))
    frac_iceold = np.where(u(0, 1, (n, nt)) < 0.1, 0.0,
                           u(0.0, 1.0, (n, nt)))
    rds = np.where(u(0, 1, (n, ns)) < 0.2, c.SNW_RDS_MIN,
                   u(c.SNW_RDS_MIN, c.SNW_RDS_MAX, (n, ns)))
    rds = np.where(act[:, :ns] | stale[:, :ns], rds, 0.0)
    snofrz = np.where(imelt[:, :ns] == 2, u(0.0, 2e-3, (n, ns)), 0.0)
    mss = {k: np.where(act[:, :ns] | stale[:, :ns],
                       u(0.0, 1e-6, (n, ns)), 0.0) for k in AERO_SPECIES}
    if aero_scalar:
        aero = {k: np.float64(u(1e-13, 1e-10)) for k in AERO_DEP_KEYS}
    else:
        aero = {k: u(1e-13, 1e-10, n) for k in AERO_DEP_KEYS}
    land_types = np.array([c.ISTSOIL, c.ISTCROP, c.ISTICE, c.ISTICE_MEC,
                           c.ISTWET, c.ISTURB_MIN, c.ISTURB_HD])
    ltype = land_types[rng.integers(0, land_types.size, n)]
    ltype = np.where(u(0, 1, n) < 0.4, c.ISTSOIL, ltype)
    tables = synthetic.snow_aging_tables()

    def f(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    def i64(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64, device=device)
    return dict(
        land=c.LandType(ltype=i64(ltype), urbpoi=urbpoi), dtime=1800.0,
        do_capsnow=i64(u(0, 1, n) < 0.1), snl=i64(snl),
        frac_sno_eff=f(fse), frac_sno=f(frac_sno), h2osno=f(h2osno),
        snow_depth=f(snow_depth), int_snow=f(int_snow),
        qflx_sub_snow=f(flux(-2e-5, 1e-4)),
        qflx_evap_grnd=f(flux(-5e-5, 2e-4)),
        qflx_dew_snow=f(flux(0.0, 5e-5, 0.5)),
        qflx_dew_grnd=f(flux(0.0, 5e-5, 0.5)),
        qflx_rain_grnd=f(flux(0.0, 2e-3, 0.5)),
        qflx_snomelt=f(flux(0.0, 1e-3)), qflx_snow_melt=f(flux(0.0, 1e-3)),
        h2osoi_liq=f(liq), h2osoi_ice=f(ice), t_soisno=f(t), dz=f(dz),
        z=f(z), zi=f(zi), mss={k: f(v) for k, v in mss.items()},
        aero_in={k: f(v) for k, v in aero.items()},
        n_melt=f(u(1.0, 20.0, n)), imelt=i64(imelt), swe_old=f(swe_old),
        frac_iceold=f(frac_iceold), snw_rds=f(rds),
        qflx_snwcp_ice=f(flux(0.0, 1e-3, 0.5)),
        qflx_snow_grnd=f(flux(0.0, 2e-3, 0.5)), qflx_snofrz_lyr=f(snofrz),
        snowage_tau=f(tables["tau"]), snowage_kappa=f(tables["kappa"]),
        snowage_drdt0=f(tables["drdsdt0"]),
        elm_correct_snow_aging=elm_correct_snow_aging)


# the layered arguments of snow_hydrology_block ([ncol, L] or [ncol, 5])
SNOW_LAYERED = ("h2osoi_liq", "h2osoi_ice", "t_soisno", "dz", "z", "zi",
                "imelt", "swe_old", "frac_iceold", "snw_rds",
                "qflx_snofrz_lyr")


def snow_layers_as_views(args: dict) -> dict:
    """``snow_problem``'s arguments with every layered input (the masses and
    ``imelt`` included) a view of an array twice as wide: the same values,
    a row stride twice the width, as the packed carry's fields are views of
    one wide buffer."""
    def view(t):
        return torch.cat([t, torch.full_like(t, -7)], 1)[:, :t.shape[1]]
    out = dict(args, **{k: view(args[k]) for k in SNOW_LAYERED})
    out["mss"] = {k: view(v) for k, v in args["mss"].items()}
    return out


def snow_columns_interleaved(args: dict) -> dict:
    """``snow_problem``'s columns reordered so that consecutive columns
    cycle through the layer counts 0-5 as long as each lasts: every warp
    of the kernel then mixes packs of every depth."""
    snl = args["snl"].cpu()
    n = snl.shape[0]
    groups = [torch.nonzero(snl == k).flatten().tolist()
              for k in range(c.NLEVSNO + 1)]
    order = [g[j] for j in range(max(map(len, groups), default=0))
             for g in groups if j < len(g)]
    perm = torch.tensor(order, dtype=torch.int64, device=args["snl"].device)

    def take(v):
        if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == n:
            return v.index_select(0, perm)
        if isinstance(v, dict):
            return {k: take(x) for k, x in v.items()}
        return v
    out = {k: take(v) for k, v in args.items()
           if not k.startswith("snowage_")}
    land = args["land"]
    out["land"] = dataclasses.replace(land, ltype=take(land.ltype))
    return dict(args, **out)


def soil_temperature_problem(n: int, seed: int, dtype=torch.float64,
                             land: str = "column", kind: str = "mixed",
                             device="cpu") -> dict:
    """Seeded arguments of ``physics.soil_temperature.
    soil_temperature_block`` for ``n`` columns (by name), made in float64
    and cast to ``dtype``.

    Columns hold 0-5 snow layers over 15 soil layers with a mesh built from
    the thicknesses; temperatures sit on both sides of freezing, in snow
    and soil, with ice and liquid in every layer (some soil layers with
    less liquid than the supercooled water they may hold, some with less
    water in all), and the surface fluxes are large enough that layers
    melt, freeze and stay.  Standing surface water covers half the columns
    (``frac_h2osfc`` 0 on the others), cold on most of them, some of it too
    shallow to freeze only in part; a quarter of the layerless columns
    carry a thin pack (``h2osno > 0``) over soil that melts it; a tenth of
    the columns have a ground heat-flux derivative so large (``cgrnd`` far
    below 0) that the phase change's round-off guard cancels it.  Inactive
    snow positions hold stale values, which the module carries as the step
    does.  ``land`` is "column" (an [n] land-type tensor among soil, crop,
    ice sheet, wetland and urban), "soil" (one soil land type: the
    supercooled water everywhere) or "ice" (one ice-sheet type: none).
    ``kind`` "july" gives no column snow layers and soil above freezing but
    for a tenth of the columns (a summer noon's global grid), "spring"
    1-5 snow layers on every column over frozen soil (a high-latitude
    spring's snowpack)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform
    ns, nt, ng = c.NLEVSNO, c.NLEVTOT, c.NLEVGRND
    snl = {"mixed": lambda: rng.integers(0, ns + 1, n),
           "july": lambda: np.zeros(n, np.int64),
           "spring": lambda: rng.integers(1, ns + 1, n)}[kind]()
    top = ns - snl
    pos = np.arange(nt)[None, :]
    act = (pos >= top[:, None]) & (pos < ns)
    soil = pos >= ns
    dz = np.where(act, u(0.01, 0.15, (n, nt)), 0.0)
    dz = np.where(soil, u(0.015, 0.06, (n, nt)) * 1.45 ** (pos - ns), dz)
    stale = ~act & ~soil & (u(0, 1, (n, nt)) < 0.3)
    dz = np.where(stale, u(0.01, 0.1, (n, nt)), dz)
    zi = np.zeros((n, nt + 1))
    zi[:, ns + 1:] = np.cumsum(dz[:, ns:], axis=1)
    for i in range(ns - 1, -1, -1):
        zi[:, i] = np.where(act[:, i], zi[:, i + 1] - dz[:, i], 0.0)
    z = np.where(act | soil, 0.5 * (zi[:, :-1] + zi[:, 1:]), 0.0)
    z = np.where(stale, u(-0.5, 0.0, (n, nt)), z)
    tfrz = c.TFRZ
    cold = u(0, 1, n) < 0.5
    t = np.where(cold[:, None], u(tfrz - 12.0, tfrz + 0.5, (n, nt)),
                 u(tfrz - 2.0, tfrz + 8.0, (n, nt)))
    if kind == "july":
        t = np.where(soil & (u(0, 1, n) < 0.9)[:, None],
                     u(tfrz + 2.0, tfrz + 25.0, (n, nt)), t)
    elif kind == "spring":
        t = np.where(soil, u(tfrz - 10.0, tfrz - 0.5, (n, nt)), t)
    t = np.where(act, np.minimum(t, tfrz + 0.3), t)
    t = np.where(act | soil | stale, t, 0.0)
    ice = np.where(act, u(0.5, 40.0, (n, nt)), u(0.0, 60.0, (n, nt)))
    liq = np.where(act, np.where(u(0, 1, (n, nt)) < 0.5, 0.0,
                                 u(0.0, 4.0, (n, nt))),
                   u(0.0, 80.0, (n, nt)))
    # soil water below the supercooled amount, and soil nearly dry
    dry = soil & (u(0, 1, (n, nt)) < 0.15)
    liq = np.where(dry, u(0.0, 0.5, (n, nt)), liq)
    ice = np.where(soil & (u(0, 1, (n, nt)) < 0.05), u(0.0, 0.05, (n, nt)),
                   ice)
    ice = np.where(act | soil | stale, ice, 0.0)
    liq = np.where(act | soil | stale, liq, 0.0)
    tk = np.where(act | soil, u(0.05, 2.5, (n, nt)), 0.0)
    cv = np.where(act, u(2e3, 6e4, (n, nt)),
                  np.where(soil, u(5e4, 4e5, (n, nt)), 0.0))
    cv = np.where(act | soil, cv, np.where(stale, 1e4, 0.0))
    fse = np.where(snl > 0, u(0.3, 1.0, n), np.where(
        u(0, 1, n) < 0.5, 0.0, u(0.0, 0.6, n)))
    frac_sno = np.where(u(0, 1, n) < 0.5, fse, u(0.0, 1.0, n))
    h2osno = np.sum(np.where(act, ice + liq, 0.0), axis=1)
    thin = (snl == 0) & (u(0, 1, n) < 0.25)
    h2osno = np.where(thin, u(0.01, 5.0, n), h2osno)
    # the thin packs lie on soil that melts them
    t[:, ns] = np.where(thin, u(tfrz + 0.5, tfrz + 6.0, n), t[:, ns])
    snow_depth = np.where(snl > 0, np.sum(np.where(act, dz, 0.0), 1),
                          h2osno / 250.0)
    int_snow = np.maximum(h2osno, 0.0) * u(1.0, 2.0, n)
    wet = u(0, 1, n) < 0.5
    fh = np.where(wet, u(0.02, 0.6, n), 0.0)
    h2osfc = np.where(wet, np.where(u(0, 1, n) < 0.4, u(0.0, 0.3, n),
                                    u(0.3, 60.0, n)), 0.0)
    t_h2osfc = np.where(u(0, 1, n) < 0.7, u(tfrz - 8.0, tfrz, n),
                        u(tfrz, tfrz + 6.0, n))
    dz_h2osfc = np.where(wet, 1e-3 * h2osfc / np.maximum(fh, 1e-3), 0.0)
    c_h2osfc = np.where(wet, c.CPWAT * h2osfc, 0.0)
    tk_h2osfc = np.where(wet, u(0.4, 0.7, n), 0.0)
    emg = u(0.95, 0.99, n)
    htvp = np.where(u(0, 1, n) < 0.5, c.HVAP, c.HSUB)
    cgrnd = np.where(u(0, 1, n) < 0.1, u(-400.0, -150.0, n),
                     u(0.0, 60.0, n))

    def flux(lo, hi):
        return u(lo, hi, n)
    watsat = u(0.3, 0.55, (n, ng))
    sucsat = u(10.0, 600.0, (n, ng))
    bsw = u(2.5, 12.0, (n, ng))
    if land == "column":
        types = np.array([c.ISTSOIL, c.ISTCROP, c.ISTICE, c.ISTWET,
                          c.ISTURB_MIN])
        ltype = torch.tensor(types[rng.integers(0, types.size, n)],
                             dtype=torch.int64, device=device)
    else:
        ltype = {"soil": c.ISTSOIL, "ice": c.ISTICE}[land]

    def f(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)
    return dict(
        land=c.LandType(ltype=ltype), dtime=1800.0,
        snl=torch.tensor(snl, dtype=torch.int64, device=device),
        frac_veg_nosno=torch.tensor(u(0, 1, n) < 0.5, dtype=torch.int64,
                                    device=device),
        frac_sno_eff=f(fse), frac_sno=f(frac_sno), frac_h2osfc=f(fh),
        h2osfc=f(h2osfc), h2osno=f(h2osno), int_snow=f(int_snow),
        snow_depth=f(snow_depth), t_grnd=f(u(tfrz - 15.0, tfrz + 15.0, n)),
        t_h2osfc=f(t_h2osfc), sabg_snow=f(flux(0.0, 500.0)),
        sabg_soil=f(flux(0.0, 600.0)),
        sabg_lyr=f(u(0.0, 120.0, (n, ns + 1))), dlrad=f(flux(150.0, 350.0)),
        emg=f(emg), forc_lwrad=f(flux(180.0, 420.0)), htvp=f(htvp),
        eflx_sh_soil=f(flux(-80.0, 200.0)),
        qflx_ev_soil=f(flux(-2e-5, 1.5e-4)),
        eflx_sh_h2osfc=f(flux(-80.0, 200.0)),
        qflx_ev_h2osfc=f(flux(-2e-5, 1.5e-4)),
        eflx_sh_snow=f(flux(-80.0, 200.0)),
        qflx_ev_snow=f(flux(-2e-5, 1.5e-4)), cgrnd=f(cgrnd),
        t_soisno=f(t), h2osoi_liq=f(liq), h2osoi_ice=f(ice), dz=f(dz),
        z=f(z), zi=f(zi), tk=f(tk), cv=f(cv), dz_h2osfc=f(dz_h2osfc),
        c_h2osfc=f(c_h2osfc), tk_h2osfc=f(tk_h2osfc), watsat=f(watsat),
        sucsat=f(sucsat), bsw=f(bsw))
