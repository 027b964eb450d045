"""SNICAR-AD snow albedo: 5-band spectral Delta-Eddington adding-doubling
radiative transfer with aerosol (BC/OC/dust) effects — batched over columns.

Counterpart of ``elmkernels_tpu/physics/snow_snicar.py`` (reference
``src/physics/snow_snicar_impl.hh:5-773``, from ELM's SNICAR_AD_RT).
Layers above a column's top active layer are identity layers
(transmission 1, reflection 0), so the surface albedo is read at interface
0 with no per-column indexing.  The two layer recursions (``lax.scan`` in
the JAX package) are Python loops over the five layers.  Arrays in the
sweep are laid out [B, nsno, ncol] as in the JAX package.

The step calls :func:`snicar_ad_rt_both`, which runs K3
(``ops.snicar.snicar``, one CUDA kernel) on the card and
:func:`snicar_ad_rt_both_plain` on the CPU or under a tangent.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.ops import tangents
from elmkernels_torch.physics.math_utils import (const, levels, safe_div,
                                                 take_layer)

MIN_SNW = 1.0e-30        # minimum snow mass for RT calculation [kg/m^2]
IDX_BC_NCLRDS_MAX = 9
IDX_BCINT_ICERDS_MAX = 7
IDX_MIE_SNW_MX = 1471
SNW_RDS_MAX_TBL = 1500
SNW_RDS_MIN_TBL = 30

_TRMIN = 0.001
_PUNY = 1.0e-11
_ARGMAX = 10.0

# 8-point Gaussian angles/weights for diffuse integration
_DIFGAUSPT = (0.9894009, 0.9445750, 0.8656312, 0.7554044,
              0.6178762, 0.4580168, 0.2816036, 0.0950125)
_DIFGAUSWT = (0.0271525, 0.0622535, 0.0951585, 0.1246290,
              0.1495960, 0.1691565, 0.1826034, 0.1894506)

# 5-band incident flux weights (snow_albedo_radiation_factor)
_FLX_WGT_DRC = (1.0, 0.49352158521175, 0.18099494230665, 0.12094898498813,
                0.20453448749347)
_FLX_WGT_DFS = (1.0, 0.58581507618433, 0.20156903770812, 0.10917889346386,
                0.10343699264369)

_MU_MIN = 0.01           # least cosine of the solar zenith in the sweep
# near-IR direct adjustment for high solar zenith angle (impl:747-760):
# below cos(75 deg), the factor c1 (log10(r_top) - 6) + c0 with c1, c0 each
# a0 - a1 mu + a2 mu^2
_MU_75 = 0.2588
_SZA_C1 = (0.085730, 0.630883, 1.303723)
_SZA_C0 = (1.467291, 3.338043, 6.807489)


class SnicarTables(NamedTuple):
    """Snow/aerosol optics lookup tables (reference ``SnicarData``)."""
    ss_alb_oc1: torch.Tensor        # [5]
    asm_prm_oc1: torch.Tensor
    ext_cff_mss_oc1: torch.Tensor
    ss_alb_oc2: torch.Tensor
    asm_prm_oc2: torch.Tensor
    ext_cff_mss_oc2: torch.Tensor
    ss_alb_dst1: torch.Tensor
    asm_prm_dst1: torch.Tensor
    ext_cff_mss_dst1: torch.Tensor
    ss_alb_dst2: torch.Tensor
    asm_prm_dst2: torch.Tensor
    ext_cff_mss_dst2: torch.Tensor
    ss_alb_dst3: torch.Tensor
    asm_prm_dst3: torch.Tensor
    ext_cff_mss_dst3: torch.Tensor
    ss_alb_dst4: torch.Tensor
    asm_prm_dst4: torch.Tensor
    ext_cff_mss_dst4: torch.Tensor
    ss_alb_snw_drc: torch.Tensor    # [5, 1471]
    asm_prm_snw_drc: torch.Tensor
    ext_cff_mss_snw_drc: torch.Tensor
    ss_alb_snw_dfs: torch.Tensor
    asm_prm_snw_dfs: torch.Tensor
    ext_cff_mss_snw_dfs: torch.Tensor
    ss_alb_bc1: torch.Tensor        # [10, 5]
    asm_prm_bc1: torch.Tensor
    ext_cff_mss_bc1: torch.Tensor
    ss_alb_bc2: torch.Tensor
    asm_prm_bc2: torch.Tensor
    ext_cff_mss_bc2: torch.Tensor
    bcenh: torch.Tensor             # [8, 10, 5]


class SnicarOut(NamedTuple):
    albout: torch.Tensor   # [ncol, numrad]   (albsnd or albsni)
    flx_abs: torch.Tensor  # [ncol, NLEVSNO+1, numrad] layer absorption


def _snicar_core(band_id_b, is_drc_b, snw_ss_b, snw_asm_b, snw_ext_b,
                 coszen, h2osno, snl, h2osoi_liq, h2osoi_ice, snw_rds,
                 albsoi, mss_cnc_aer, tables: SnicarTables):
    """Band-generic SNICAR-AD sweep over B band rows (``band_id_b`` maps
    each row to its spectral band, ``is_drc_b`` marks direct rows).

    Returns (albout_lcl [B, ncol], flx_abs_lcl [B, ncol, nsno+1],
    mu_not, snw_rds_lcl, snl_top, active).
    """
    nsno = c.NLEVSNO
    nbnd = c.NUMRAD_SNW
    B = band_id_b.shape[0]
    ncol = coszen.shape[0]
    dtype = coszen.dtype

    active = (coszen > 0.0) & (h2osno > MIN_SNW)

    # ---- init_timestep (impl:7-103) ----
    nosnl = snl == 0
    snl_lcl = torch.where(nosnl, 1, snl)
    snl_top = nsno - snl_lcl  # [ncol] index of top active snow layer

    lev = levels(nsno, snl)
    bot = lev == nsno - 1
    ice_lcl = torch.where(nosnl[:, None],
                          torch.where(bot[None, :], h2osno[:, None], 0.0),
                          h2osoi_ice[:, :nsno])
    liq_lcl = torch.where(nosnl[:, None], 0.0, h2osoi_liq[:, :nsno])
    snw_rds_lcl = torch.where(nosnl[:, None], round(c.SNW_RDS_MIN),
                              torch.round(snw_rds).to(torch.int32))

    mu_not = torch.clamp(coszen, min=_MU_MIN)

    is_lyr_active = lev[None, :] >= snl_top[:, None]  # [ncol, nsno]

    # ---- snow_aerosol_mie_params (impl:105-309) ----
    r = snw_rds_lcl
    idx_icerds = torch.where(
        r < 125, r // 50 - 1, torch.where(r < 175, 1, r // 250 + 1))
    idx_icerds = torch.clamp(idx_icerds, 0, IDX_BCINT_ICERDS_MAX).long()
    idx_bc_nclrds = 1  # round(100nm/50)-1, static for both int/ext BC

    rds_idx = torch.clamp(r - SNW_RDS_MIN_TBL, 0, IDX_MIE_SNW_MX - 1).long()

    L_snw = (ice_lcl + liq_lcl).T  # [nsno, ncol]
    ridx = rds_idx.T               # [nsno, ncol]
    ss_snw = snw_ss_b[:, ridx]     # [B, nsno, ncol]
    asm_snw = snw_asm_b[:, ridx]
    ext_snw = snw_ext_b[:, ridx]

    # aerosols ignored in bands 4,5 (impl:146-152)
    band_has_aer = (band_id_b < 3)[:, None, None, None]
    mss_t = mss_cnc_aer.permute(2, 1, 0)                   # [8, nsno, ncol]
    mss_b = torch.where(band_has_aer, mss_t[None], 0.0)    # [B, 8, nsno, ncol]
    bcenh_t = tables.bcenh[:, idx_bc_nclrds, :]            # [8, nbnd]
    bcenh_b = bcenh_t[:, band_id_b]                        # [8, B]
    enh = bcenh_b[idx_icerds.T].permute(2, 0, 1)           # [B, nsno, ncol]
    ss_aer = torch.stack([
        tables.ss_alb_bc1[idx_bc_nclrds].expand(nbnd),
        tables.ss_alb_bc2[idx_bc_nclrds], tables.ss_alb_oc1,
        tables.ss_alb_oc2, tables.ss_alb_dst1, tables.ss_alb_dst2,
        tables.ss_alb_dst3, tables.ss_alb_dst4], dim=1)[band_id_b]
    asm_aer = torch.stack([
        tables.asm_prm_bc1[idx_bc_nclrds], tables.asm_prm_bc2[idx_bc_nclrds],
        tables.asm_prm_oc1, tables.asm_prm_oc2, tables.asm_prm_dst1,
        tables.asm_prm_dst2, tables.asm_prm_dst3, tables.asm_prm_dst4],
        dim=1)[band_id_b]
    ext_aer_scalar = torch.stack([
        torch.zeros_like(tables.ext_cff_mss_oc1),
        tables.ext_cff_mss_bc2[idx_bc_nclrds],
        tables.ext_cff_mss_oc1, tables.ext_cff_mss_oc2,
        tables.ext_cff_mss_dst1, tables.ext_cff_mss_dst2,
        tables.ext_cff_mss_dst3, tables.ext_cff_mss_dst4],
        dim=1)[band_id_b]                                  # [B, 8]

    tau_snw = L_snw[None] * ext_snw
    ext_all = ext_aer_scalar[:, :, None, None].expand(
        B, c.SNO_NBR_AER, nsno, ncol).clone()
    # within-ice BC (species 0) carries the per-layer enhancement factor
    ext_all[:, 0] = (tables.ext_cff_mss_bc1[idx_bc_nclrds][band_id_b]
                     [:, None, None] * enh)
    tau_aer = L_snw[None, None] * mss_b * ext_all
    tau_sum = torch.sum(tau_aer, dim=1)
    omega_sum = torch.sum(tau_aer * ss_aer[:, :, None, None], dim=1)
    g_sum = torch.sum(tau_aer * ss_aer[:, :, None, None]
                      * asm_aer[:, :, None, None], dim=1)
    del tau_aer, ext_all, mss_b

    tau = tau_sum + tau_snw
    omega = safe_div(omega_sum + ss_snw * tau_snw, tau, tau > 0.0)
    g = safe_div(g_sum + asm_snw * ss_snw * tau_snw, tau * omega,
                 (tau > 0.0) & (omega > 0.0))

    # Delta transformation (impl:293-298); arrays [B, nsno, ncol]
    g_star = g / (1.0 + g)
    omega_star = ((1.0 - g ** 2) * omega) / (1.0 - omega * g ** 2)
    tau_star = (1.0 - omega * g ** 2) * tau

    # ---- snow_radiative_transfer_solver (impl:311-669) ----
    exp_min = math.exp(-_ARGMAX)
    ts_b, ws_b, gs_b = tau_star, omega_star, g_star

    # per-layer Delta-Eddington apparent optical properties
    lm = torch.sqrt(torch.clamp(
        3.0 * (1.0 - ws_b) * (1.0 - ws_b * gs_b), min=0.0))
    lm_s = torch.where(lm > 0.0, lm, 1.0)
    ue = 1.5 * (1.0 - ws_b * gs_b) / lm_s
    extins = torch.clamp(torch.exp(-lm * ts_b), min=exp_min)
    ne = ((ue + 1.0) ** 2 / extins) - ((ue - 1.0) ** 2 * extins)
    rdif_de = (ue ** 2 - 1.0) * (1.0 / extins - extins) / ne
    tdif_de = 4.0 * ue / ne
    mu0 = mu_not[None, None, :]
    trnlay_c = torch.clamp(torch.exp(-ts_b / mu0), min=exp_min)

    denom0 = 1.0 - lm ** 2 * mu0 ** 2
    alp0 = 0.75 * ws_b * mu0 * (1.0 + gs_b * (1.0 - ws_b)) / denom0
    gam0 = 0.5 * ws_b * (1.0 + 3.0 * gs_b * (1.0 - ws_b) * mu0 ** 2) / denom0
    apg0 = alp0 + gam0
    amg0 = alp0 - gam0
    rdir_c = apg0 * rdif_de + amg0 * (tdif_de * trnlay_c - 1.0)
    tdir_c = apg0 * tdif_de + (amg0 * rdif_de - apg0 + 1.0) * trnlay_c

    # Gaussian angular re-integration of rdif/tdif (impl:456-484), as the
    # JAX package's five-accumulator form
    alp_f = 0.75 * ws_b * (1.0 + gs_b * (1.0 - ws_b))
    gam_f1 = 0.5 * ws_b
    gam_f2 = 1.5 * ws_b * gs_b * (1.0 - ws_b)
    lm2 = lm * lm
    s_apg = s_amg = t_apg = t_amg = t_0 = 0.0
    swt = 0.0
    for mu_g, wt_g in zip(_DIFGAUSPT, _DIFGAUSWT):
        muw = mu_g * wt_g
        swt += muw
        trn = torch.clamp(torch.exp(-ts_b / mu_g), min=exp_min)
        inv_d = 1.0 / (1.0 - lm2 * (mu_g * mu_g))
        alp = alp_f * mu_g * inv_d
        gam = (gam_f1 + gam_f2 * (mu_g * mu_g)) * inv_d
        apg = alp + gam
        amg = alp - gam
        s_apg = s_apg + muw * apg
        s_amg = s_amg + muw * amg
        t_apg = t_apg + muw * (apg * trn)
        t_amg = t_amg + muw * (amg * trn)
        t_0 = t_0 + muw * trn
    rdif_c = (rdif_de * s_apg + tdif_de * t_amg - s_amg) / swt
    tdif_c = (tdif_de * s_apg + rdif_de * t_amg - t_apg + t_0) / swt

    # --- top-down interface recursion (impl:403-510) over layers ---
    one = torch.ones((B, ncol), dtype=dtype, device=coszen.device)
    zero = torch.zeros((B, ncol), dtype=dtype, device=coszen.device)
    act_l = is_lyr_active.T[:, None, :].expand(nsno, B, ncol)

    trndir_i, trntdr_i, trndif_i, rdndif_i = one, one, one, zero
    trndir, trntdr, trndif, rdndif = [], [], [], []
    layers = []
    for k in range(nsno):
        act = act_l[k]
        compute = act & (trntdr_i > _TRMIN)

        def sel(comp_val, ident_val):
            return torch.where(compute, comp_val,
                               torch.where(act, zero, ident_val))
        rdir = sel(rdir_c[:, k], zero)
        tdir = sel(tdir_c[:, k], one)
        trnlay = sel(trnlay_c[:, k], one)
        rdif_a = sel(rdif_c[:, k], zero)
        tdif_a = sel(tdif_c[:, k], one)
        layers.append((rdir, tdir, trnlay, rdif_a, tdif_a))
        trndir.append(trndir_i)
        trntdr.append(trntdr_i)
        trndif.append(trndif_i)
        rdndif.append(rdndif_i)

        refkm1 = 1.0 / (1.0 - rdndif_i * rdif_a)
        tdrrdir = trndir_i * rdir
        tdndif = trntdr_i - trndir_i
        trndir_i, trntdr_i, trndif_i, rdndif_i = (
            trndir_i * trnlay,
            trndir_i * tdir
            + (tdndif + tdrrdir * rdndif_i) * refkm1 * tdif_a,
            trndif_i * refkm1 * tdif_a,
            rdif_a + tdif_a * rdndif_i * refkm1 * tdif_a)
    trndir = torch.stack(trndir + [trndir_i])   # [nsno+1, B, ncol]
    trntdr = torch.stack(trntdr + [trntdr_i])
    trndif = torch.stack(trndif + [trndif_i])
    rdndif = torch.stack(rdndif + [rdndif_i])

    # --- bottom-up reflectivity recursion (impl:526-544) ---
    # underlying ground albedo: vis for band 0, nir for bands 1-4
    band_is_vis = (band_id_b == 0)[:, None]
    soil_alb = torch.where(band_is_vis, albsoi[None, :, 0],
                           albsoi[None, :, 1])
    rup_dir_p1, rup_dif_p1 = soil_alb, soil_alb
    rupdir, rupdif = [soil_alb], [soil_alb]
    for k in range(nsno - 1, -1, -1):
        rdir, tdir, trnlay, rdif_a, tdif_a = layers[k]
        refkp1 = 1.0 / (1.0 - rdif_a * rup_dif_p1)
        rup_dir_p1, rup_dif_p1 = (
            rdir + (trnlay * rup_dir_p1 + (tdir - trnlay) * rup_dif_p1)
            * refkp1 * tdif_a,
            rdif_a + tdif_a * rup_dif_p1 * refkp1 * tdif_a)
        rupdir.insert(0, rup_dir_p1)
        rupdif.insert(0, rup_dif_p1)
    rupdir = torch.stack(rupdir)
    rupdif = torch.stack(rupdif)

    # --- net interface fluxes (impl:560-588) ---
    is_drc_e = is_drc_b[:, None]
    refk = 1.0 / (1.0 - rdndif * rupdif)
    dfdir = (trndir + (trntdr - trndir) * (1.0 - rupdif) * refk
             - trndir * rupdir * (1.0 - rdndif) * refk)
    dfdir = torch.where(dfdir < _PUNY, 0.0, dfdir)
    dfdif = trndif * (1.0 - rupdif) * refk
    dfdif = torch.where(dfdif < _PUNY, 0.0, dfdif)
    dftmp = torch.where(is_drc_e[None], dfdir, dfdif)  # [nsno+1, B, ncol]

    albout_lcl = torch.where(is_drc_e, rupdir[0], rupdif[0])  # [B, ncol]

    # --- absorbed flux per layer + ground (impl:611-646) ---
    f_abs = torch.clamp(dftmp[:-1] - dftmp[1:], min=0.0)
    f_btm = torch.clamp(dftmp[nsno], min=0.0)
    flx_abs_lcl = torch.cat([torch.where(act_l, f_abs, 0.0), f_btm[None]],
                            dim=0).permute(1, 2, 0)  # [B, ncol, nsno+1]
    return albout_lcl, flx_abs_lcl, mu_not, snw_rds_lcl, snl_top, active


def _radiation_factor(flg_is_direct: bool, albout_lcl, flx_abs_lcl, mu_not,
                      snw_rds_lcl, snl_top, coszen, h2osno, albsoi,
                      active, weight_dtype=torch.float64) -> SnicarOut:
    """snow_albedo_radiation_factor (impl:671-771) for one incident flag:
    5-band -> vis/nir weighting, high-SZA near-IR adjustment (direct
    only), and the active/thin-snow/none branch select.  The band weights
    are a table of ``weight_dtype``, so the near-IR sums are in that type
    whatever the sweep's: float64 in a float64 model, float32 sweep or
    not, float32 in an all-float32 one (as the JAX package's
    ``jnp.asarray`` of the weights is with and without x64)."""
    nsno = c.NLEVSNO
    dtype = coszen.dtype
    wgt = _FLX_WGT_DRC if flg_is_direct else _FLX_WGT_DFS
    wgt_sum = sum(wgt[1:5])
    w = const(tuple(wgt[1:5]), coszen, weight_dtype)

    alb_vis = albout_lcl[0]
    alb_nir = torch.sum(w[:, None] * albout_lcl[1:5], dim=0) / wgt_sum
    flx_vis = flx_abs_lcl[0]
    flx_nir = torch.sum(w[:, None, None] * flx_abs_lcl[1:5], dim=0) / wgt_sum

    # near-IR direct adjustment for high solar zenith angle (impl:747-760)
    if flg_is_direct:
        a, b = _SZA_C1, _SZA_C0
        sza_c1 = a[0] - a[1] * mu_not + a[2] * mu_not ** 2
        sza_c0 = b[0] - b[1] * mu_not + b[2] * mu_not ** 2
        rds_top = take_layer(snw_rds_lcl, snl_top).to(dtype)
        sza_factor = sza_c1 * (torch.log10(rds_top) - 6.0) + sza_c0
        adjust = mu_not < _MU_75
        flx_sza_adjust = alb_nir * (sza_factor - 1.0) * wgt_sum
        alb_nir = torch.where(adjust, alb_nir * sza_factor, alb_nir)
        at_top = levels(nsno + 1, snl_top)[None, :] == snl_top[:, None]
        flx_nir = flx_nir - torch.where(
            at_top & adjust[:, None], flx_sza_adjust[:, None], 0.0)

    # branch select: active / thin-snow / none (impl:761-769)
    thin = (coszen > 0.0) & (h2osno < MIN_SNW) & (h2osno > 0.0)
    alb_vis = torch.where(active, alb_vis,
                          torch.where(thin, albsoi[:, 0], 0.0))
    alb_nir = torch.where(active, alb_nir,
                          torch.where(thin, albsoi[:, 1], 0.0))
    albout = torch.stack(_promote(alb_vis, alb_nir), dim=-1)
    flx_abs = torch.stack(_promote(flx_vis, flx_nir), dim=-1)
    flx_abs = torch.where(active[:, None, None], flx_abs, 0.0)
    return SnicarOut(albout, flx_abs)


def _promote(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def snicar_ad_rt(land: c.LandType, flg_slr_in: int, coszen, h2osno, snl,
                 h2osoi_liq, h2osoi_ice, snw_rds, albsoi, mss_cnc_aer,
                 tables: SnicarTables,
                 weight_dtype=torch.float64) -> SnicarOut:
    """One SNICAR-AD sweep over the 5 bands for direct (``flg_slr_in=1``)
    or diffuse (``flg_slr_in=2``) incident light: the reference's call
    chain ``init_timestep`` -> ``snow_aerosol_mie_params`` ->
    ``snow_radiative_transfer_solver`` -> ``snow_albedo_radiation_factor``
    (``snow_snicar_impl.hh:7-771``).  The step runs both flags at once by
    :func:`snicar_ad_rt_both`, which gives each flag's result bit for bit.

    h2osoi_liq/ice are [ncol, NLEVTOT]; snw_rds is [ncol, NLEVSNO];
    mss_cnc_aer is [ncol, NLEVSNO, SNO_NBR_AER]."""
    if flg_slr_in not in (1, 2):
        raise ValueError(f"flg_slr_in must be 1 (direct) or 2 (diffuse), "
                         f"not {flg_slr_in!r}")
    direct = flg_slr_in == 1
    nbnd = c.NUMRAD_SNW
    dev = coszen.device
    band_id_b = torch.arange(nbnd, device=dev)
    is_drc_b = torch.full((nbnd,), direct, device=dev)
    kind = "drc" if direct else "dfs"
    snw_ss, snw_asm, snw_ext = (getattr(tables, f"{p}_snw_{kind}") for p in
                                ("ss_alb", "asm_prm", "ext_cff_mss"))
    albout_lcl, flx_abs_lcl, mu_not, snw_rds_lcl, snl_top, active = \
        _snicar_core(band_id_b, is_drc_b, snw_ss, snw_asm, snw_ext,
                     coszen, h2osno, snl, h2osoi_liq, h2osoi_ice, snw_rds,
                     albsoi, mss_cnc_aer, tables)
    return _radiation_factor(direct, albout_lcl, flx_abs_lcl, mu_not,
                             snw_rds_lcl, snl_top, coszen, h2osno, albsoi,
                             active, weight_dtype)


def snicar_ad_rt_both(land: c.LandType, coszen, h2osno, snl, h2osoi_liq,
                      h2osoi_ice, snw_rds, albsoi, mss_cnc_aer,
                      tables: SnicarTables,
                      weight_dtype=torch.float64, sweep_dtype=None
                      ) -> tuple[SnicarOut, SnicarOut]:
    """Direct + diffuse sweeps in one solve (the reference calls
    SNICAR_AD_RT twice per step): K3 (``ops.snicar.snicar``) for CUDA
    tensors of which none carries a tangent, :func:`snicar_ad_rt_both_plain`
    otherwise.  ``weight_dtype`` is the model's type: the band weights'
    (:func:`_radiation_factor`).  ``sweep_dtype``, if given, is the type the
    sweep runs in: floating inputs and tables of another type are cast to
    it first (the step's ``mixed_radiation`` gives float32).  A failed
    build or launch of K3 raises."""
    args = dict(locals())
    if uses_kernel(args):
        from elmkernels_torch.ops.snicar import snicar
        del args["land"]
        return snicar(**args)
    return snicar_ad_rt_both_plain(**args)


def uses_kernel(args: dict) -> bool:
    """Whether a call of :func:`snicar_ad_rt_both` with these arguments (by
    name) runs K3: its tensors are on the card and none of them is
    differentiated (``torch.func.jvp``, forward AD or autograd)."""
    if not _on_card(args["coszen"]):
        return False
    tensors = [v for v in args.values() if isinstance(v, torch.Tensor)]
    tensors += list(args["tables"])
    return not any(tangents.carries_tangent(t) for t in tensors)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def snicar_ad_rt_both_plain(land: c.LandType, coszen, h2osno, snl,
                            h2osoi_liq, h2osoi_ice, snw_rds, albsoi,
                            mss_cnc_aer, tables: SnicarTables,
                            weight_dtype=torch.float64, sweep_dtype=None
                            ) -> tuple[SnicarOut, SnicarOut]:
    """:func:`snicar_ad_rt_both` as full-width tensor operations: the 5
    direct and 5 diffuse spectral bands stack into one 10-row band axis
    through :func:`_snicar_core`, whose result each beam's
    :func:`_radiation_factor` weights.  Each beam's result is
    :func:`snicar_ad_rt`'s bit for bit."""
    if sweep_dtype is not None:
        coszen, h2osno, h2osoi_liq, h2osoi_ice, snw_rds, albsoi, \
            mss_cnc_aer = (t.to(sweep_dtype) for t in (
                coszen, h2osno, h2osoi_liq, h2osoi_ice, snw_rds, albsoi,
                mss_cnc_aer))
        tables = SnicarTables(*(t.to(sweep_dtype) for t in tables))
    nbnd = c.NUMRAD_SNW
    dev = coszen.device
    band_id_b = torch.arange(nbnd, device=dev).repeat(2)
    is_drc_b = torch.arange(2 * nbnd, device=dev) < nbnd
    snw_ss = torch.cat([tables.ss_alb_snw_drc, tables.ss_alb_snw_dfs])
    snw_asm = torch.cat([tables.asm_prm_snw_drc, tables.asm_prm_snw_dfs])
    snw_ext = torch.cat([tables.ext_cff_mss_snw_drc,
                         tables.ext_cff_mss_snw_dfs])
    albout_lcl, flx_abs_lcl, mu_not, snw_rds_lcl, snl_top, active = \
        _snicar_core(band_id_b, is_drc_b, snw_ss, snw_asm, snw_ext,
                     coszen, h2osno, snl, h2osoi_liq, h2osoi_ice, snw_rds,
                     albsoi, mss_cnc_aer, tables)
    drc = _radiation_factor(True, albout_lcl[:nbnd], flx_abs_lcl[:nbnd],
                            mu_not, snw_rds_lcl, snl_top, coszen, h2osno,
                            albsoi, active, weight_dtype)
    dfs = _radiation_factor(False, albout_lcl[nbnd:], flx_abs_lcl[nbnd:],
                            mu_not, snw_rds_lcl, snl_top, coszen, h2osno,
                            albsoi, active, weight_dtype)
    return drc, dfs
