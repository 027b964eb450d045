"""Snow pack evolution: meltwater percolation with aerosol flushing,
compaction, layer combination/subdivision, and grain-size aging — batched
over columns.

Counterpart of ``elmkernels_tpu/physics/snow_hydrology.py`` (reference
``src/physics/snow_hydrology_impl.hh:8-1353``, ``aerosol_physics_impl.hh``
and ``transpiration_impl.hh``).  The data-dependent layer mutations
(combine/divide with in-place shifts and mid-loop ``snl`` changes) are
Python loops over the 5 snow positions with per-column masks, carrying
``snl`` through each pass (the JAX package's ``lax.scan``s), so each
column follows the reference's sequential control flow.  Functions that
update a layer array in place work on their own copy.

The step runs the ten functions of the block (``snow_water`` to the snow
aging) through :func:`snow_hydrology_block`, which routes CUDA tensors
that carry no tangent to K5 (``elmkernels_torch.ops.snow.snow_hydrology``,
one thread a column runs the whole block) and everything else (CPU
tensors; a differentiated call, for which K5 has no tangent version) to
:func:`snow_hydrology_block_plain`, the chain of those functions.

Kept deviation of the JAX package: the percolation clamp reads
``vol_ice[i+1]`` where the reference reads ``vol_ice[i+i]``
(``snow_hydrology_impl.hh:388``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.ops import tangents
from elmkernels_torch.physics.math_utils import (const, gather_layers,
                                                 levels, rdiv, safe_div,
                                                 take_layer)

# the snow-aging tables' last indices over (T, dT/dz, rho) (reference
# snow_snicar.h detail:: lines 34-39); data/params.py sizes the tables
# from them
IDX_T_MAX = 10
IDX_TGRD_MAX = 30
IDX_RHOS_MAX = 7

_NSNO = c.NLEVSNO
_SCAVENGING = dict(bcphi=0.20, bcpho=0.03, dst1=0.02, dst2=0.02, dst3=0.01,
                   dst4=0.01)


class SnowWaterOut(NamedTuple):
    qflx_snow_melt: torch.Tensor
    qflx_top_soil: torch.Tensor
    int_snow: torch.Tensor
    frac_sno: torch.Tensor
    mflx_neg_snow: torch.Tensor
    h2osoi_liq: torch.Tensor   # [ncol, NLEVTOT]
    h2osoi_ice: torch.Tensor
    mss: dict                  # per-species [ncol, NLEVSNO]
    dz: torch.Tensor


def snow_water(land: c.LandType, do_capsnow, snl, dtime, frac_sno_eff,
               h2osno, qflx_sub_snow, qflx_evap_grnd, qflx_dew_snow,
               qflx_dew_grnd, qflx_rain_grnd, qflx_snomelt, qflx_snow_melt,
               int_snow, frac_sno, h2osoi_liq, h2osoi_ice, mss,
               dz) -> SnowWaterOut:
    """Surface-layer frost/evaporation update + explicit meltwater
    percolation with aerosol scavenging (``snow_hydrology_impl.hh:
    262-484``).  ``mss`` is a dict of the six aerosol mass arrays."""
    lev20 = levels(c.NLEVTOT, snl)[None, :]
    top = _NSNO - snl
    at_top = lev20 == top[:, None]
    cap = (do_capsnow != 0)[:, None]

    # --- top-layer sublimation/frost/dew update (impl:298-315) ---
    fse = frac_sno_eff[:, None]
    wgdif_cap = h2osoi_ice - fse * qflx_sub_snow[:, None] * dtime
    wgdif_nc = h2osoi_ice + fse * (qflx_dew_snow
                                   - qflx_sub_snow)[:, None] * dtime
    wgdif = torch.where(cap, wgdif_cap, wgdif_nc)
    neg = wgdif < 0.0
    # sublimation that exhausts the top layer's ice zeroes the ice and
    # pushes the deficit into the liquid (ELM proper; the reference's 0.9
    # is a typo, ledgered in PARITY.md)
    ice = torch.where(at_top, torch.where(neg, 0.0, wgdif), h2osoi_ice)
    liq = h2osoi_liq + torch.where(at_top & neg, wgdif, 0.0)
    liq_add_cap = -fse * qflx_evap_grnd[:, None] * dtime
    liq_add_nc = fse * (qflx_rain_grnd + qflx_dew_grnd
                        - qflx_evap_grnd)[:, None] * dtime
    liq = liq + torch.where(at_top, torch.where(cap, liq_add_cap,
                                                liq_add_nc), 0.0)

    # --- zero negative liquid downward from the top (impl:317-324); the
    # walk breaks at the first non-negative layer ---
    running = take_layer(liq, top) < 0.0
    mflx_neg_snow = torch.zeros_like(h2osno)
    liq = liq.clone()
    for i in range(_NSNO + 1):
        w = liq[:, i].clone()  # read before the row is zeroed in place
        below = i >= top
        hit = running & below & (w < 0.0)
        liq[:, i] = torch.where(hit, 0.0, w)
        mflx_neg_snow = torch.where(hit, w / dtime, mflx_neg_snow)
        running = running & (~below | hit)

    # --- porosity / partial volumes (impl:327-335) ---
    active5 = levels(_NSNO, snl)[None, :] >= top[:, None]
    dz5 = dz[:, :_NSNO]
    den_i = dz5 * fse * c.DENICE
    den_l = dz5 * fse * c.DENH2O
    vol_ice = torch.clamp(safe_div(ice[:, :_NSNO], den_i, den_i != 0.0),
                          max=1.0)
    eff_por = 1.0 - vol_ice
    vol_liq = torch.minimum(eff_por,
                            safe_div(liq[:, :_NSNO], den_l, den_l != 0.0))

    # --- downward percolation with aerosol scavenging (impl:353-461) ---
    wimp, ssi = 0.05, 0.033
    mss = {k: v.clone() for k, v in mss.items()}
    qin = torch.zeros_like(h2osno)
    qin_a = {k: torch.zeros_like(h2osno) for k in _SCAVENGING}
    qout = torch.zeros_like(h2osno)
    for i in range(_NSNO):
        act = active5[:, i]
        liq[:, i] = liq[:, i] + torch.where(act, qin, 0.0)
        for k in _SCAVENGING:
            mss[k][:, i] = mss[k][:, i] + torch.where(act, qin_a[k], 0.0)

        ip1 = min(i + 1, _NSNO - 1)
        base = torch.clamp((vol_liq[:, i] - ssi * eff_por[:, i]) * dz5[:, i]
                           * frac_sno_eff, min=0.0)
        # (reference reads vol_ice[i+i] here — corrected to i+1)
        capq = (1.0 - vol_ice[:, ip1] - vol_liq[:, ip1]) * dz5[:, ip1] \
            * frac_sno_eff
        blocked = (eff_por[:, i] < wimp) | (eff_por[:, ip1] < wimp)
        if i < _NSNO - 1:
            q = torch.where(blocked, 0.0, torch.minimum(base, capq))
        else:
            q = base
        q = q * 1000.0
        liq[:, i] = liq[:, i] + torch.where(act, -q, 0.0)
        qin = torch.where(act, q, qin)
        qout = torch.where(act, q, qout)

        mss_liqice = torch.clamp(liq[:, i] + ice[:, i], min=1.0e-30)
        for k, scv in _SCAVENGING.items():
            mk_i = mss[k][:, i]
            qa = torch.minimum(q * scv * (mk_i / mss_liqice), mk_i)
            mss[k][:, i] = mk_i + torch.where(act, -qa, 0.0)
            qin_a[k] = torch.where(act, qa, qin_a[k])

    # --- layer thickness floor (impl:468-470) ---
    dz_new5 = torch.where(active5,
                          torch.maximum(dz5, liq[:, :_NSNO] / c.DENH2O
                                        + ice[:, :_NSNO] / c.DENICE), dz5)
    dz = torch.cat([dz_new5, dz[:, _NSNO:]], dim=1)

    # --- bottom fluxes (impl:472-483) ---
    has = snl > 0
    qflx_snow_melt_n = torch.where(has, qflx_snow_melt + qout / dtime,
                                   qflx_snomelt)
    qflx_top_soil = torch.where(
        has, (qout / dtime) + (1.0 - frac_sno_eff) * qflx_rain_grnd,
        qflx_rain_grnd + qflx_snomelt)
    int_snow_n = torch.where(
        has, int_snow + frac_sno_eff
        * (qflx_dew_snow + qflx_dew_grnd + qflx_rain_grnd) * dtime,
        torch.where(h2osno <= 0.0, 0.0, int_snow))
    frac_sno_n = torch.where(~has & (h2osno <= 0.0), 0.0, frac_sno)

    return SnowWaterOut(qflx_snow_melt_n, qflx_top_soil, int_snow_n,
                        frac_sno_n, mflx_neg_snow, liq, ice, mss, dz)


def compute_aerosol_deposition(dtime, snl, aero_in, mss):
    """Deposit BC/dust fluxes into the top snow layer
    (``aerosol_physics_impl.hh:34-60``)."""
    top = _NSNO - snl
    onehot = ((levels(_NSNO, snl)[None, :] == top[:, None])
              & (snl > 0)[:, None])
    add = {
        "bcphi": aero_in["bcphi"],
        "bcpho": aero_in["bcpho"] + aero_in["bcdep"],
        "dst1": aero_in["dst1_1"] + aero_in["dst1_2"],
        "dst2": aero_in["dst2_1"] + aero_in["dst2_2"],
        "dst3": aero_in["dst3_1"] + aero_in["dst3_2"],
        "dst4": aero_in["dst4_1"] + aero_in["dst4_2"],
    }
    return {k: mss[k] + torch.where(onehot, (add[k] * dtime)[:, None], 0.0)
            for k in mss}


def update_aerosol_mass_and_concen(dtime, snl, do_capsnow, qflx_snwcp_ice,
                                   h2osoi_ice, h2osoi_liq, mss):
    """Snow-cap mass rescaling + concentration = mass/snowmass
    (``aerosol_physics_impl.hh:63-107``)."""
    top = _NSNO - snl
    lev = levels(_NSNO, snl)[None, :]
    above = lev < top[:, None]
    snowmass = torch.where(above, 1.e-12,
                           h2osoi_ice[:, :_NSNO] + h2osoi_liq[:, :_NSNO])
    at_top_cap = (lev == top[:, None]) & (do_capsnow != 0)[:, None]
    scl = torch.where(
        at_top_cap,
        snowmass / (snowmass + (qflx_snwcp_ice * dtime)[:, None]),
        torch.where(above, 0.0, torch.ones_like(snowmass)))
    mss_new = {k: v * scl for k, v in mss.items()}
    cnc = {k: v / snowmass for k, v in mss_new.items()}
    return mss_new, cnc


def aerosol_phase_change(snl, dtime, qflx_sub_snow, h2osoi_liq, h2osoi_ice,
                         mss_bcphi, mss_bcpho):
    """Move within-ice BC to external BC in proportion to sublimated mass
    (top layer only; ``snow_hydrology_impl.hh:492-543``)."""
    top = _NSNO - snl
    liq_t = take_layer(h2osoi_liq, top)
    ice_t = take_layer(h2osoi_ice, top)
    subsnow = torch.clamp(qflx_sub_snow * dtime, min=0.0)
    tot = liq_t + ice_t
    frc_sub = torch.where(tot > 0.0,
                          subsnow / torch.where(tot > 0.0, tot, 1.0), 0.0)
    frc = torch.clamp(frc_sub, max=1.0)
    at_top = levels(_NSNO, snl)[None, :] == top[:, None]
    dm = torch.where(at_top, mss_bcphi * frc[:, None], 0.0)
    return mss_bcphi - dm, mss_bcpho + dm


def transpiration(veg_active, qflx_tran_veg, rootr):
    """qflx_rootsoi = rootr * qflx_tran_veg over the hydrologically active
    soil layers (0..NLEVSOI-1 only)."""
    lev = levels(rootr.shape[-1], rootr)[None, :]
    m = veg_active[:, None] & (lev < c.NLEVSOI)
    return torch.where(m, rootr * qflx_tran_veg[:, None], 0.0)


def snow_compaction(land: c.LandType, snl, dtime, int_snow, n_melt, frac_sno,
                    imelt, swe_old, h2osoi_liq, h2osoi_ice, t_soisno,
                    frac_iceold, dz):
    """Destructive/overburden/melt metamorphism of snow layer thickness
    (``snow_hydrology_impl.hh:546-637``)."""
    c2_, c3_, c4_, c5_ = 23.e-3, 2.777e-6, 0.04, 2.0
    dm_ = 100.0
    eta0 = 9.0e+5

    top = _NSNO - snl
    lev = levels(_NSNO, snl)[None, :]
    active = lev >= top[:, None]

    liq5, ice5 = h2osoi_liq[:, :_NSNO], h2osoi_ice[:, :_NSNO]
    t5 = t_soisno[:, :_NSNO]
    dz5 = dz[:, :_NSNO]
    fs = frac_sno[:, None]
    fs_safe = torch.where(fs != 0.0, fs, 1.0)
    dz_safe = torch.where(dz5 != 0.0, dz5, 1.0)

    wx = ice5 + liq5
    vd = 1.0 - (ice5 / c.DENICE + liq5 / c.DENH2O) / (fs_safe * dz_safe)
    compact = active & (vd > 0.001) & (ice5 > 0.1)

    bi = ice5 / (fs_safe * dz_safe)
    wx_safe = torch.where(wx != 0.0, wx, 1.0)
    fi = ice5 / wx_safe
    td = c.TFRZ - t5
    dexpf = torch.exp(-c4_ * td)

    ddz1 = -c3_ * dexpf
    ddz1 = torch.where(bi > dm_, ddz1 * torch.exp(-46.0e-3 * (bi - dm_)),
                       ddz1)
    ddz1 = torch.where(liq5 > 0.01 * dz5 * fs, ddz1 * c5_, ddz1)

    # overburden: exclusive prefix sum of layer water mass from the top
    wx_act = torch.where(active, wx, 0.0)
    burden = torch.cumsum(wx_act, dim=1) - wx_act
    ddz2 = -(burden + wx / 2.0) * torch.exp(-0.08 * td - c2_ * bi) / eta0

    # melt compaction
    melted = imelt[:, :_NSNO] == 1
    sc = (c.ltype_mask(land, c.ISTSOIL, c.ISTCROP) if c.SUBGRIDFLAG == 1
          else False)
    if sc is not False:
        ddz3_sc = torch.clamp((swe_old - wx) / wx_safe, 0.0, 1.0)
        wsum = torch.sum(wx_act, dim=1)[:, None]  # only used at i == top
        shrunk = (swe_old - wx) > 0.0
        int_safe = torch.where(int_snow != 0.0, int_snow, 1.0)[:, None]
        fsno_melt = 1.0 - (torch.acos(
            2.0 * torch.clamp(torch.where(lev == top[:, None], wsum, 0.0)
                              / int_safe, max=1.0) - 1.0)
            / c.ELM_PI) ** n_melt[:, None]
        ddz3_sc = ddz3_sc - torch.where(
            shrunk, torch.clamp((fsno_melt - fs) / fs_safe, min=0.0), 0.0)
        ddz3_sc = -1.0 / dtime * ddz3_sc
    if sc is not True:
        fio = frac_iceold[:, :_NSNO]
        fio_safe = torch.where(fio != 0.0, fio, 1.0)
        ddz3_ns = -1.0 / dtime * torch.clamp((fio - fi) / fio_safe, min=0.0)
    ddz3 = (ddz3_sc if sc is True else ddz3_ns if sc is False
            else c.lsel(sc, ddz3_sc, ddz3_ns))
    ddz3 = torch.where(melted, ddz3, 0.0)

    pdzdtc = ddz1 + ddz2 + ddz3
    dz_comp = torch.maximum(dz5 * (1.0 + pdzdtc * dtime),
                            (ice5 / c.DENICE + liq5 / c.DENH2O) / fs_safe)
    dz5_new = torch.where(compact, dz_comp, dz5)
    return torch.cat([dz5_new, dz[:, _NSNO:]], dim=1)


def _combine_vals(dz2, wliq2, wice2, t2, dz1, wliq1, wice1, t1):
    """Mass/energy-conserving merge of layer 2 into layer 1
    (``snow_hydrology_impl.hh:1304-1326``)."""
    h1 = (c.CPICE * wice1 + c.CPWAT * wliq1) * (t1 - c.TFRZ) + c.HFUS * wliq1
    h2 = (c.CPICE * wice2 + c.CPWAT * wliq2) * (t2 - c.TFRZ) + c.HFUS * wliq2
    wice = wice1 + wice2
    wliq = wliq1 + wliq2
    den = c.CPICE * wice + c.CPWAT * wliq
    tc = c.TFRZ + (h1 + h2 - c.HFUS * wliq) / torch.where(den != 0.0, den,
                                                          1.0)
    return dz1 + dz2, wliq, wice, tc


class SnowState(NamedTuple):
    """Per-layer snow state threaded through combine/divide."""
    snl: torch.Tensor
    t: torch.Tensor      # [ncol, NLEVTOT] t_soisno
    ice: torch.Tensor    # [ncol, NLEVTOT]
    liq: torch.Tensor
    rds: torch.Tensor    # [ncol, NLEVSNO]
    mss: dict
    dz: torch.Tensor     # [ncol, NLEVTOT]
    z: torch.Tensor
    zi: torch.Tensor     # [ncol, NLEVTOT+1]


def _shift_down(arr, m, lo, hi, width):
    """Where mask m: arr[p] = arr[p-1] for p in (lo, hi] (per-column
    bounds), over the first `width` positions."""
    lev = levels(width, arr)[None, :]
    prev = torch.cat([arr[:, :1], arr[:, :width - 1]], dim=1)
    sel = m[:, None] & (lev > lo[:, None]) & (lev <= hi[:, None])
    return torch.cat([torch.where(sel, prev, arr[:, :width]),
                      arr[:, width:]], dim=1)


class CombineOut(NamedTuple):
    state: SnowState
    h2osno: torch.Tensor
    snow_depth: torch.Tensor
    frac_sno_eff: torch.Tensor
    frac_sno: torch.Tensor
    int_snow: torch.Tensor
    qflx_sl_top_soil: torch.Tensor
    qflx_snow2topsoi: torch.Tensor
    mflx_snowlyr_col: torch.Tensor


def combine_layers(land: c.LandType, dtime, st: SnowState, h2osno,
                   snow_depth, frac_sno_eff, frac_sno,
                   int_snow) -> CombineOut:
    """Remove near-zero-ice layers, dissolve too-shallow packs, and merge
    below-minimum-thickness layers with neighbors
    (``snow_hydrology_impl.hh:648-897``)."""
    dzmin = const((0.010, 0.015, 0.025, 0.055, 0.115), h2osno)
    soil_like = c.lor(c.ltype_mask(land, c.ISTSOIL, c.ISTCROP), land.urbpoi)

    def sl_and(m):
        """``m`` on the soil-like columns only: ``m`` itself for a
        soil-like domain, None for a domain with none."""
        if soil_like is True:
            return m
        if soil_like is False:
            return None
        return m & soil_like

    snl = st.snl
    t, ice, liq = st.t, st.ice, st.liq
    rds, mss, dz, z, zi = st.rds, dict(st.mss), st.dz, st.z, st.zi
    lev20 = levels(c.NLEVTOT, snl)[None, :]
    lev5 = levels(_NSNO, snl)[None, :]

    qflx_sl_top_soil = torch.zeros_like(h2osno)
    qflx_snow2topsoi = torch.zeros_like(h2osno)
    mflx_snowlyr_col = torch.zeros_like(h2osno)

    # ---- pass 1: eliminate layers with ice <= 0.01 (impl:689-756) ----
    top_old = _NSNO - snl
    for i in range(_NSNO):
        liq_i = liq[:, i]  # pre-merge values at position i
        ice_i = ice[:, i]
        m = (i >= top_old) & (ice_i <= 0.01)
        last = i == _NSNO - 1
        # merge mass into the layer below (soil-like land units)
        msl = sl_and(m)
        if msl is not None:
            below = (lev20 == i + 1) & msl[:, None]
            liq = torch.where(below, liq + liq_i[:, None], liq)
            ice = torch.where(below, ice + ice_i[:, None], ice)
            if last:
                q = torch.where(msl, (liq_i + ice_i) / dtime, 0.0)
                qflx_sl_top_soil = torch.where(msl, q, qflx_sl_top_soil)
            else:
                q = torch.zeros_like(h2osno)
            mflx_snowlyr_col = mflx_snowlyr_col + q
            if not last:
                dz = torch.where(below, dz + dz[:, i:i + 1], dz)
                below5 = (lev5 == i + 1) & msl[:, None]
                mss = {k: torch.where(below5, v + v[:, i:i + 1], v)
                       for k, v in mss.items()}
        # shift elements above down one
        topc = _NSNO - snl
        do_shift = m & (i > topc) & (snl > 1)
        lo = topc
        hi = torch.full_like(topc, i)
        t = _shift_down(t, do_shift, lo, hi, _NSNO)
        liq = _shift_down(liq, do_shift, lo, hi, _NSNO)
        ice = _shift_down(ice, do_shift, lo, hi, _NSNO)
        dz = _shift_down(dz, do_shift, lo, hi, _NSNO)
        rds = _shift_down(rds, do_shift, lo, hi, _NSNO)
        mss = {k: _shift_down(v, do_shift, lo, hi, _NSNO)
               for k, v in mss.items()}
        snl = torch.where(m, snl - 1, snl)

    # ---- totals (impl:758-769) ----
    active5 = lev5 >= (_NSNO - snl)[:, None]
    h2osno_n = torch.sum(torch.where(active5,
                                     ice[:, :_NSNO] + liq[:, :_NSNO], 0.0),
                         dim=1)
    snow_depth_n = torch.sum(torch.where(active5, dz[:, :_NSNO], 0.0), dim=1)
    zwice = torch.sum(torch.where(active5, ice[:, :_NSNO], 0.0), dim=1)
    zwliq = torch.sum(torch.where(active5, liq[:, :_NSNO], 0.0), dim=1)

    # ---- dissolve too-shallow packs (impl:775-800) ----
    fsd = frac_sno_eff * snow_depth_n
    fse_safe = torch.where(fsd != 0.0, fsd, 1.0)
    gone = (snow_depth_n > 0.0) & ((fsd < 0.01) | (h2osno_n / fse_safe < 50.0))
    snl = torch.where(gone, 0, snl)
    h2osno_n = torch.where(gone, zwice, h2osno_n)
    mss = {k: torch.where(gone[:, None], 0.0, v) for k, v in mss.items()}
    snow_depth_n = torch.where(gone & (h2osno_n <= 0.0), 0.0, snow_depth_n)
    gsl = sl_and(gone)
    if gsl is not None:
        liq = liq.clone()
        liq[:, _NSNO - 1] = torch.where(gsl, 0.0, liq[:, _NSNO - 1])
        liq[:, _NSNO] = liq[:, _NSNO] + torch.where(gsl, zwliq, 0.0)
        qflx_snow2topsoi = torch.where(gsl, zwliq / dtime, qflx_snow2topsoi)
        mflx_snowlyr_col = mflx_snowlyr_col + torch.where(gsl,
                                                          zwliq / dtime, 0.0)

    none_left = h2osno_n <= 0.0
    snow_depth_n = torch.where(none_left, 0.0, snow_depth_n)
    frac_sno_n = torch.where(none_left, 0.0, frac_sno)
    frac_sno_eff_n = torch.where(none_left, 0.0, frac_sno_eff)
    int_snow_n = torch.where(none_left, 0.0, int_snow)

    # ---- merge below-minimum layers (impl:813-890) ----
    top_old2 = _NSNO - snl
    mssi = torch.zeros_like(snl)
    stop = snl <= 1
    fse = frac_sno_eff_n
    for i in range(_NSNO):
        dz_i = dz[:, i]
        fse_dz = fse * dz_i
        fse_dz_safe = torch.where(fse_dz != 0.0, fse_dz, 1.0)
        thin = ((fse_dz < dzmin[torch.clamp(mssi, 0, 4)])
                | ((ice[:, i] + liq[:, i]) / fse_dz_safe < 50.0))
        m = (~stop) & (i >= top_old2) & thin

        topc = _NSNO - snl
        # neighbor selection (impl:823-834): first position always merges
        # downward, last always upward, middles pick the thinner neighbor
        if i == 0:
            nb_down = torch.ones_like(m)
        elif i == _NSNO - 1:
            nb_down = torch.zeros_like(m)
        else:
            dz_im1 = dz[:, i - 1] + dz_i
            dz_ip1 = dz[:, i + 1] + dz_i
            nb_down = (i == topc) | ~(dz_im1 < dz_ip1)
        # nb_down: combine with i+1 (j=i+1, l=i); else j=i, l=i-1
        jidx = torch.where(nb_down, i + 1, i)
        lidx = torch.where(nb_down, i, i - 1)

        wl_j, wl_l = take_layer(liq, jidx), take_layer(liq, lidx)
        wi_j, wi_l = take_layer(ice, jidx), take_layer(ice, lidx)
        t_j, t_l = take_layer(t, jidx), take_layer(t, lidx)
        dz_j, dz_l = take_layer(dz, jidx), take_layer(dz, lidx)
        rds_j, rds_l = take_layer(rds, jidx), take_layer(rds, lidx)

        tot = wl_j + wi_j + wl_l + wi_l
        rds_new = (rds_j * (wl_j + wi_j) + rds_l * (wl_l + wi_l)) \
            / torch.where(tot != 0.0, tot, 1.0)
        dz_new, wl_new, wi_new, t_new = _combine_vals(
            dz_l, wl_l, wi_l, t_l, dz_j, wl_j, wi_j, t_j)

        onehot_j = (lev20 == jidx[:, None]) & m[:, None]
        onehot_j5 = (lev5 == jidx[:, None]) & m[:, None]
        liq = torch.where(onehot_j, wl_new[:, None], liq)
        ice = torch.where(onehot_j, wi_new[:, None], ice)
        t = torch.where(onehot_j, t_new[:, None], t)
        dz = torch.where(onehot_j, dz_new[:, None], dz)
        rds = torch.where(onehot_j5, rds_new[:, None], rds)
        mss = {k: torch.where(onehot_j5, (take_layer(v, jidx)
                                          + take_layer(v, lidx))[:, None], v)
               for k, v in mss.items()}

        # shift above down one (impl:865-879): k from j-1 down to top
        do_shift = m & ((jidx - 1) > topc)
        lo = topc - 1  # reference shifts down to k == nlevsno-snl inclusive
        hi = jidx - 1
        t = _shift_down(t, do_shift, lo, hi, _NSNO)
        liq = _shift_down(liq, do_shift, lo, hi, _NSNO)
        ice = _shift_down(ice, do_shift, lo, hi, _NSNO)
        dz = _shift_down(dz, do_shift, lo, hi, _NSNO)
        rds = _shift_down(rds, do_shift, lo, hi, _NSNO)
        mss = {k: _shift_down(v, do_shift, lo, hi, _NSNO)
               for k, v in mss.items()}

        snl = torch.where(m, snl - 1, snl)
        stop = stop | (m & (snl <= 1))
        mssi = torch.where((~stop) & (i >= top_old2) & ~m, mssi + 1, mssi)

    # ---- reset node depths/interfaces (impl:893-896) ----
    z, zi = _rebuild_snow_mesh(snl, dz, z, zi)

    return CombineOut(
        SnowState(snl, t, ice, liq, rds, mss, dz, z, zi), h2osno_n,
        snow_depth_n, frac_sno_eff_n, frac_sno_n, int_snow_n,
        qflx_sl_top_soil, qflx_snow2topsoi, mflx_snowlyr_col)


def _rebuild_snow_mesh(snl, dz, z, zi):
    """z(i) = zi(i+1) - dz/2, zi(i) = zi(i+1) - dz, from bottom snow up."""
    top = _NSNO - snl
    z, zi = z.clone(), zi.clone()
    for i in range(_NSNO - 1, -1, -1):
        act = i >= top
        zi_next = zi[:, i + 1]
        z[:, i] = torch.where(act, zi_next - 0.5 * dz[:, i], z[:, i])
        zi[:, i] = torch.where(act, zi_next - dz[:, i], zi[:, i])
    return z, zi


# the divide ladder: (rung k, dmax, split when msno <= this, split depth)
_LADDER = ((0, 0.02, 2, 0.07), (1, 0.05, 3, 0.18), (2, 0.11, 4, 0.41),
           (3, 0.23, -1, math.inf))


def divide_layers(frac_sno, st: SnowState) -> SnowState:
    """Subdivide too-thick snow layers (fixed ELM case ladder) on
    top-anchored scratch arrays (``snow_hydrology_impl.hh:907-1285``)."""
    snl = st.snl
    top = _NSNO - snl
    fs = frac_sno
    fs_safe = torch.where(fs != 0.0, fs, 1.0)
    lev5 = levels(_NSNO, snl)[None, :]

    # gather to top-anchored layout: index k holds layer top+k
    idx = torch.clamp(top[:, None] + lev5, 0, _NSNO - 1)
    in_range = lev5 < snl[:, None]

    def g(a):
        return torch.where(in_range, gather_layers(a[:, :_NSNO], idx), 0.0)

    dzs = g(st.dz) * fs[:, None]
    swice = g(st.ice)
    swliq = g(st.liq)
    tsno = g(st.t)
    rds = g(st.rds)
    ms = {k: g(v) for k, v in st.mss.items()}
    msno = snl

    # ---- msno == 1, dz > 0.03: split top layer (impl:962-986) ----
    m1 = ((msno == 1) & (dzs[:, 0] > 0.03))[:, None]

    def hv(a):
        half = a[:, 0:1] / 2.0
        return torch.where(m1, torch.cat([half, half, a[:, 2:]], dim=1), a)

    def dup(a):
        return torch.where(m1, torch.cat([a[:, 0:1], a[:, 0:1], a[:, 2:]],
                                         dim=1), a)
    dzs, swice, swliq = hv(dzs), hv(swice), hv(swliq)
    tsno, rds = dup(tsno), dup(rds)
    ms = {k: hv(v) for k, v in ms.items()}
    msno = torch.where(m1[:, 0], 2, msno)

    # ---- trim layer k to dmax, push the excess into k+1, then maybe
    #      split k+1, for the 4 rungs of the ladder ----
    for k, dmax, split_msno, split_thresh in _LADDER:
        dzs_k = dzs[:, k]
        thick = (msno > k + 1) & (dzs_k > dmax)
        dz_k = torch.where(dzs_k != 0.0, dzs_k, 1.0)
        drr = dzs_k - dmax
        propor_x = drr / dz_k
        zwice = propor_x * swice[:, k]
        zwliq = propor_x * swliq[:, k]
        zms = {kk: propor_x * v[:, k] for kk, v in ms.items()}
        propor = rdiv(dmax, dz_k)

        sel = thick[:, None]
        at_k = lev5 == k
        at_k1 = lev5 == k + 1
        at_k2 = lev5 == k + 2
        swice = torch.where(sel & at_k, swice * propor[:, None], swice)
        swliq = torch.where(sel & at_k, swliq * propor[:, None], swliq)
        ms = {kk: torch.where(sel & at_k1, v + zms[kk][:, None],
                              torch.where(sel & at_k, v * propor[:, None], v))
              for kk, v in ms.items()}
        dzs = torch.where(sel & at_k, dmax, dzs)

        tot = swliq[:, k + 1] + swice[:, k + 1] + zwliq + zwice
        rds_next = (rds[:, k + 1] * (swliq[:, k + 1] + swice[:, k + 1])
                    + rds[:, k] * (zwliq + zwice)) \
            / torch.where(tot != 0.0, tot, 1.0)
        rds = torch.where(sel & at_k1, rds_next[:, None], rds)

        dz_n, wl_n, wi_n, t_n = _combine_vals(
            drr, zwliq, zwice, tsno[:, k], dzs[:, k + 1],
            swliq[:, k + 1], swice[:, k + 1], tsno[:, k + 1])
        dzs = torch.where(sel & at_k1, dz_n[:, None], dzs)
        swliq = torch.where(sel & at_k1, wl_n[:, None], swliq)
        swice = torch.where(sel & at_k1, wi_n[:, None], swice)
        tsno = torch.where(sel & at_k1, t_n[:, None], tsno)

        if math.isinf(split_thresh):
            continue  # the last rung never splits
        # subdivide layer k+1 (impl: "Subdivide a new layer")
        msplit = thick & (msno <= split_msno) & (dzs[:, k + 1] > split_thresh)
        sel2 = msplit[:, None]
        pair = sel2 & (at_k1 | at_k2)
        dtdz = ((tsno[:, k] - tsno[:, k + 1])
                / ((dzs[:, k] + dzs[:, k + 1]) / 2.0))
        half_dz = dzs[:, k + 1] / 2.0
        dzs = torch.where(pair, half_dz[:, None], dzs)
        swice = torch.where(pair, (swice[:, k + 1] / 2.0)[:, None], swice)
        swliq = torch.where(pair, (swliq[:, k + 1] / 2.0)[:, None], swliq)
        t_up = tsno[:, k + 1]
        # dzs[k+1] is already halved here, so the reference's
        # "dtdz * dzs[k+1] / 2" is dtdz * half_dz / 2
        hq = dtdz * half_dz / 2.0
        t_low = t_up - hq
        # the reference's warm check differs across ladder steps
        # (impl:1041 the new lower layer, impl:1118 the upper, impl:1194
        # the lower again) — replicated exactly
        warm = (t_up >= c.TFRZ) if k == 1 else (t_low >= c.TFRZ)
        tsno = torch.where(
            sel2 & at_k2, torch.where(warm, t_up, t_low)[:, None],
            torch.where(sel2 & at_k1,
                        torch.where(warm, t_up, t_up + hq)[:, None], tsno))
        ms = {kk: torch.where(pair, (v[:, k + 1] / 2.0)[:, None], v)
              for kk, v in ms.items()}
        rds = torch.where(sel2 & at_k2, rds[:, k + 1][:, None], rds)
        msno = torch.where(msplit, k + 3, msno)

    # ---- scatter back to combined layout (impl:1263-1284) ----
    snl_new = msno
    back = lev5 - (_NSNO - snl_new)[:, None]  # top-anchored index per pos
    valid = back >= 0
    backc = torch.clamp(back, 0, _NSNO - 1)

    def scat(comb, anch):
        out = torch.where(valid, gather_layers(anch, backc),
                          comb[:, :_NSNO])
        return torch.cat([out, comb[:, _NSNO:]], dim=1)

    dz_new = scat(st.dz, dzs / fs_safe[:, None])
    ice_new = scat(st.ice, swice)
    liq_new = scat(st.liq, swliq)
    t_new = scat(st.t, tsno)
    rds_new = torch.where(valid, gather_layers(rds, backc), st.rds)
    mss_new = {k: torch.where(valid, gather_layers(ms[k], backc), st.mss[k])
               for k in ms}

    z_new, zi_new = _rebuild_snow_mesh(snl_new, dz_new, st.z, st.zi)
    return SnowState(snl_new, t_new, ice_new, liq_new, rds_new, mss_new,
                     dz_new, z_new, zi_new)


def prune_snow_layers(st: SnowState) -> SnowState:
    """Zero all inactive snow layers (impl:1330-1351)."""
    top = (_NSNO - st.snl)[:, None]
    inact20 = levels(c.NLEVTOT, st.snl)[None, :] < top
    inact21 = levels(c.NLEVTOT + 1, st.snl)[None, :] < top
    return SnowState(
        st.snl,
        torch.where(inact20, 0.0, st.t),
        torch.where(inact20, 0.0, st.ice),
        torch.where(inact20, 0.0, st.liq),
        st.rds, st.mss,
        torch.where(inact20, 0.0, st.dz),
        torch.where(inact20, 0.0, st.z),
        torch.where(inact21, 0.0, st.zi))


def snow_aging_pinned(snl, h2osno, snw_rds):
    """Snow grain aging under the reference's double-clamp quirk
    (``snow_hydrology_impl.hh:216-222`` clamps the aged radius to
    SNW_RDS_MIN from both sides): active layers -> SNW_RDS_MIN, inactive
    layers of layered columns -> 0, layerless columns pass through, a thin
    layerless pack gets the fresh-snow radius in the bottom slot.  The JAX
    package's ``snow_aging_pinned``: :func:`snow_aging` gives the same
    result under that clamp, through work whose result it discards.
    """
    top = _NSNO - snl
    lev = levels(_NSNO, snl)[None, :]
    layered = (snl > 0)[:, None]
    active = (lev >= top[:, None]) & layered
    out = torch.where(active, c.SNW_RDS_MIN,
                      torch.where(layered, 0.0, snw_rds))
    thin = (snl == 0) & (h2osno > 0.0)
    return torch.where(thin[:, None] & (lev == _NSNO - 1), c.SNW_RDS_MIN,
                       out)


def _table_index(x, hi: int):
    """``rint(x)`` as an index clamped to [0, hi] (the JAX package's
    ``clip(rint(x).astype(int32), 0, hi)``); a NaN gives 0, so that no
    index can leave the table."""
    return torch.clamp(torch.nan_to_num(torch.round(x), nan=0.0), 0.0,
                       float(hi)).long()


def snow_aging(do_capsnow, snl, frac_sno, dtime, qflx_snwcp_ice,
               qflx_snow_grnd, h2osno, dz, h2osoi_liq, h2osoi_ice, t_soisno,
               qflx_snofrz_lyr, snowage_tau, snowage_kappa, snowage_drdt0,
               snw_rds, elm_correct_clamp: bool = False):
    """Snow effective-radius evolution: the Flanner & Zender (2006) dry
    aging from the [11, 31, 8] ``snicar_drdt`` tables over (T, dT/dz, rho),
    Brun (1989) wet growth, and the refreeze and new-snow mixing
    (``snow_hydrology_impl.hh:80-225``).  The reference clamps the aged
    radius to SNW_RDS_MIN from both sides (``impl:217-223``), so the
    radius never grows; ``elm_correct_clamp=True`` clamps it to
    [SNW_RDS_MIN, SNW_RDS_MAX] as ELM's SnowSnicarMod does, and grains
    age.  The JAX package gathers whole table rows and sums a one-hot
    over the rho bins; here the tables are indexed directly, which gives
    the same value (a sum of one entry and zeros is exact)."""
    top = _NSNO - snl
    lev = levels(_NSNO, snl)[None, :]
    layered = (snl > 0)[:, None]
    active = (lev >= top[:, None]) & layered
    at_top = lev == top[:, None]

    liq5, ice5 = h2osoi_liq[:, :_NSNO], h2osoi_ice[:, :_NSNO]
    t5 = t_soisno[:, :_NSNO]
    dz5 = dz[:, :_NSNO]
    fs = frac_sno[:, None]

    h2osno_lyr = liq5 + ice5
    h2osno_lyr_safe = torch.where(h2osno_lyr != 0.0, h2osno_lyr, 1.0)

    # temperatures at the layer's top and bottom interfaces (impl:100-107)
    t_m1 = torch.cat([t5[:, :1], t5[:, :-1]], dim=1)
    dz_m1 = torch.cat([dz5[:, :1], dz5[:, :-1]], dim=1)
    t_p1 = torch.cat([t5[:, 1:], t_soisno[:, _NSNO:_NSNO + 1]], dim=1)
    dz_p1 = torch.cat([dz5[:, 1:], dz[:, _NSNO:_NSNO + 1]], dim=1)
    den_b = torch.where(dz5 + dz_p1 != 0.0, dz5 + dz_p1, 1.0)
    den_t = torch.where(dz5 + dz_m1 != 0.0, dz5 + dz_m1, 1.0)
    t_top_itf = torch.where(
        at_top, take_layer(t_soisno, torch.clamp(top, 0, _NSNO - 1))[:, None],
        (t_m1 * dz5 + t5 * dz_m1) / den_t)
    t_btm_itf = (t_p1 * dz5 + t5 * dz_p1) / den_b

    cdz = fs * dz5
    cdz_safe = torch.where(cdz != 0.0, cdz, 1.0)
    dTdz = torch.abs((t_top_itf - t_btm_itf) / cdz_safe)
    rhos = torch.clamp(h2osno_lyr / cdz_safe, min=50.0)

    n_t, n_tgrd, n_rhos = snowage_tau.shape
    t_idx = _table_index((t5 - 223.0) / 5.0, n_t - 1)
    tgrd_idx = _table_index(dTdz / 10.0, n_tgrd - 1)
    rhos_idx = _table_index((rhos - 50.0) / 50.0, n_rhos - 1)
    bst_tau = snowage_tau[t_idx, tgrd_idx, rhos_idx]
    bst_kappa = snowage_kappa[t_idx, tgrd_idx, rhos_idx]
    bst_drdt0 = snowage_drdt0[t_idx, tgrd_idx, rhos_idx]

    dr_fresh = snw_rds - c.SNW_RDS_MIN
    dr_fresh = torch.where(torch.abs(dr_fresh) < 1.0e-8, 0.0, dr_fresh)
    kappa_safe = torch.where(bst_kappa != 0.0, bst_kappa, 1.0)
    dr = (bst_drdt0 * (bst_tau / (dr_fresh + bst_tau))
          ** rdiv(1.0, kappa_safe)) * (dtime / 3600.0)

    frc_liq = torch.clamp(liq5 / h2osno_lyr_safe, max=0.1)
    rds_safe = torch.where(snw_rds != 0.0, snw_rds, 1.0)
    dr_wet = 1.0e18 * (dtime * (4.22e-13 * frc_liq ** 3.0)
                       / (4.0 * c.ELM_PI * rds_safe ** 2.0))
    dr = dr + dr_wet

    newsnow = torch.clamp(torch.where(do_capsnow != 0, qflx_snwcp_ice,
                                      qflx_snow_grnd) * dtime, min=0.0)
    refrzsnow = torch.clamp(qflx_snofrz_lyr * dtime, min=0.0)
    frc_refrz = refrzsnow / h2osno_lyr_safe
    frc_newsnow = torch.where(at_top, newsnow[:, None] / h2osno_lyr_safe,
                              0.0)
    both = frc_refrz + frc_newsnow
    over = both > 1.0
    tot = torch.where(both != 0.0, both, 1.0)
    frc_refrz = torch.where(over, frc_refrz / tot, frc_refrz)
    frc_newsnow = torch.where(over, 1.0 - frc_refrz, frc_newsnow)
    frc_oldsnow = torch.where(over, 0.0, 1.0 - frc_refrz - frc_newsnow)

    rds_new = ((snw_rds + dr) * frc_oldsnow + c.SNW_RDS_MIN * frc_newsnow
               + 1000.0 * frc_refrz)
    hi = c.SNW_RDS_MAX if elm_correct_clamp else c.SNW_RDS_MIN
    rds_new = torch.where(rds_new < c.SNW_RDS_MIN, c.SNW_RDS_MIN, rds_new)
    rds_new = torch.where(rds_new > hi, hi, rds_new)

    out = torch.where(active, rds_new, torch.where(layered, 0.0, snw_rds))
    # thin snow without layers: fresh-snow radius in the bottom slot
    thin = (snl == 0) & (h2osno > 0.0)
    return torch.where(thin[:, None] & (lev == _NSNO - 1), c.SNW_RDS_MIN,
                       out)


class SnowBlockOut(NamedTuple):
    """What the step reads of the snow-hydrology block: the layer state
    after divide and prune, the pack scalars after combine (layerless
    columns passed through), the aerosol masses and concentrations, the
    aged radius and the block's fluxes."""
    snl: torch.Tensor
    t_soisno: torch.Tensor     # [ncol, NLEVTOT]
    h2osoi_ice: torch.Tensor
    h2osoi_liq: torch.Tensor
    dz: torch.Tensor
    z: torch.Tensor
    zi: torch.Tensor           # [ncol, NLEVTOT+1]
    snw_rds: torch.Tensor      # [ncol, NLEVSNO]
    mss: dict                  # per-species [ncol, NLEVSNO]
    cnc: dict
    h2osno: torch.Tensor
    snow_depth: torch.Tensor
    frac_sno: torch.Tensor
    frac_sno_eff: torch.Tensor
    int_snow: torch.Tensor
    qflx_snow_melt: torch.Tensor
    qflx_top_soil: torch.Tensor
    qflx_sl_top_soil: torch.Tensor
    qflx_snow2topsoi: torch.Tensor
    mflx_snowlyr_col: torch.Tensor
    mflx_neg_snow: torch.Tensor


def snow_hydrology_block(land: c.LandType, dtime, do_capsnow, snl,
                         frac_sno_eff, frac_sno, h2osno, snow_depth,
                         int_snow, qflx_sub_snow, qflx_evap_grnd,
                         qflx_dew_snow, qflx_dew_grnd, qflx_rain_grnd,
                         qflx_snomelt, qflx_snow_melt, h2osoi_liq,
                         h2osoi_ice, t_soisno, dz, z, zi, mss, aero_in,
                         n_melt, imelt, swe_old, frac_iceold, snw_rds,
                         qflx_snwcp_ice, qflx_snow_grnd, qflx_snofrz_lyr,
                         snowage_tau, snowage_kappa, snowage_drdt0,
                         elm_correct_snow_aging: bool = False
                         ) -> SnowBlockOut:
    """The snow-hydrology block of the step (the JAX package's
    ``driver/step.py`` from ``snow_water`` to the snow aging): K5
    (``ops.snow.snow_hydrology``) for CUDA tensors of which none carries
    a tangent, :func:`snow_hydrology_block_plain` otherwise.  A failed
    build or launch of K5 raises."""
    args = dict(locals())
    if uses_kernel(args):
        from elmkernels_torch.ops.snow import snow_hydrology
        return snow_hydrology(**args)
    return snow_hydrology_block_plain(**args)


def _tensors(args: dict):
    for v in args.values():
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, dict):
            yield from (t for t in v.values() if isinstance(t, torch.Tensor))


def uses_kernel(args: dict) -> bool:
    """Whether a call of :func:`snow_hydrology_block` with these arguments
    (by name) runs K5: its tensors are on the card and none of them is
    differentiated (``torch.func.jvp``, forward AD or autograd)."""
    return (_on_card(args["t_soisno"])
            and not any(tangents.carries_tangent(t)
                        for t in _tensors(args)))


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def snow_hydrology_block_plain(land: c.LandType, dtime, do_capsnow, snl,
                               frac_sno_eff, frac_sno, h2osno, snow_depth,
                               int_snow, qflx_sub_snow, qflx_evap_grnd,
                               qflx_dew_snow, qflx_dew_grnd, qflx_rain_grnd,
                               qflx_snomelt, qflx_snow_melt, h2osoi_liq,
                               h2osoi_ice, t_soisno, dz, z, zi, mss, aero_in,
                               n_melt, imelt, swe_old, frac_iceold, snw_rds,
                               qflx_snwcp_ice, qflx_snow_grnd,
                               qflx_snofrz_lyr, snowage_tau, snowage_kappa,
                               snowage_drdt0,
                               elm_correct_snow_aging: bool = False
                               ) -> SnowBlockOut:
    """The block as the chain of its functions, in the step's order:
    percolation, aerosol deposition and phase change, compaction, combine
    (layerless columns pass their pack scalars through: ELM combines only
    over the snowc filter), divide, prune, aerosol concentrations, and
    the snow aging (``snow_aging`` with ELM's clamp when
    ``elm_correct_snow_aging``, else ``snow_aging_pinned``)."""
    sw = snow_water(land, do_capsnow, snl, dtime, frac_sno_eff, h2osno,
                    qflx_sub_snow, qflx_evap_grnd, qflx_dew_snow,
                    qflx_dew_grnd, qflx_rain_grnd, qflx_snomelt,
                    qflx_snow_melt, int_snow, frac_sno, h2osoi_liq,
                    h2osoi_ice, mss, dz)
    mss = compute_aerosol_deposition(dtime, snl, aero_in, sw.mss)
    bcphi, bcpho = aerosol_phase_change(snl, dtime, qflx_sub_snow,
                                        sw.h2osoi_liq, sw.h2osoi_ice,
                                        mss["bcphi"], mss["bcpho"])
    mss = dict(mss, bcphi=bcphi, bcpho=bcpho)
    dz_c = snow_compaction(land, snl, dtime, sw.int_snow, n_melt,
                           sw.frac_sno, imelt, swe_old, sw.h2osoi_liq,
                           sw.h2osoi_ice, t_soisno, frac_iceold, sw.dz)
    st = SnowState(snl, t_soisno, sw.h2osoi_ice, sw.h2osoi_liq, snw_rds,
                   mss, dz_c, z, zi)
    cb = combine_layers(land, dtime, st, h2osno, snow_depth, frac_sno_eff,
                        sw.frac_sno, sw.int_snow)
    # ELM proper combines only over the snowc filter (columns WITH snow
    # layers); layerless columns pass their pack scalars through
    nolyr = snl == 0
    cb = cb._replace(
        h2osno=torch.where(nolyr, h2osno, cb.h2osno),
        snow_depth=torch.where(nolyr, snow_depth, cb.snow_depth),
        frac_sno=torch.where(nolyr, sw.frac_sno, cb.frac_sno),
        frac_sno_eff=torch.where(nolyr, frac_sno_eff, cb.frac_sno_eff),
        int_snow=torch.where(nolyr, sw.int_snow, cb.int_snow),
        qflx_sl_top_soil=torch.where(nolyr, 0.0, cb.qflx_sl_top_soil),
        qflx_snow2topsoi=torch.where(nolyr, 0.0, cb.qflx_snow2topsoi),
        mflx_snowlyr_col=torch.where(nolyr, 0.0, cb.mflx_snowlyr_col))
    st = divide_layers(cb.frac_sno, cb.state)
    st = prune_snow_layers(st)
    mss2, cnc = update_aerosol_mass_and_concen(
        dtime, st.snl, do_capsnow, qflx_snwcp_ice, st.ice, st.liq, st.mss)
    if elm_correct_snow_aging:
        rds = snow_aging(do_capsnow, st.snl, cb.frac_sno, dtime,
                         qflx_snwcp_ice, qflx_snow_grnd, cb.h2osno, st.dz,
                         st.liq, st.ice, st.t, qflx_snofrz_lyr, snowage_tau,
                         snowage_kappa, snowage_drdt0, st.rds,
                         elm_correct_clamp=True)
    else:
        # the reference's double clamp pins every radius: the same result
        # without the table work (snow_aging_pinned)
        rds = snow_aging_pinned(st.snl, cb.h2osno, st.rds)
    return SnowBlockOut(
        st.snl, st.t, st.ice, st.liq, st.dz, st.z, st.zi, rds, mss2, cnc,
        cb.h2osno, cb.snow_depth, cb.frac_sno, cb.frac_sno_eff, cb.int_snow,
        sw.qflx_snow_melt, sw.qflx_top_soil, cb.qflx_sl_top_soil,
        cb.qflx_snow2topsoi, cb.mflx_snowlyr_col, sw.mflx_neg_snow)
