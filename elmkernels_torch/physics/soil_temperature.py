"""Crank-Nicolson implicit snow/surface-water/soil temperature solve and
post-solve freeze/thaw phase change — batched over columns.

Counterpart of ``elmkernels_tpu/physics/soil_temperature.py`` (reference
``src/physics/soil_temperature_impl.hh``, ``soil_temp_lhs_impl.hh``,
``soil_temp_rhs_impl.hh``, ``pentadiagonal_solver_impl.hh`` and
``phase_change_impl.hh``).

The N = NLEVSNO+1+NLEVGRND = 21 row pentadiagonal system is solved with the
Askar & Karawia PDMA recurrence.  Rows above a column's top active layer
are identity rows (diag 1, rhs 0), so one recurrence from row 0 reproduces
the reference's variable-start solve.  :func:`pdma_solve` runs the
``pdma_solve`` CUDA kernel (one thread per column) for tensors on the
card and :func:`pdma_solve_plain` for tensors on the CPU.

:func:`soil_temperature_block` is the whole module as the step runs it
after ``soil_thermal.thermal_properties``: K7 (``ops.soil_temperature``,
one CUDA kernel) on the card, :func:`soil_temperature_block_plain` (the
chain of the functions below) otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.ops import tangents
from elmkernels_torch.physics.math_utils import (levels, rdiv, safe_div,
                                                 take_layer)

CNFAC = 0.5   # Crank-Nicolson factor (detail::cnfac, soil_temperature.h)
CAPR = 0.34   # tuning factor, first-layer T -> surface T
NBAND = c.NBAND
NSYS = c.NLEVSNO + 1 + c.NLEVGRND  # 21 rows: snow + ssw + soil


def calc_lwrad_emit(emg, temp):
    return emg * c.STEBOL * temp ** 4.0


def calc_dlwrad_emit(emg, t_grnd):
    return 4.0 * emg * c.STEBOL * t_grnd ** 3.0


def check_absorbed_solar(frac_sno_eff, sabg_snow, sabg_soil):
    return frac_sno_eff * sabg_snow + (1.0 - frac_sno_eff) * sabg_soil


def calc_surface_heat_flux(frac_veg_nosno, dlrad, emg, forc_lwrad, htvp,
                           solar_abg, temp, eflx_sh, qflx_ev):
    """Reference: ``soil_temperature_impl.hh:15-28``."""
    return (solar_abg + dlrad + (1.0 - frac_veg_nosno) * emg * forc_lwrad
            - calc_lwrad_emit(emg, temp) - (eflx_sh + qflx_ev * htvp))


def calc_dhsdT(cgrnd, emg, t_grnd):
    return -cgrnd - calc_dlwrad_emit(emg, t_grnd)


def calc_diffusive_heat_flux(snl, tk, t_soisno, z):
    """Interface diffusive heat flux fn [ncol, NLEVTOT]; fn(i) between
    cells i and i+1; bottom flux 0 (``soil_temperature_impl.hh:47-75``)."""
    fn_inner = tk[:, :-1] * (t_soisno[:, 1:] - t_soisno[:, :-1]) / (
        z[:, 1:] - z[:, :-1])
    active = (levels(c.NLEVTOT - 1, z)[None, :]
              >= (c.NLEVSNO - snl)[:, None])
    fn_inner = torch.where(active, fn_inner, 0.0)
    return torch.cat([fn_inner, torch.zeros_like(fn_inner[:, :1])], dim=1)


def calc_heat_flux_matrix_factor(snl, dtime, cv, dz, z, zi):
    """Matrix factor fact = dt/cv (surface-layer adjusted at the top active
    layer) [ncol, NLEVTOT] (``soil_temperature_impl.hh:92-120``)."""
    lev = levels(c.NLEVTOT, z)[None, :]
    top = (c.NLEVSNO - snl)[:, None]
    at_top = lev == top
    below = lev > top

    cv_safe = torch.where(cv != 0.0, cv, 1.0)
    base = rdiv(dtime, cv_safe)
    z_tp1 = torch.cat([z[:, 1:], z[:, -1:]], dim=1)  # z(i+1), padded
    top_fact = base * dz / (0.5 * (z - zi[:, :c.NLEVTOT]
                                   + CAPR * (z_tp1 - zi[:, :c.NLEVTOT])))
    return torch.where(at_top, top_fact, torch.where(below, base, 0.0))


def _assemble_system(snl, dtime, dhsdT, frac_sno_eff, frac_h2osfc,
                     dz_h2osfc, c_h2osfc, tk_h2osfc, z, fact, tk,
                     hs_top_snow, hs_soil, hs_h2osfc, t_soisno, t_h2osfc,
                     fn, sabg_lyr):
    """Build the banded LHS [ncol, 21, 5] and RHS [ncol, 21].

    Bands: 0 = 2nd superdiag, 1 = 1st superdiag, 2 = diag, 3 = 1st subdiag,
    4 = 2nd subdiag (``soil_temp_lhs_impl.hh:2-94`` layout).  Inactive rows
    become identity rows.
    """
    ncol = snl.shape[0]
    nsno = c.NLEVSNO
    top = nsno - snl  # [ncol] top active row

    lhs = z.new_zeros((ncol, NSYS, NBAND))
    rhs = z.new_zeros((ncol, NSYS))

    # ---- snow rows (0..nsno-1) ----
    lev_s = levels(nsno, z)
    has_snow = (snl > 0)[:, None]
    at_top_s = (lev_s[None, :] == top[:, None]) & has_snow
    below_top_s = (lev_s[None, :] > top[:, None]) & has_snow

    z_sno = z[:, :nsno]
    z_p1 = z[:, 1:nsno + 1]
    z_m1 = torch.cat([z[:, :1], z[:, :nsno - 1]], dim=1)
    tk_s = tk[:, :nsno]
    tk_m1 = torch.cat([tk[:, :1], tk[:, :nsno - 1]], dim=1)
    fact_s = fact[:, :nsno]
    dzp = z_p1 - z_sno
    dzm = z_sno - z_m1
    dzp_s = torch.where(dzp != 0.0, dzp, 1.0)
    dzm_s = torch.where(dzm != 0.0, dzm, 1.0)

    diag_top = (1.0 + (1.0 - CNFAC) * fact_s * tk_s / dzp_s
                - fact_s * dhsdT[:, None])
    sup_top = -(1.0 - CNFAC) * fact_s * tk_s / dzp_s
    diag_mid = (1.0 + (1.0 - CNFAC) * fact_s
                * (tk_s / dzp_s + tk_m1 / dzm_s))
    sub_mid = -(1.0 - CNFAC) * fact_s * tk_m1 / dzm_s
    sup_mid = -(1.0 - CNFAC) * fact_s * tk_s / dzp_s

    multi = (snl > 1)[:, None]
    not_bottom = lev_s[None, :] != nsno - 1
    lhs[:, :nsno, 2] = torch.where(at_top_s, diag_top,
                                   torch.where(below_top_s, diag_mid, 0.0))
    lhs[:, :nsno, 1] = torch.where(
        at_top_s & multi, sup_top,
        torch.where(below_top_s & not_bottom, sup_mid, 0.0))
    lhs[:, :nsno, 3] = torch.where(below_top_s, sub_mid, 0.0)

    # snow-soil coupling: bottom snow row, band 0 (2nd superdiag skips the
    # ssw row to reach the top soil row)
    dz_ss = z[:, nsno] - z[:, nsno - 1]
    lhs[:, nsno - 1, 0] = torch.where(
        snl > 0,
        -(1.0 - CNFAC) * fact[:, nsno - 1] * tk[:, nsno - 1] / dz_ss, 0.0)

    # snow RHS
    t_s = t_soisno[:, :nsno]
    fn_s = fn[:, :nsno]
    fn_m1 = torch.cat([fn[:, :1], fn[:, :nsno - 1]], dim=1)
    rt_top = t_s + fact_s * (hs_top_snow[:, None]
                             - dhsdT[:, None] * t_s + CNFAC * fn_s)
    rt_mid = (t_s + CNFAC * fact_s * (fn_s - fn_m1)
              + fact_s * sabg_lyr[:, :nsno])
    rhs[:, :nsno] = torch.where(at_top_s, rt_top,
                                torch.where(below_top_s, rt_mid, 0.0))

    # ---- standing surface water row (nsno) ----
    c_sfc = torch.where(c_h2osfc != 0.0, c_h2osfc, 1.0)
    denom_sfc = 0.5 * dz_h2osfc + z[:, nsno]
    lhs[:, nsno, 2] = (1.0 + (1.0 - CNFAC) * rdiv(dtime, c_sfc) * tk_h2osfc
                       / denom_sfc - rdiv(dtime, c_sfc) * dhsdT)
    lhs[:, nsno, 1] = (-(1.0 - CNFAC) * rdiv(dtime, c_sfc) * tk_h2osfc
                       / denom_sfc)
    fn_h2osfc = tk_h2osfc * (t_soisno[:, nsno] - t_h2osfc) / denom_sfc
    rhs[:, nsno] = t_h2osfc + rdiv(dtime, c_sfc) * (hs_h2osfc - dhsdT * t_h2osfc
                                                 + CNFAC * fn_h2osfc)

    # ---- soil rows (nsno+1 .. NSYS-1) ----
    ngr = c.NLEVGRND
    z_g = z[:, nsno:]
    z_gp1 = torch.cat([z[:, nsno + 1:], z[:, -1:]], dim=1)
    z_gm1 = z[:, nsno - 1:nsno + ngr - 1]
    tk_g = tk[:, nsno:]
    tk_gm1 = tk[:, nsno - 1:nsno + ngr - 1]
    fact_g = fact[:, nsno:]
    dzp_g = torch.where(z_gp1 - z_g != 0.0, z_gp1 - z_g, 1.0)
    dzm_g = z_g - z_gm1

    lev_g = levels(ngr, z)
    first = lev_g[None, :] == 0
    last = lev_g[None, :] == ngr - 1

    # first soil row
    no_sno = snl == 0
    d_first_nosno = (1.0 + (1.0 - CNFAC) * fact_g[:, 0] * tk_g[:, 0]
                     / dzp_g[:, 0] - fact_g[:, 0] * dhsdT)
    d_first_sno = (1.0 + (1.0 - CNFAC) * fact_g[:, 0]
                   * (tk_g[:, 0] / dzp_g[:, 0]
                      + frac_sno_eff * tk_gm1[:, 0] / dzm_g[:, 0])
                   - (1.0 - frac_sno_eff) * fact_g[:, 0] * dhsdT)
    d_first = torch.where(no_sno, d_first_nosno, d_first_sno)
    # h2osfc diagonal correction
    dzm_sfc = 0.5 * dz_h2osfc + z[:, nsno]
    d_first = d_first + torch.where(
        frac_h2osfc != 0.0,
        frac_h2osfc * ((1.0 - CNFAC) * fact_g[:, 0] * tk_h2osfc / dzm_sfc
                       + fact_g[:, 0] * dhsdT), 0.0)
    sup_first = -(1.0 - CNFAC) * fact_g[:, 0] * tk_g[:, 0] / dzp_g[:, 0]

    d_int = (1.0 + (1.0 - CNFAC) * fact_g
             * (tk_g / dzp_g + tk_gm1 / dzm_g))
    sub_int = -(1.0 - CNFAC) * fact_g * tk_gm1 / dzm_g
    sup_int = -(1.0 - CNFAC) * fact_g * tk_g / dzp_g
    d_last = 1.0 + (1.0 - CNFAC) * fact_g * tk_gm1 / dzm_g

    lhs[:, nsno + 1:, 2] = torch.where(first, d_first[:, None],
                                       torch.where(last, d_last, d_int))
    lhs[:, nsno + 1:, 1] = torch.where(first, sup_first[:, None],
                                       torch.where(last, 0.0, sup_int))
    lhs[:, nsno + 1:, 3] = torch.where(first, 0.0, sub_int)

    # soil-snow (band 4 of first soil row) and soil-ssw (band 3)
    lhs[:, nsno + 1, 4] = torch.where(
        no_sno, 0.0,
        -frac_sno_eff * (1.0 - CNFAC) * fact[:, nsno] * tk[:, nsno - 1]
        / dzm_g[:, 0])
    lhs[:, nsno + 1, 3] = torch.where(
        frac_h2osfc != 0.0,
        -frac_h2osfc * (1.0 - CNFAC) * fact[:, nsno] * tk_h2osfc / dzm_sfc,
        0.0)

    # soil RHS
    t_g = t_soisno[:, nsno:]
    fn_g = fn[:, nsno:]
    fn_gm1 = fn[:, nsno - 1:nsno + ngr - 1]
    rt_first_nosno = (t_g[:, 0] + fact_g[:, 0]
                      * (hs_top_snow - dhsdT * t_g[:, 0]
                         + CNFAC * fn_g[:, 0]))
    rt_first_sno = (t_g[:, 0] + fact_g[:, 0]
                    * ((1.0 - frac_sno_eff)
                       * (hs_soil - dhsdT * t_g[:, 0])
                       + CNFAC * (fn_g[:, 0]
                                  - frac_sno_eff * fn_gm1[:, 0]))
                    + frac_sno_eff * fact_g[:, 0] * sabg_lyr[:, nsno])
    rt_first = torch.where(no_sno, rt_first_nosno, rt_first_sno)
    rt_int = t_g + CNFAC * fact_g * (fn_g - fn_gm1)
    rt_last = t_g - CNFAC * fact_g * fn_gm1 + fact_g * fn_g
    rhs[:, nsno + 1:] = torch.where(first, rt_first[:, None],
                                    torch.where(last, rt_last, rt_int))

    # ---- identity rows above the top active layer ----
    inactive = levels(NSYS, z)[None, :] < top[:, None]
    ident = z.new_zeros((1, 1, NBAND))
    ident[..., 2] = 1.0
    lhs = torch.where(inactive[:, :, None], ident, lhs)
    rhs = torch.where(inactive, 0.0, rhs)
    return lhs, rhs


def pdma_solve_plain(lhs, rhs):
    """Batched pentadiagonal solve (Askar & Karawia 2015), row by row in
    the JAX package's operation order (``pentadiagonal_solver_impl.hh:
    14-76``); identity rows give A = B = Z = 0."""
    N = NSYS
    d = lhs
    A, B, Z = [None] * N, [None] * N, [None] * N
    U = 1.0 / d[:, 0, 2]
    A[0] = d[:, 0, 1] * U
    B[0] = d[:, 0, 0] * U
    Z[0] = rhs[:, 0] * U

    Y = d[:, 1, 3]
    U = 1.0 / (d[:, 1, 2] - A[0] * Y)
    A[1] = (d[:, 1, 1] - B[0] * Y) * U
    B[1] = d[:, 1, 0] * U
    Z[1] = (rhs[:, 1] - Z[0] * Y) * U

    for i in range(2, N):
        Y = d[:, i, 3] - A[i - 2] * d[:, i, 4]
        U = 1.0 / (d[:, i, 2] - B[i - 2] * d[:, i, 4] - A[i - 1] * Y)
        A[i] = (d[:, i, 1] - B[i - 1] * Y) * U
        B[i] = d[:, i, 0] * U
        Z[i] = (rhs[:, i] - Z[i - 2] * d[:, i, 4] - Z[i - 1] * Y) * U

    x = [None] * N
    x[N - 1] = Z[N - 1]
    x[N - 2] = Z[N - 2] - A[N - 2] * x[N - 1]
    for i in range(N - 3, -1, -1):
        x[i] = Z[i] - A[i] * x[i + 1] - B[i] * x[i + 2]
    return torch.stack(x, dim=1)


def band_matvec(lhs, x):
    """``A x`` for the banded ``lhs`` [ncol, 21, 5] (bands: 2nd super,
    super, diag, sub, 2nd sub) and ``x`` [ncol, 21]."""
    n = x.shape[1]
    xp = torch.nn.functional.pad(x, (2, 2))
    return sum(lhs[:, :, b] * xp[:, 4 - b:4 - b + n] for b in range(NBAND))


def pdma_solve(lhs, rhs):
    """The pentadiagonal solve: the CUDA kernel for tensors on the card
    (through ``ops.pdma.PdmaSolve``, whose tangent rule launches it again),
    :func:`pdma_solve_plain` for tensors on the CPU."""
    if lhs.is_cuda:
        from elmkernels_torch.ops.pdma import solve
        return solve(lhs, rhs)
    return pdma_solve_plain(lhs, rhs)


class SolveOut(NamedTuple):
    t_soisno: torch.Tensor
    t_h2osfc: torch.Tensor


def update_temperature(snl, frac_h2osfc, tvector, t_soisno_old) -> SolveOut:
    """Scatter the 21-row solution back into t_soisno / t_h2osfc."""
    nsno = c.NLEVSNO
    active = levels(nsno, snl)[None, :] >= (nsno - snl)[:, None]
    t_snow = torch.where(active, tvector[:, :nsno], t_soisno_old[:, :nsno])
    t_soil = tvector[:, nsno + 1:]
    t_soisno = torch.cat([t_snow, t_soil], dim=1)
    t_h2osfc = torch.where(frac_h2osfc != 0.0, tvector[:, nsno],
                           t_soisno[:, nsno])
    return SolveOut(t_soisno, t_h2osfc)


def update_t_grnd(snl, frac_h2osfc, frac_sno_eff, t_h2osfc, t_soisno):
    """Reference: ``soil_temperature_impl.hh:178-205``."""
    nsno = c.NLEVSNO
    t_top_sno = take_layer(t_soisno, nsno - snl)
    t_top_soil = t_soisno[:, nsno]
    has_sfc = frac_h2osfc != 0.0
    with_snow = torch.where(
        has_sfc,
        frac_sno_eff * t_top_sno
        + (1.0 - frac_sno_eff - frac_h2osfc) * t_top_soil
        + frac_h2osfc * t_h2osfc,
        frac_sno_eff * t_top_sno + (1.0 - frac_sno_eff) * t_top_soil)
    without = torch.where(
        has_sfc,
        (1.0 - frac_h2osfc) * t_top_soil + frac_h2osfc * t_h2osfc,
        t_top_soil)
    return torch.where(snl > 0, with_snow, without)


class PhaseChangeH2osfcOut(NamedTuple):
    t_h2osfc: torch.Tensor
    h2osfc: torch.Tensor
    xmf_h2osfc: torch.Tensor
    qflx_h2osfc_to_ice: torch.Tensor
    eflx_h2osfc_to_snow: torch.Tensor
    h2osno: torch.Tensor
    int_snow: torch.Tensor
    snow_depth: torch.Tensor
    h2osoi_ice_sl1: torch.Tensor  # bottom snow layer ice
    t_soisno_sl1: torch.Tensor    # bottom snow layer temperature


def phase_change_h2osfc(snl, dtime, frac_sno, frac_h2osfc, dhsdT, c_h2osfc,
                        fact_sl1, t_h2osfc, h2osfc, h2osno, int_snow,
                        snow_depth, h2osoi_ice_sl1,
                        t_soisno_sl1) -> PhaseChangeH2osfcOut:
    """Freezing of standing surface water into the snow pack
    (``phase_change_impl.hh:12-153``)."""
    frz = (frac_h2osfc > 0.0) & (t_h2osfc <= c.TFRZ)

    tinc = c.TFRZ - t_h2osfc
    hm = frac_h2osfc * (dhsdT * tinc - tinc * c_h2osfc / dtime)
    xm = hm * dtime / c.HFUS
    temp1 = h2osfc + xm
    z_avg = frac_sno * snow_depth
    rho_avg = torch.where(
        z_avg > 0.0,
        torch.clamp(safe_div(h2osno, z_avg, z_avg > 0.0), max=800.0), 200.0)

    # ---- partial freeze (xm < h2osfc): temp1 >= 0 ----
    part = frz & (temp1 >= 0.0)
    h2osno_p = h2osno - xm
    int_snow_p = int_snow - xm
    ice_p = torch.where(snl > 0, h2osoi_ice_sl1 - xm, h2osoi_ice_sl1)
    h2osfc_p = h2osfc + xm
    xmf_p = hm
    qflx_p = -xm / dtime
    depth_p = torch.where((frac_sno > 0) & (snl > 0),
                          safe_div(h2osno_p, rho_avg * frac_sno,
                                   (rho_avg * frac_sno) != 0.0),
                          h2osno_p / c.DENICE)
    # snow-layer temperature adjustment
    fact_safe = torch.where(fact_sl1 != 0.0, fact_sl1, 1.0)
    c1_p = torch.where(snl == 1,
                       frac_sno * (rdiv(dtime, fact_safe) - dhsdT * dtime),
                       frac_sno / fact_safe * dtime)
    c2_p = torch.where(frac_h2osfc != 0.0,
                       -c.CPWAT * xm - frac_h2osfc * dhsdT * dtime, 0.0)
    den_p = torch.where(c1_p + c2_p != 0.0, c1_p + c2_p, 1.0)
    t_sl1_p = torch.where(snl == 0, c.TFRZ,
                          (c1_p * t_soisno_sl1 + c2_p * c.TFRZ) / den_p)
    eflx_p = torch.where(snl == 0, 0.0, (c.TFRZ - t_sl1_p) * c2_p / dtime)

    # ---- full freeze (xm > h2osfc): temp1 < 0 ----
    full = frz & (temp1 < 0.0)
    den_rho = torch.where(h2osno + h2osfc != 0.0, h2osno + h2osfc, 1.0)
    rho_avg_f = (h2osno * rho_avg + h2osfc * c.DENICE) / den_rho
    h2osno_f = h2osno + h2osfc
    int_snow_f = int_snow + h2osfc
    qflx_f = h2osfc / dtime
    ice_f = torch.where(snl > 0, h2osoi_ice_sl1 + h2osfc, h2osoi_ice_sl1)
    t_sfc_cooled = c.TFRZ - temp1 * c.HFUS / (dtime * dhsdT - c_h2osfc)
    xmf_f = hm - frac_h2osfc * temp1 * c.HFUS / dtime
    c1_f = torch.where(snl == 1,
                       frac_sno * (rdiv(dtime, fact_safe) - dhsdT * dtime),
                       frac_sno / fact_safe * dtime)
    c2_f = torch.where(frac_h2osfc != 0.0,
                       frac_h2osfc * (c_h2osfc - dtime * dhsdT), 0.0)
    den_f = torch.where(c1_f + c2_f != 0.0, c1_f + c2_f, 1.0)
    t_sl1_f = torch.where(
        snl == 0, t_sfc_cooled,
        (c1_f * t_soisno_sl1 + c2_f * t_sfc_cooled) / den_f)
    t_sfc_f = torch.where(snl == 0, t_sfc_cooled, t_sl1_f)
    depth_f = torch.where((frac_sno > 0.0) & (snl > 0),
                          safe_div(h2osno_f, rho_avg_f * frac_sno,
                                   (rho_avg_f * frac_sno) != 0.0),
                          h2osno_f / c.DENICE)

    def pick(pv, fv, ov):
        return torch.where(part, pv, torch.where(full, fv, ov))

    zero = torch.zeros_like(h2osfc)
    return PhaseChangeH2osfcOut(
        t_h2osfc=pick(torch.full_like(t_h2osfc, c.TFRZ), t_sfc_f, t_h2osfc),
        h2osfc=pick(h2osfc_p, zero, h2osfc),
        xmf_h2osfc=pick(xmf_p, xmf_f, zero),
        qflx_h2osfc_to_ice=pick(qflx_p, qflx_f, zero),
        eflx_h2osfc_to_snow=pick(eflx_p, zero, zero),
        h2osno=pick(h2osno_p, h2osno_f, h2osno),
        int_snow=pick(int_snow_p, int_snow_f, int_snow),
        snow_depth=pick(depth_p, depth_f, snow_depth),
        h2osoi_ice_sl1=pick(ice_p, ice_f, h2osoi_ice_sl1),
        t_soisno_sl1=pick(t_sl1_p, t_sl1_f, t_soisno_sl1))


class PhaseChangeSoisnoOut(NamedTuple):
    h2osno: torch.Tensor
    snow_depth: torch.Tensor
    xmf: torch.Tensor
    qflx_snofrz: torch.Tensor
    qflx_snow_melt: torch.Tensor
    qflx_snomelt: torch.Tensor
    eflx_snomelt: torch.Tensor
    imelt: torch.Tensor           # [ncol, NLEVTOT]
    qflx_snofrz_lyr: torch.Tensor  # [ncol, NLEVSNO]
    h2osoi_ice: torch.Tensor
    h2osoi_liq: torch.Tensor
    t_soisno: torch.Tensor


def phase_change_soisno(land: c.LandType, snl, dtime, dhsdT, frac_h2osfc,
                        frac_sno_eff, fact, watsat, sucsat, bsw, dz, h2osno,
                        snow_depth, h2osoi_ice, h2osoi_liq,
                        t_soisno) -> PhaseChangeSoisnoOut:
    """Post-solve melt/freeze correction for snow and soil layers
    (``phase_change_impl.hh:184-417``).  The one sequential dependency —
    the thin-snow adjustment of h2osno/snow_depth at the top soil layer —
    is handled explicitly; the rest vectorizes over layers."""
    nsno = c.NLEVSNO
    lev = levels(c.NLEVTOT, snl)[None, :]
    top = (nsno - snl)[:, None]
    active = lev >= top
    is_snow = lev < nsno
    is_soil = ~is_snow
    at_top = lev == top
    at_topsoil = lev == nsno

    # ---- melt/freeze identification (sets T to TFRZ, computes tinc) ----
    melt = active & (h2osoi_ice > 0.0) & (t_soisno > c.TFRZ)
    imelt = melt.long()

    # supercooled water content for soil layers (Zhao 1997, Koren 1999)
    scmask = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
    if scmask is not False:
        t_soil = t_soisno[:, nsno:]
        smp = (c.HFUS * (c.TFRZ - t_soil) / (c.GRAV * t_soil) * 1000.0)
        sc = (watsat * torch.clamp(smp / sucsat, min=1e-300)
              ** (-1.0 / bsw) * dz[:, nsno:] * 1000.0)
        supercool = torch.where(t_soil < c.TFRZ, sc, 0.0)
        if scmask is not True:
            supercool = c.lsel(scmask, supercool, torch.zeros_like(watsat))
    else:
        supercool = torch.zeros_like(watsat)
    supercool_full = torch.cat(
        [torch.zeros_like(h2osoi_ice[:, :nsno]), supercool], dim=1)

    frz_sno = active & is_snow & (h2osoi_liq > 0.0) & (t_soisno < c.TFRZ)
    frz_soil = (active & is_soil & (h2osoi_liq > supercool_full)
                & (t_soisno < c.TFRZ))
    imelt = torch.where(frz_sno | frz_soil, 2, imelt)

    # thin snow on bare soil: melt at the top soil layer
    thin = ((snl == 0) & (h2osno > 0.0))[:, None] & at_topsoil
    thin_melt = thin & (t_soisno > c.TFRZ)
    imelt = torch.where(thin_melt, 1, imelt)

    changed = imelt > 0
    tinc = torch.where(changed, c.TFRZ - t_soisno, 0.0)
    t_soisno = torch.where(changed, c.TFRZ, t_soisno)

    # ---- energy surplus/deficit hm ----
    fact_safe = torch.where(fact != 0.0, fact, 1.0)
    hm_top_snow = frac_sno_eff[:, None] * (dhsdT[:, None] * tinc
                                           - tinc / fact_safe)
    hm_top_soil_raw = dhsdT[:, None] * tinc - tinc / fact_safe
    hm_top_soil = torch.where((frac_h2osfc != 0.0)[:, None],
                              hm_top_soil_raw
                              - frac_h2osfc[:, None] * dhsdT[:, None] * tinc,
                              hm_top_soil_raw)
    hm_under = ((1.0 - frac_sno_eff - frac_h2osfc)[:, None]
                * dhsdT[:, None] * tinc - tinc / fact_safe)
    hm_int_snow = -frac_sno_eff[:, None] * (tinc / fact_safe)
    hm_int_soil = -tinc / fact_safe

    hm = torch.where(
        at_top, torch.where(is_snow, hm_top_snow, hm_top_soil),
        torch.where(at_topsoil, hm_under,
                    torch.where(is_snow, hm_int_snow, hm_int_soil)))
    hm = torch.where(changed, hm, 0.0)

    # tridiagonal round-off guards
    bad = ((imelt == 1) & (hm < 0.0)) | ((imelt == 2) & (hm > 0.0))
    hm = torch.where(bad, 0.0, hm)
    imelt = torch.where(bad, 0, imelt)

    do_pc = (imelt > 0) & (torch.abs(hm) > 0.0)
    xm = hm * dtime / c.HFUS

    # ---- thin-snow melt at top soil layer (mutates h2osno/snow_depth) ----
    xm_ts = xm[:, nsno]
    hm_ts = hm[:, nsno]
    do_ts = ((snl == 0) & (h2osno > 0.0) & (xm_ts > 0.0)
             & (torch.abs(hm_ts) > 0.0) & (imelt[:, nsno] > 0))
    temp1 = h2osno
    h2osno_new = torch.clamp(temp1 - xm_ts, min=0.0)
    propor = safe_div(h2osno_new, temp1, temp1 != 0.0)
    heatr_ts = hm_ts - c.HFUS * (temp1 - h2osno_new) / dtime
    xm_ts_new = torch.where(heatr_ts > 0.0, heatr_ts * dtime / c.HFUS, 0.0)
    hm_ts_new = torch.where(heatr_ts > 0.0, heatr_ts, 0.0)
    qflx_snomelt0 = torch.where(
        do_ts, torch.clamp(temp1 - h2osno_new, min=0.0) / dtime, 0.0)
    xmf0 = torch.where(do_ts, c.HFUS * qflx_snomelt0, 0.0)
    h2osno = torch.where(do_ts, h2osno_new, h2osno)
    snow_depth = torch.where(do_ts, snow_depth * propor, snow_depth)
    ts_row = at_topsoil & do_ts[:, None]
    xm = torch.where(ts_row, xm_ts_new[:, None], xm)
    hm = torch.where(ts_row, hm_ts_new[:, None], hm)

    # ---- ice/liquid adjustment ----
    wmass0 = h2osoi_ice + h2osoi_liq
    wice0 = h2osoi_ice
    ice_melting = torch.clamp(wice0 - xm, min=0.0)
    ice_freezing_snow = torch.minimum(wmass0, wice0 - xm)
    ice_freezing_soil = torch.where(
        wmass0 < supercool_full, 0.0,
        torch.minimum(wmass0 - supercool_full, wice0 - xm))
    ice_new = torch.where(
        xm > 0.0, ice_melting,
        torch.where(xm < 0.0,
                    torch.where(is_snow, ice_freezing_snow,
                                ice_freezing_soil),
                    wice0))
    ice_new = torch.where(do_pc, ice_new, h2osoi_ice)
    heatr = torch.where(do_pc & (xm != 0.0),
                        hm - c.HFUS * (wice0 - ice_new) / dtime, 0.0)
    liq_new = torch.where(do_pc, torch.clamp(wmass0 - ice_new, min=0.0),
                          h2osoi_liq)

    # ---- residual-heat temperature adjustment ----
    fse = frac_sno_eff[:, None]
    fse_safe = torch.where(fse != 0.0, fse, 1.0)
    adj_top = torch.where(
        (snl == 0)[:, None],
        fact * heatr / (1.0 - (1.0 - frac_h2osfc[:, None]) * fact
                        * dhsdT[:, None]),
        (fact / fse_safe) * heatr / (1.0 - fact * dhsdT[:, None]))
    adj_topsoil = fact * heatr / (
        1.0 - (1.0 - fse - frac_h2osfc[:, None]) * fact * dhsdT[:, None])
    adj_soil = fact * heatr
    adj_snow = torch.where(fse > 0.0, (fact / fse_safe) * heatr, 0.0)
    adj = torch.where(at_top, adj_top,
                      torch.where(at_topsoil, adj_topsoil,
                                  torch.where(is_soil, adj_soil, adj_snow)))
    apply_adj = do_pc & (torch.abs(heatr) > 0.0)
    t_soisno = t_soisno + torch.where(apply_adj, adj, 0.0)
    # snow layers with coexisting liquid+ice snap to freezing
    snap = apply_adj & is_snow & (liq_new * ice_new > 0.0)
    t_soisno = torch.where(snap, c.TFRZ, t_soisno)

    # ---- flux accumulation ----
    dice = torch.where(do_pc, wice0 - ice_new, 0.0)
    xmf = xmf0 + torch.sum(c.HFUS * dice / dtime, dim=1)
    qflx_snomelt = qflx_snomelt0 + torch.sum(
        torch.where((imelt == 1) & is_snow & do_pc,
                    torch.clamp(dice, min=0.0) / dtime, 0.0), dim=1)
    qflx_snofrz_lyr = torch.where(
        (imelt[:, :nsno] == 2) & do_pc[:, :nsno],
        torch.clamp(ice_new[:, :nsno] - wice0[:, :nsno], min=0.0) / dtime,
        0.0)
    qflx_snofrz = torch.sum(
        torch.where(imelt[:, :nsno] == 2, qflx_snofrz_lyr, 0.0), dim=1)
    qflx_snow_melt = torch.where(do_ts, qflx_snomelt0, 0.0)
    eflx_snomelt = qflx_snomelt * c.HFUS

    return PhaseChangeSoisnoOut(
        h2osno=h2osno, snow_depth=snow_depth, xmf=xmf,
        qflx_snofrz=qflx_snofrz, qflx_snow_melt=qflx_snow_melt,
        qflx_snomelt=qflx_snomelt, eflx_snomelt=eflx_snomelt, imelt=imelt,
        qflx_snofrz_lyr=qflx_snofrz_lyr, h2osoi_ice=ice_new,
        h2osoi_liq=liq_new, t_soisno=t_soisno)


class SoilTemperatureOut(NamedTuple):
    """What the step reads of the module after the solve and the phase
    changes: the absorbed-solar check, dhsdT and fact; the phase changes'
    fluxes; the new temperatures, water and snow."""
    sabg_chk: torch.Tensor
    dhsdT: torch.Tensor
    fact: torch.Tensor               # [ncol, NLEVTOT]
    t_soisno: torch.Tensor           # [ncol, NLEVTOT]
    h2osoi_ice: torch.Tensor         # [ncol, NLEVTOT]
    h2osoi_liq: torch.Tensor         # [ncol, NLEVTOT]
    t_h2osfc: torch.Tensor
    t_grnd: torch.Tensor
    h2osfc: torch.Tensor
    int_snow: torch.Tensor
    h2osno: torch.Tensor
    snow_depth: torch.Tensor
    xmf_h2osfc: torch.Tensor
    qflx_h2osfc_to_ice: torch.Tensor
    eflx_h2osfc_to_snow: torch.Tensor
    xmf: torch.Tensor
    qflx_snomelt: torch.Tensor
    qflx_snow_melt: torch.Tensor
    imelt: torch.Tensor              # [ncol, NLEVTOT] int64
    qflx_snofrz_lyr: torch.Tensor    # [ncol, NLEVSNO]


def soil_temperature_block(land: c.LandType, dtime, snl, frac_veg_nosno,
                           frac_sno_eff, frac_sno, frac_h2osfc, h2osfc,
                           h2osno, int_snow, snow_depth, t_grnd, t_h2osfc,
                           sabg_snow, sabg_soil, sabg_lyr, dlrad, emg,
                           forc_lwrad, htvp, eflx_sh_soil, qflx_ev_soil,
                           eflx_sh_h2osfc, qflx_ev_h2osfc, eflx_sh_snow,
                           qflx_ev_snow, cgrnd, t_soisno, h2osoi_liq,
                           h2osoi_ice, dz, z, zi, tk, cv, dz_h2osfc,
                           c_h2osfc, tk_h2osfc, watsat, sucsat,
                           bsw) -> SoilTemperatureOut:
    """The soil temperature module of the step, from the surface heat
    fluxes to the ground temperature (the JAX package's ``driver/step.py``
    588-637 after ``thermal_properties``): K7
    (``ops.soil_temperature.soil_temperature``) for CUDA tensors of which
    none carries a tangent, :func:`soil_temperature_block_plain`
    otherwise.  A failed build or launch of K7 raises."""
    args = dict(locals())
    if uses_kernel(args):
        from elmkernels_torch.ops.soil_temperature import soil_temperature
        return soil_temperature(**args)
    return soil_temperature_block_plain(**args)


def uses_kernel(args: dict) -> bool:
    """Whether a call of :func:`soil_temperature_block` with these
    arguments (by name) runs K7: its tensors are on the card and none of
    them is differentiated (``torch.func.jvp``, forward AD or autograd)."""
    return (_on_card(args["t_soisno"])
            and not any(tangents.carries_tangent(t)
                        for t in args.values()
                        if isinstance(t, torch.Tensor)))


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def soil_temperature_block_plain(land: c.LandType, dtime, snl,
                                 frac_veg_nosno, frac_sno_eff, frac_sno,
                                 frac_h2osfc, h2osfc, h2osno, int_snow,
                                 snow_depth, t_grnd, t_h2osfc, sabg_snow,
                                 sabg_soil, sabg_lyr, dlrad, emg, forc_lwrad,
                                 htvp, eflx_sh_soil, qflx_ev_soil,
                                 eflx_sh_h2osfc, qflx_ev_h2osfc,
                                 eflx_sh_snow, qflx_ev_snow, cgrnd, t_soisno,
                                 h2osoi_liq, h2osoi_ice, dz, z, zi, tk, cv,
                                 dz_h2osfc, c_h2osfc, tk_h2osfc, watsat,
                                 sucsat, bsw) -> SoilTemperatureOut:
    """The module as the chain of its functions, in the step's order:
    the surface heat fluxes and dhsdT, the diffusive flux and the matrix
    factor, the system and its solve (:func:`pdma_solve`: K4 through
    ``ops.pdma.PdmaSolve`` on the card, whose tangent rule the sensitivity
    path runs), the new temperatures, the two phase changes and the ground
    temperature."""
    nsno = c.NLEVSNO
    snotop = nsno - snl
    sabg_lyr_top = take_layer(sabg_lyr, snotop)
    t_top_sno = take_layer(t_soisno, snotop)
    sabg_chk = check_absorbed_solar(frac_sno_eff, sabg_snow, sabg_soil)
    hs_soil = calc_surface_heat_flux(
        frac_veg_nosno, dlrad, emg, forc_lwrad, htvp, sabg_soil,
        t_soisno[:, nsno], eflx_sh_soil, qflx_ev_soil)
    hs_h2osfc = calc_surface_heat_flux(
        frac_veg_nosno, dlrad, emg, forc_lwrad, htvp, sabg_soil, t_h2osfc,
        eflx_sh_h2osfc, qflx_ev_h2osfc)
    hs_top_snow = calc_surface_heat_flux(
        frac_veg_nosno, dlrad, emg, forc_lwrad, htvp, sabg_lyr_top,
        t_top_sno, eflx_sh_snow, qflx_ev_snow)
    dhsdT = calc_dhsdT(cgrnd, emg, t_grnd)

    fn = calc_diffusive_heat_flux(snl, tk, t_soisno, z)
    fact = calc_heat_flux_matrix_factor(snl, dtime, cv, dz, z, zi)
    lhs, rhs = _assemble_system(
        snl, dtime, dhsdT, frac_sno_eff, frac_h2osfc, dz_h2osfc, c_h2osfc,
        tk_h2osfc, z, fact, tk, hs_top_snow, hs_soil, hs_h2osfc, t_soisno,
        t_h2osfc, fn, sabg_lyr)
    tvec = pdma_solve(lhs, rhs)
    upd = update_temperature(snl, frac_h2osfc, tvec, t_soisno)

    pc1 = phase_change_h2osfc(
        snl, dtime, frac_sno, frac_h2osfc, dhsdT, c_h2osfc,
        fact[:, nsno - 1], upd.t_h2osfc, h2osfc, h2osno, int_snow,
        snow_depth, h2osoi_ice[:, nsno - 1], upd.t_soisno[:, nsno - 1])
    ice_a = h2osoi_ice.clone()
    ice_a[:, nsno - 1] = pc1.h2osoi_ice_sl1
    t_a = upd.t_soisno.clone()
    t_a[:, nsno - 1] = pc1.t_soisno_sl1
    pc2 = phase_change_soisno(
        land, snl, dtime, dhsdT, frac_h2osfc, frac_sno_eff, fact, watsat,
        sucsat, bsw, dz, pc1.h2osno, pc1.snow_depth, ice_a, h2osoi_liq,
        t_a)
    t_grnd = update_t_grnd(snl, frac_h2osfc, frac_sno_eff, pc1.t_h2osfc,
                           pc2.t_soisno)
    return SoilTemperatureOut(
        sabg_chk=sabg_chk, dhsdT=dhsdT, fact=fact, t_soisno=pc2.t_soisno,
        h2osoi_ice=pc2.h2osoi_ice, h2osoi_liq=pc2.h2osoi_liq,
        t_h2osfc=pc1.t_h2osfc, t_grnd=t_grnd, h2osfc=pc1.h2osfc,
        int_snow=pc1.int_snow, h2osno=pc2.h2osno,
        snow_depth=pc2.snow_depth, xmf_h2osfc=pc1.xmf_h2osfc,
        qflx_h2osfc_to_ice=pc1.qflx_h2osfc_to_ice,
        eflx_h2osfc_to_snow=pc1.eflx_h2osfc_to_snow, xmf=pc2.xmf,
        qflx_snomelt=pc2.qflx_snomelt, qflx_snow_melt=pc2.qflx_snow_melt,
        imelt=pc2.imelt, qflx_snofrz_lyr=pc2.qflx_snofrz_lyr)
