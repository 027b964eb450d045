"""Surface/canopy albedo: soil albedo, ground albedo, SNICAR flux-factor
weighting, canopy layers, and the two-stream canopy radiative transfer —
batched over columns.

Counterpart of ``elmkernels_tpu/physics/surface_albedo.py`` (reference
``src/physics/surface_albedo_impl.hh:35-756``).  ``nlevcan == 1`` (sun/shade
big leaf) only; the vegetated/bare/night branches are batch masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.physics.math_utils import const, rdiv, safe_div

_MPE = 1.e-6   # detail::mpe (surface_albedo.h)
_EXTKN = 0.3   # detail::extkn — nitrogen allocation extinction coefficient


class PFTAlbParams(NamedTuple):
    """Leaf/stem optical properties (reference ``PFTDataAlb``): rhol/rhos/
    taul/taus per band + leaf angle xl.  A homogeneous domain holds tuples
    of 0-d tensors and a 0-d xl; a per-column one [ncol, numrad] tensors
    and an [ncol] xl."""
    rhol: tuple | torch.Tensor
    rhos: tuple | torch.Tensor
    taul: tuple | torch.Tensor
    taus: tuple | torch.Tensor
    xl: torch.Tensor


def _band(v, ib: int):
    """Band ``ib`` of an optics trait: a tuple's entry, or column ``ib`` of
    an [ncol, numrad] tensor."""
    return v[ib] if isinstance(v, (tuple, list)) else v[:, ib]


class InitTimestepOut(NamedTuple):
    vcmaxcintsun: torch.Tensor
    vcmaxcintsha: torch.Tensor
    mss_cnc_aer_in_fdb: torch.Tensor  # [ncol, NLEVSNO, SNO_NBR_AER]


def init_timestep(land: c.LandType, elai, mss_cnc_bcphi, mss_cnc_bcpho,
                  mss_cnc_dst1, mss_cnc_dst2, mss_cnc_dst3,
                  mss_cnc_dst4) -> InitTimestepOut:
    """Leaf-to-canopy scaling init + aerosol feedback concentrations
    (``surface_albedo_impl.hh:88-151``)."""
    vcmaxcintsun = torch.zeros_like(elai)
    vcs = (1.0 - torch.exp(-_EXTKN * elai)) / _EXTKN
    vcmaxcintsha = torch.where(elai > 0.0, safe_div(vcs, elai, elai > 0.0),
                               0.0)
    # [ncol, nlevsno, 8]: bcphi, bcpho, (OC1, OC2 ignored), dst1..dst4
    zeros = torch.zeros_like(mss_cnc_bcphi)
    mss = torch.stack([mss_cnc_bcphi, mss_cnc_bcpho, zeros, zeros,
                       mss_cnc_dst1, mss_cnc_dst2, mss_cnc_dst3,
                       mss_cnc_dst4], dim=-1)
    return InitTimestepOut(vcmaxcintsun, vcmaxcintsha, mss)


class SoilAlbedoOut(NamedTuple):
    albsod: torch.Tensor  # [ncol, numrad]
    albsoi: torch.Tensor


def soil_albedo(land: c.LandType, snl, t_grnd, coszen, h2osoi_vol, albsat,
                albdry) -> SoilAlbedoOut:
    """Direct/diffuse soil (or ice/lake) albedo by band
    (``surface_albedo_impl.hh:689-754``)."""
    def k(v):
        return const(v, albsat).expand_as(albsat)
    albice = k((0.8, 0.55))
    alblak = k((0.60, 0.40))
    alblakwi = k((0.10, 0.10))
    calb = 95.6

    lit = (coszen > 0.0)[:, None]
    sc = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
    icem = c.ltype_mask(land, c.ISTICE, c.ISTICE_MEC)
    lakem = c.ltype_mask(land, c.ISTDLAK)

    def soil():
        inc = torch.clamp(0.11 - 0.40 * h2osoi_vol[:, 0], min=0.0)
        return torch.minimum(albsat + inc[:, None], albdry)

    def lake():
        sicefr = 1.0 - torch.exp(-calb * (c.TFRZ - t_grnd) / c.TFRZ)
        sod = (sicefr[:, None] * alblak
               + (1.0 - sicefr)[:, None]
               * torch.maximum(alblakwi,
                               rdiv(0.05, torch.clamp(coszen, min=0.001)[:, None]
                                    + 0.15)))
        soi = (sicefr[:, None] * alblak
               + (1.0 - sicefr)[:, None] * torch.clamp(alblakwi, min=0.10))
        frozen = (snl == 0)[:, None]
        albsod = torch.where(frozen, sod, alblak)
        return albsod, torch.where(frozen, soi, albsod)

    if sc is True:
        albsod = soil()
        albsoi = albsod
    elif icem is True:
        albsod = albice
        albsoi = albsod
    elif lakem is True:
        albsod, albsoi = lake()
    elif sc is False and icem is False and lakem is False:  # wetland
        albsod = alblak
        albsoi = albsod
    else:  # per-column ltype: select among the four surfaces
        sod_sc = soil()
        sod_lake, soi_lake = lake()
        albsod = c.lsel(sc, sod_sc,
                        c.lsel(icem, albice, c.lsel(lakem, sod_lake, alblak)))
        albsoi = c.lsel(sc, sod_sc,
                        c.lsel(icem, albice, c.lsel(lakem, soi_lake, alblak)))
    return SoilAlbedoOut(torch.where(lit, albsod, 0.0),
                         torch.where(lit, albsoi, 0.0))


class GroundAlbedoOut(NamedTuple):
    albgrd: torch.Tensor
    albgri: torch.Tensor


def ground_albedo(land: c.LandType, coszen, frac_sno, albsod, albsoi, albsnd,
                  albsni) -> GroundAlbedoOut:
    """Snow-fraction-weighted ground albedo
    (``surface_albedo_impl.hh:153-167``)."""
    lit = (coszen > 0.0)[:, None]
    fs = frac_sno[:, None]
    albgrd = torch.where(lit, albsod * (1.0 - fs) + albsnd * fs, 0.0)
    albgri = torch.where(lit, albsoi * (1.0 - fs) + albsni * fs, 0.0)
    return GroundAlbedoOut(albgrd, albgri)


class FluxAbsorptionOut(NamedTuple):
    flx_absdv: torch.Tensor  # [ncol, NLEVSNO+1]
    flx_absdn: torch.Tensor
    flx_absiv: torch.Tensor
    flx_absin: torch.Tensor


def flux_absorption_factor(land: c.LandType, coszen, frac_sno, albsod,
                           albsoi, albsnd, albsni, flx_absd_snw,
                           flx_absi_snw) -> FluxAbsorptionOut:
    """Snow-fraction weighting of per-layer SNICAR absorption factors
    (``surface_albedo_impl.hh:169-211``); flx_abs[di]_snw are
    [ncol, NLEVSNO+1, numrad]."""
    lit = (coszen > 0.0)[:, None]
    lakem = True if c.SUBGRIDFLAG == 0 else c.ltype_mask(land, c.ISTDLAK)
    if lakem is not False:
        fs = frac_sno[:, None]

        def wgt(flx, albsfc, albsnow):
            return (flx * fs + (1.0 - fs) * (1.0 - albsfc)
                    * safe_div(flx, 1.0 - albsnow, albsnow != 1.0))
        lake = (wgt(flx_absd_snw[:, :, 0], albsod[:, 0:1], albsnd[:, 0:1]),
                wgt(flx_absd_snw[:, :, 1], albsod[:, 1:2], albsnd[:, 1:2]),
                wgt(flx_absi_snw[:, :, 0], albsoi[:, 0:1], albsni[:, 0:1]),
                wgt(flx_absi_snw[:, :, 1], albsoi[:, 1:2], albsni[:, 1:2]))
    if lakem is not True:
        other = (flx_absd_snw[:, :, 0] * (1.0 - albsnd[:, 0:1]),
                 flx_absd_snw[:, :, 1] * (1.0 - albsnd[:, 1:2]),
                 flx_absi_snw[:, :, 0] * (1.0 - albsni[:, 0:1]),
                 flx_absi_snw[:, :, 1] * (1.0 - albsni[:, 1:2]))
    dv, dn, iv, inn = (lake if lakem is True else other if lakem is False
                       else c.lsel(lakem, lake, other))
    return FluxAbsorptionOut(torch.where(lit, dv, 0.0),
                             torch.where(lit, dn, 0.0),
                             torch.where(lit, iv, 0.0),
                             torch.where(lit, inn, 0.0))


class CanopyLayerOut(NamedTuple):
    nrad: torch.Tensor
    tlai_z: torch.Tensor  # [ncol, nlevcan]
    tsai_z: torch.Tensor
    fsun_z: torch.Tensor
    fabd_sun_z: torch.Tensor
    fabd_sha_z: torch.Tensor
    fabi_sun_z: torch.Tensor
    fabi_sha_z: torch.Tensor


def canopy_layer_lai(land: c.LandType, elai, esai, tlai,
                     tsai) -> CanopyLayerOut:
    """Canopy layer LAI/SAI assignment, sun/shade big leaf (nlevcan == 1):
    one layer holding the full canopy (``surface_albedo_impl.hh:213-319``).
    """
    nrad = torch.ones_like(elai, dtype=torch.long)
    tlai_z = elai[:, None]
    tsai_z = esai[:, None]
    z = torch.zeros_like(tlai_z)
    return CanopyLayerOut(nrad, tlai_z, tsai_z, z, z, z, z, z)


class TwoStreamOut(NamedTuple):
    albd: torch.Tensor      # [ncol, numrad]
    ftid: torch.Tensor
    ftdd: torch.Tensor
    fabd: torch.Tensor
    fabd_sun: torch.Tensor
    fabd_sha: torch.Tensor
    albi: torch.Tensor
    ftii: torch.Tensor
    fabi: torch.Tensor
    fabi_sun: torch.Tensor
    fabi_sha: torch.Tensor
    fsun_z: torch.Tensor    # [ncol, nlevcan]
    fabd_sun_z: torch.Tensor
    fabd_sha_z: torch.Tensor
    fabi_sun_z: torch.Tensor
    fabi_sha_z: torch.Tensor
    vcmaxcintsun: torch.Tensor
    vcmaxcintsha: torch.Tensor


def two_stream_solver(land: c.LandType, nrad, coszen, t_veg, fwet, elai,
                      esai, tlai_z, tsai_z, albgrd, albgri,
                      alb_pft: PFTAlbParams, vcmaxcintsun,
                      vcmaxcintsha) -> TwoStreamOut:
    """Dickinson/Sellers two-stream canopy radiative transfer, direct +
    diffuse, per band, with sun/shade partitioning and leaf-to-canopy
    scaling coefficients (``surface_albedo_impl.hh:321-687``)."""
    omegas = (0.8, 0.4)
    betads = 0.5
    betais = 0.5

    sc = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
    if land.urbpoi or sc is False:
        veg = torch.zeros_like(coszen, dtype=torch.bool)
    elif sc is True:
        veg = (coszen > 0.0) & ((elai + esai) > 0.0)
    else:
        veg = sc & (coszen > 0.0) & ((elai + esai) > 0.0)
    noveg = (coszen > 0.0) & ~veg

    wl = elai / torch.clamp(elai + esai, min=_MPE)
    ws = esai / torch.clamp(elai + esai, min=_MPE)

    cosz = torch.clamp(coszen, min=0.001)
    chil = torch.clamp(alb_pft.xl, -0.4, 0.6)
    chil = torch.where(torch.abs(chil) <= 0.01, 0.01, chil)

    phi1 = 0.5 - 0.633 * chil - 0.330 * chil * chil
    phi2 = 0.877 * (1.0 - 2.0 * phi1)
    gdir = phi1 + phi2 * cosz
    twostext = gdir / cosz
    avmu = (1.0 - phi1 / phi2 * torch.log((phi1 + phi2) / phi1)) / phi2
    temp0 = gdir + phi2 * cosz
    temp1 = phi1 * cosz
    temp2 = 1.0 - temp1 / temp0 * torch.log((temp1 + temp0) / temp1)

    names = ("albd", "ftid", "ftdd", "fabd", "fabd_sun", "fabd_sha", "albi",
             "ftii", "fabi", "fabi_sun", "fabi_sha")
    outs = {k: [] for k in names}
    per_layer = {}

    for ib in range(c.NUMRAD):
        rho = torch.clamp(_band(alb_pft.rhol, ib) * wl
                          + _band(alb_pft.rhos, ib) * ws, min=_MPE)
        tau = torch.clamp(_band(alb_pft.taul, ib) * wl
                          + _band(alb_pft.taus, ib) * ws, min=_MPE)

        omegal = rho + tau
        asu = 0.5 * omegal * gdir / temp0 * temp2
        betadl = (1.0 + avmu * twostext) / (omegal * avmu * twostext) * asu
        betail = (0.5 * ((rho + tau) + (rho - tau)
                         * ((1.0 + chil) / 2.0) ** 2.0) / omegal)

        snowy = t_veg <= c.TFRZ
        om_s = (1.0 - fwet) * omegal + fwet * omegas[ib]
        omega = torch.where(snowy, om_s, omegal)
        betad = torch.where(
            snowy, ((1.0 - fwet) * omegal * betadl
                    + fwet * omegas[ib] * betads) / om_s, betadl)
        betai = torch.where(
            snowy, ((1.0 - fwet) * omegal * betail
                    + fwet * omegas[ib] * betais) / om_s, betail)

        b = 1.0 - omega + omega * betai
        c1 = omega * betai
        tmp0 = avmu * twostext
        d = tmp0 * omega * betad
        f = tmp0 * omega * (1.0 - betad)
        tmp1b = b * b - c1 * c1
        h = torch.sqrt(torch.clamp(tmp1b, min=0.0)) / avmu
        sigma = tmp0 * tmp0 - tmp1b
        p1 = b + avmu * h
        p2 = b - avmu * h
        p3 = b + tmp0
        p4 = b - tmp0

        t1 = torch.clamp(h * (elai + esai), max=40.0)
        s1 = torch.exp(-t1)
        t1d = torch.clamp(twostext * (elai + esai), max=40.0)
        s2 = torch.exp(-t1d)

        agrd = albgrd[:, ib]
        agri = albgri[:, ib]

        # ---- direct beam ----
        u1 = b - safe_div(c1, agrd, agrd != 0.0)
        u2 = b - c1 * agrd
        u3 = f + c1 * agrd
        tmp2b = u1 - avmu * h
        tmp3 = u1 + avmu * h
        d1 = p1 * tmp2b / s1 - p2 * tmp3 * s1
        tmp4 = u2 + avmu * h
        tmp5 = u2 - avmu * h
        d2 = tmp4 / s1 - tmp5 * s1
        h1 = -d * p4 - c1 * f
        sigma_s = torch.where(sigma != 0.0, sigma, 1.0)
        tmp6 = d - h1 * p3 / sigma_s
        tmp7 = (d - c1 - h1 / sigma_s * (u1 + tmp0)) * s2
        h2 = (tmp6 * tmp2b / s1 - p2 * tmp7) / d1
        h3 = -(tmp6 * tmp3 * s1 - p1 * tmp7) / d1
        h4 = -f * p3 - c1 * d
        tmp8 = h4 / sigma_s
        tmp9 = (u3 - tmp8 * (u2 - tmp0)) * s2
        h5 = -(tmp8 * tmp4 / s1 + tmp9) / d2
        h6 = (tmp8 * tmp5 * s1 + tmp9) / d2

        albd = h1 / sigma_s + h2 + h3
        ftid = h4 * s2 / sigma_s + h5 * s1 + h6 / s1
        ftdd = s2
        fabd = 1.0 - albd - (1.0 - agrd) * ftdd - (1.0 - agri) * ftid

        a1 = (h1 / sigma_s * (1.0 - s2 * s2) / (2.0 * twostext)
              + h2 * (1.0 - s2 * s1) / (twostext + h)
              + h3 * (1.0 - s2 / s1) / (twostext - h))
        a2 = (h4 / sigma_s * (1.0 - s2 * s2) / (2.0 * twostext)
              + h5 * (1.0 - s2 * s1) / (twostext + h)
              + h6 * (1.0 - s2 / s1) / (twostext - h))

        fabd_sun = (1.0 - omega) * (1.0 - s2 + 1.0 / avmu * (a1 + a2))
        fabd_sha = fabd - fabd_sun

        # ---- diffuse ----
        u1i = b - safe_div(c1, agri, agri != 0.0)
        u2i = b - c1 * agri
        tmp2i = u1i - avmu * h
        tmp3i = u1i + avmu * h
        d1i = p1 * tmp2i / s1 - p2 * tmp3i * s1
        tmp4i = u2i + avmu * h
        tmp5i = u2i - avmu * h
        d2i = tmp4i / s1 - tmp5i * s1
        h7 = (c1 * tmp2i) / (d1i * s1)
        h8 = (-c1 * tmp3i * s1) / d1i
        h9 = tmp4i / (d2i * s1)
        h10 = (-tmp5i * s1) / d2i

        albi = h7 + h8
        ftii = h9 * s1 + h10 / s1
        fabi = 1.0 - albi - (1.0 - agri) * ftii

        a1i = (h7 * (1.0 - s2 * s1) / (twostext + h)
               + h8 * (1.0 - s2 / s1) / (twostext - h))
        a2i = (h9 * (1.0 - s2 * s1) / (twostext + h)
               + h10 * (1.0 - s2 / s1) / (twostext - h))

        fabi_sun = (1.0 - omega) / avmu * (a1i + a2i)
        fabi_sha = fabi - fabi_sun

        if ib == 0:
            # sunlit fraction and per-layer absorbed PAR (nlevcan == 1)
            fsun = (1.0 - s2) / t1d
            laisum = elai + esai
            extkb = twostext
            vsun = (1.0 - torch.exp(-(_EXTKN + extkb) * elai)) \
                / (_EXTKN + extkb)
            vsha = (1.0 - torch.exp(-_EXTKN * elai)) / _EXTKN - vsun
            haslai = elai > 0.0
            per_layer = dict(
                fsun=fsun,
                fabd_sun_z=fabd_sun / (fsun * laisum),
                fabi_sun_z=fabi_sun / (fsun * laisum),
                fabd_sha_z=fabd_sha / ((1.0 - fsun) * laisum),
                fabi_sha_z=fabi_sha / ((1.0 - fsun) * laisum),
                vsun=torch.where(haslai,
                                 safe_div(vsun, fsun * elai, haslai), 0.0),
                vsha=torch.where(haslai,
                                 safe_div(vsha, (1.0 - fsun) * elai, haslai),
                                 0.0))

        # select vegetated / bare / dark per band
        one, zero = torch.ones_like(albd), torch.zeros_like(albd)
        for name, vveg, vnoveg, vdark in (
                ("albd", albd, agrd, one), ("ftid", ftid, zero, zero),
                ("ftdd", ftdd, one, zero), ("fabd", fabd, zero, zero),
                ("fabd_sun", fabd_sun, zero, zero),
                ("fabd_sha", fabd_sha, zero, zero),
                ("albi", albi, agri, one), ("ftii", ftii, one, zero),
                ("fabi", fabi, zero, zero),
                ("fabi_sun", fabi_sun, zero, zero),
                ("fabi_sha", fabi_sha, zero, zero)):
            outs[name].append(torch.where(veg, vveg,
                                          torch.where(noveg, vnoveg, vdark)))

    stacked = {k: torch.stack(v, dim=-1) for k, v in outs.items()}

    # per-layer arrays only updated in the vegetated case
    vg = veg[:, None]

    def lay(k):
        return torch.where(vg, per_layer[k][:, None], 0.0)
    return TwoStreamOut(
        stacked["albd"], stacked["ftid"], stacked["ftdd"], stacked["fabd"],
        stacked["fabd_sun"], stacked["fabd_sha"], stacked["albi"],
        stacked["ftii"], stacked["fabi"], stacked["fabi_sun"],
        stacked["fabi_sha"], lay("fsun"), lay("fabd_sun_z"),
        lay("fabd_sha_z"), lay("fabi_sun_z"), lay("fabi_sha_z"),
        torch.where(veg, per_layer["vsun"], vcmaxcintsun),
        torch.where(veg, per_layer["vsha"], vcmaxcintsha))
