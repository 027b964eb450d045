"""Synthetic parameter files: a ``clm_params``-style PFT trait NetCDF and a
SNICAR optics NetCDF, written from closed-form, physically plausible
values so that a model can be built without the reference's data files.

Imports numpy and scipy only.  Both the JAX package's ``Model`` and the
port's read these files through their own readers.

- :func:`write_clm_params` writes every trait of ``PFT_TABLE_NAMES``
  (``elmkernels_tpu/data/params.py:38-52``) over 25 PFTs plus the scalars
  ``tc_stress`` and ``organic_max``.  PFT 12 (C3 arctic grass, the
  reference driver's site) carries C3 grass values of the CLM5 parameter
  file's magnitude, so the canopy and ci loops converge as they do on
  real data; PFT 14 is a C4 grass.
- :func:`write_snicar_optics` writes the 5-band SNICAR schema that
  ``elmkernels_tpu/data/snicar_data.py:78`` reads: Mie tables
  ``[5, 1471]`` over snow radius 30..1500 um, BC/OC/dust tables and
  ``bcint_enh_mam [8, 10, 5]``.
"""

from __future__ import annotations

import numpy as np

from elmkernels_torch.data.netcdf import write_nc

NUMPFT = 25
NBND = 5
NMIE = 1471

# C3 grass traits (CLM5 magnitudes); every PFT starts from these
_C3_GRASS = dict(
    fnr=7.16, act25=3.6, kcha=79430.0, koha=36380.0, cpha=37830.0,
    vcmaxha=72000.0, jmaxha=50000.0, tpuha=72000.0, lmrha=46390.0,
    vcmaxhd=200000.0, jmaxhd=200000.0, tpuhd=200000.0, lmrhd=150650.0,
    lmrse=490.0, qe=0.0, theta_cj=0.98, bbbopt=10000.0, mbbopt=9.0,
    c3psn=1.0, slatop=0.04, leafcn=25.0, flnr=0.09, fnitr=0.83,
    dleaf=0.04, smpso=-74000.0, smpsc=-275000.0,
    rholvis=0.11, rholnir=0.35, rhosvis=0.31, rhosnir=0.53,
    taulvis=0.05, taulnir=0.34, tausvis=0.12, tausnir=0.25, xl=-0.3,
    roota_par=11.0, rootb_par=2.0, displar=0.67, z0mr=0.12,
    dsladlai=0.0, leaf_long=1.0, evergreen=0.0, stress_decid=1.0,
    season_decid=0.0)
# C4 grass (PFT 14) differs in pathway traits
_C4_GRASS = dict(_C3_GRASS, c3psn=0.0, qe=0.05, theta_cj=0.8,
                 bbbopt=40000.0, mbbopt=4.0, slatop=0.05)


def pft_table() -> dict:
    """The synthetic trait table: name -> [NUMPFT] float64."""
    table = {k: np.full(NUMPFT, v) for k, v in _C3_GRASS.items()}
    # trees and shrubs (1..11): taller roughness, deeper roots, leaf angle
    for pft in range(1, 12):
        table["z0mr"][pft] = 0.055
        table["roota_par"][pft] = 7.0
        table["xl"][pft] = 0.1
        table["slatop"][pft] = 0.012
        table["leafcn"][pft] = 40.0
    for k, v in _C4_GRASS.items():
        table[k][14] = v
    return table


def write_clm_params(path, tc_stress: float = -2.0,
                     organic_max: float = 130.0) -> None:
    """Write the synthetic ``clm_params`` NetCDF to ``path``."""
    table = pft_table()
    variables = {k: (("pft",), v) for k, v in table.items()}
    variables["tc_stress"] = (("allpfts",), np.array([tc_stress]))
    variables["organic_max"] = (("allpfts",), np.array([organic_max]))
    write_nc(path, {"pft": NUMPFT, "allpfts": 1}, variables)


def snicar_tables() -> dict:
    """The synthetic SNICAR optics, keyed by the reference's file
    variable names."""
    rds = 30.0 + np.arange(NMIE)               # effective radius [um]
    # ice co-albedo grows with radius, strongly in the near-IR bands
    coalb_per_um = np.array([2.0e-8, 2.0e-6, 1.0e-5, 4.0e-5, 2.5e-4])
    ss_alb = np.clip(1.0 - coalb_per_um[:, None] * rds[None, :], 0.5, None)
    asm = 0.88 + 0.01 * np.log(rds[None, :] / 30.0) \
        + 0.002 * np.arange(NBND)[:, None]
    ext = 3.0 / (2.0 * 917.0 * rds[None, :] * 1.0e-6) \
        * (1.0 + 0.01 * np.arange(NBND)[:, None])
    out = {}
    for kind, scale in (("drc", 1.0), ("dfs", 0.999)):
        out[f"ss_alb_ice_{kind}"] = np.clip(ss_alb * scale, 0.5, 1.0)
        out[f"asm_prm_ice_{kind}"] = asm
        out[f"ext_cff_mss_ice_{kind}"] = ext
    band = np.arange(NBND)
    aer = {"ocphil": (0.95, 0.7, 6000.0), "ocphob": (0.93, 0.68, 5000.0),
           "dust01": (0.95, 0.75, 2500.0), "dust02": (0.92, 0.78, 1300.0),
           "dust03": (0.88, 0.8, 650.0), "dust04": (0.84, 0.85, 250.0)}
    for name, (ssa, g, k) in aer.items():
        out[f"ss_alb_{name}"] = ssa - 0.02 * band
        out[f"asm_prm_{name}"] = g - 0.01 * band
        out[f"ext_cff_mss_{name}"] = k / (1.0 + 0.5 * band)
    nclrds = np.arange(10)[:, None]
    out["ss_alb_bc_mam"] = 0.25 + 0.01 * nclrds - 0.02 * band[None, :]
    out["asm_prm_bc_mam"] = 0.35 + 0.01 * nclrds - 0.03 * band[None, :]
    out["ext_cff_mss_bc_mam"] = (11000.0 - 300.0 * nclrds) \
        / (1.0 + 0.6 * band[None, :])
    out["bcint_enh_mam"] = (1.9 - 0.05 * np.arange(8)[:, None, None]
                            - 0.02 * np.arange(10)[None, :, None]
                            - 0.1 * band[None, None, :])
    return out


def write_snicar_optics(path) -> None:
    """Write the synthetic SNICAR optics NetCDF to ``path``."""
    def dims_of(arr):
        if arr.ndim == 1:
            return ("band",)
        if arr.ndim == 3:
            return ("icerds", "nclrds", "band")
        return ("band", "mie") if arr.shape[1] == NMIE else ("nclrds",
                                                             "band")
    write_nc(path, {"band": NBND, "mie": NMIE, "nclrds": 10, "icerds": 8},
             {name: (dims_of(arr), np.asarray(arr, np.float64))
              for name, arr in snicar_tables().items()})
