"""Physical constants, problem dimensions, and static model configuration.

The PyTorch port keeps its own copy of ``elmkernels_tpu/constants.py``
(it imports nothing of the JAX package).  Values are plain Python
floats/ints; the port's physics applies them to tensors of the caller's
dtype.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Physical constants (reference: elm_constants.h ELMconst, lines 18-52)
# ---------------------------------------------------------------------------

TFRZ = 273.15                    # freezing temperature [K]
ELM_PI = 3.14159265358979323846  # pi
BOLTZ = 1.38065e-23              # Boltzmann's constant [J/K/molecule]
AVOGAD = 6.02214e26              # Avogadro's number [molecules/kmole]
MWWV = 18.016                    # molecular weight water vapor
RGAS = AVOGAD * BOLTZ            # universal gas constant [J/K/kmole]
RWV = RGAS / MWWV                # water vapor gas constant [J/K/kg]
STEBOL = 5.67e-8                 # Stefan-Boltzmann constant [W/m^2/K^4]
MWDAIR = 28.966                  # molecular weight dry air [kg/kmole]
RAIR = RGAS / MWDAIR             # dry air gas constant [J/K/kg]
GRAV = 9.80616                   # gravity [m/s^2]
ROVERG = RWV / GRAV * 1000.0     # Rw/g [mm/K]
O2_MOLAR_CONST = 0.209           # atmospheric O2 molar ratio [mol/mol]
CO2_PPMV = 355.0                 # atmospheric CO2 molar ratio [umol/mol]
DENICE = 0.917e3                 # density of ice [kg/m^3]
DENH2O = 1.000e3                 # density of fresh water [kg/m^3]
HVAP = 2.501e6                   # latent heat of evaporation [J/kg]
HFUS = 3.337e5                   # latent heat of fusion [J/kg]
HSUB = HVAP + HFUS               # latent heat of sublimation [J/kg]
VKC = 0.4                        # von Karman constant [-]
CPAIR = 1.00464e3                # specific heat of dry air [J/kg/K]
CPICE = 2.11727e3                # specific heat of fresh ice [J/kg/K]
CPWAT = 4.188e3                  # specific heat of fresh water [J/kg/K]
CSOILC = 0.004                   # drag coefficient for soil under canopy [-]
ZLND = 0.01                      # roughness length for soil [m]
ZSNO = 0.0024                    # roughness length for snow [m]
SNW_RDS_MIN = 54.526             # minimum snow effective radius [microns]
SNW_RDS_MAX = 1500.0             # maximum snow effective radius [microns]
H2OSNO_MAX = 1000.0              # max snow thickness [mm H2O]
BDSNO = 250.0                    # bulk density of snow [kg/m^3]
SECSPDAY = 86400.0               # seconds per day
SPVAL = 1.0e36                   # special value for real data
ISPVAL = -9999                   # special value for int data

# ---------------------------------------------------------------------------
# Problem dimensions (reference: elm_constants.h ELMdims, lines 84-98)
# ---------------------------------------------------------------------------

NLEVSNO = 5      # max number of snow layers
NLEVGRND = 15    # number of total subsurface layers
NLEVURB = 5      # number of urban layers
NUMRAD = 2       # solar radiation bands: vis, nir
NLEVCAN = 1      # leaf layers in canopy
NLEVSOI = 10     # hydrologically active soil layers
NLEVBED = 15     # layers to bedrock
MXPFT = 25       # max number of PFTs in any mode
NUMVEG = 17      # veg types without specific crops
SNO_NBR_AER = 8  # aerosol species in snowpack
NUMRAD_SNW = 5   # spectral bands in the snow (SNICAR) model
NBAND = 5        # bands of the penta-diagonal soil-temperature matrix

# combined snow+soil column length; combined arrays are indexed top-down with
# snow layers [0, NLEVSNO) and soil layers [NLEVSNO, NLEVSNO+NLEVGRND)
# (reference: INDEX_MAP_README.txt)
NLEVTOT = NLEVSNO + NLEVGRND

# ---------------------------------------------------------------------------
# Static model configuration (reference: elm_constants.h ELMconfig, 10-15)
# ---------------------------------------------------------------------------

SUBGRIDFLAG = 1
USE_CROP = 0
PERCHROOT = 0
PERCHROOT_ALT = 0

NUMPFT = MXPFT if USE_CROP else NUMVEG

# ---------------------------------------------------------------------------
# PFT indices (reference: elm_constants.h PFT namespace, lines 55-81)
# ---------------------------------------------------------------------------

NOVEG = 0
NDLLF_EVR_TMP_TREE = 1
NDLLF_EVR_BRL_TREE = 2
NDLLF_DCD_BRL_TREE = 3
NBRDLF_EVR_TRP_TREE = 4
NBRDLF_EVR_TMP_TREE = 5
NBRDLF_DCD_TRP_TREE = 6
NBRDLF_DCD_TMP_TREE = 7
NBRDLF_DCD_BRL_TREE = 8
NBRDLF_EVR_SHRUB = 9
NBRDLF_DCD_TMP_SHRUB = 10
NBRDLF_DCD_BRL_SHRUB = 11
NC3_ARCTIC_GRASS = 12
NC3_NONARCTIC_GRASS = 13
NC4_GRASS = 14
NC3CROP = 15
NC3IRRIG = 16
NCORN = 17
NCORNIRRIG = 18
NSCEREAL = 19
NSCEREALIRRIG = 20
NWCEREAL = 21
NWCEREALIRRIG = 22
NSOYBEAN = 23
NSOYBEANIRRIG = 24

# ---------------------------------------------------------------------------
# Land unit / column types (reference: land_data.h LND namespace)
# ---------------------------------------------------------------------------

ISTSOIL = 1
ISTCROP = 2
ISTICE = 3
ISTICE_MEC = 4
ISTDLAK = 5
ISTWET = 6
ISTURB_MIN = 7
ISTURB_TBD = 7
ISTURB_HD = 8
ISTURB_MD = 9
ISTURB_MAX = 9
ICOL_ROOF = ISTURB_MIN * 10 + 1
ICOL_SUNWALL = ISTURB_MIN * 10 + 2
ICOL_SHADEWALL = ISTURB_MIN * 10 + 3
ICOL_ROAD_IMPERV = ISTURB_MIN * 10 + 4
ICOL_ROAD_PERV = ISTURB_MIN * 10 + 5


@dataclasses.dataclass(frozen=True)
class LandType:
    """Land classification for a batch of columns.

    The reference keeps one ``LandType`` per domain (``land_data.h:32-44``).
    ``ltype`` may be a plain int, so that every landunit-type branch of the
    physics is a Python ``if`` that launches nothing for the untaken
    branch, or an [ncol] integer tensor: every branch goes through
    :func:`ltype_mask`/:func:`lsel`, which then select per column with
    ``torch.where`` and never test a tensor on the host.  ``ctype``,
    ``urbpoi`` and ``lakpoi`` stay one per domain (urban and lake columns
    are placeholder classes in the reference as well).
    """

    ltype: int = 1   # land unit type (ISTSOIL); int or [ncol] tensor
    ctype: int = 1   # column type
    vtype: int = 12  # vegetation (PFT) type
    urbpoi: bool = False
    lakpoi: bool = False

    @property
    def is_soil_or_crop(self):
        return ltype_mask(self, ISTSOIL, ISTCROP)

    @property
    def is_wall(self) -> bool:
        return self.ctype in (ICOL_SUNWALL, ICOL_SHADEWALL)


def ltype_mask(land: LandType, *types):
    """True where ``land.ltype`` is one of ``types``: a Python bool for an
    int ltype (the callers' ``if`` tests fold as before), an [ncol] bool
    tensor for a per-column one.  Pair with :func:`lsel`."""
    lt = land.ltype
    if isinstance(lt, int):
        return lt in types
    m = lt == types[0]
    for t in types[1:]:
        m = m | (lt == t)
    return m


def lsel(mask, a, b):
    """``a`` where ``mask`` else ``b``.

    A Python bool picks one side and launches nothing; an [ncol] mask
    selects per column with ``torch.where``, broadcast over the trailing
    layer/band axes.  ``a``/``b`` may be NamedTuples or tuples of matching
    structure, and either leaf may be a Python number."""
    if isinstance(mask, bool):
        return a if mask else b
    import torch

    def sel(x, y):
        if isinstance(x, tuple):
            vals = [sel(u, v) for u, v in zip(x, y)]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        nd = max(getattr(x, "ndim", 0), getattr(y, "ndim", 0))
        m = mask.reshape(mask.shape + (1,) * (nd - mask.ndim))
        return torch.where(m, x, y)
    return sel(a, b)


def lor(a, b):
    """Logical or of a per-column-or-static mask with a static bool."""
    if isinstance(a, bool) and isinstance(b, bool):
        return a or b
    if a is True or b is True:
        return True
    return a if b is False else (b if a is False else a | b)
