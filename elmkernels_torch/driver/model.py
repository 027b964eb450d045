"""Host-side model API: setup, the step, and the time loop.

Counterpart of ``elmkernels_tpu/driver/model.py`` (``Model.__init__`` for
a homogeneous domain, ``advance`` and ``run``).  The model runs on the
first CUDA device unless the caller passes ``device="cpu"``; with no card
and no explicit ``"cpu"`` it raises rather than falling back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from elmkernels_torch import constants as c
from elmkernels_torch.data import forcing as forcing_mod
from elmkernels_torch.data import params as params_mod
from elmkernels_torch.data.state import (ModelState, StepForcing,
                                         StepPhenology, cold_start)
from elmkernels_torch.driver import step as step_mod
from elmkernels_torch.physics.photosynthesis import psn_mode_of
from elmkernels_torch.utils.dates import Date


def resolve_device(device) -> torch.device:
    """``None`` means the first CUDA device, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "elmkernels_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@dataclasses.dataclass
class Model:
    """A homogeneous batch of independent land columns and the step.

    ``pft_path`` is a clm_params NetCDF and ``snicar_path`` a
    snicar_optics_5bnd NetCDF (``elmkernels_torch.data.synthetic`` writes
    synthetic ones).  The flags default to the JAX ``Model``'s production
    defaults."""
    ncol: int
    dtime: float = 1800.0
    vtype: int = 12
    pft_path: str | None = None
    snicar_path: str | None = None
    lat_deg: float = 71.323
    lon_deg: float = 203.3886
    ltype: int = 1
    soil_color: int = 15
    mxsoil_color: int = 20
    pct_sand: float = 40.0
    pct_clay: float = 20.0
    organic: float = 10.0
    topo_slope_raw: float = 0.070044865858546
    topo_std: float = 3.96141847422387
    mixed_radiation: bool = True
    elm_correct_seb: bool = False
    warm_start: bool = True
    mixed_canopy: bool = True
    device: object = None
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.pft_path is None or self.snicar_path is None:
            raise ValueError("Model needs pft_path and snicar_path "
                             "(elmkernels_torch.data.synthetic writes "
                             "synthetic ones)")
        dev, dt = self.device, self.dtype
        self.land = c.LandType(ltype=int(self.ltype), ctype=1,
                               vtype=int(self.vtype))
        self.psnveg = params_mod.load_pft_psn(self.pft_path, self.vtype,
                                              dt, dev)
        self.albveg = params_mod.load_pft_alb(self.pft_path, self.vtype,
                                              dt, dev)
        self.psn_mode = psn_mode_of(self.psnveg)
        self.snicar = params_mod.read_snicar_data(self.snicar_path, dt, dev)
        self.params = params_mod.default_params(
            self.ncol, self.pft_path, self.vtype, self.lat_deg, self.lon_deg,
            soil_color=self.soil_color, pct_sand=self.pct_sand,
            pct_clay=self.pct_clay, organic=self.organic,
            mxsoil_color=self.mxsoil_color, ltype=self.ltype,
            topo_slope_raw=self.topo_slope_raw, topo_std=self.topo_std,
            dtype=dt, device=dev)
        self.state = cold_start(self.ncol, dt, dev)
        if self.land.ltype not in (c.ISTSOIL, c.ISTCROP):
            self.state = self._ltype_cold_start(self.state)
        self.forcing = forcing_mod.SyntheticForcing(
            self.ncol, self.params.lat_r.cpu().numpy(),
            self.params.lon_r.cpu().numpy())
        self.phenology = forcing_mod.SyntheticPhenology(self.ncol)

    def _ltype_cold_start(self, state: ModelState) -> ModelState:
        """Ice/wet landunits start from the reference's init kernels
        (``init_soil_temp``/``init_soilh2o_state``) instead of the
        hardwired soil column."""
        from elmkernels_torch.physics import init_state as ini
        t, t_grnd = ini.init_soil_temp(self.land, state.snl, self.ncol,
                                       self.dtype)
        vol, liq, ice = ini.init_soilh2o_state(self.land, state.snl,
                                               self.params.watsat, t,
                                               state.dz)
        return state._replace(t_soisno=t, t_grnd=t_grnd, h2osoi_vol=vol,
                              h2osoi_liq=liq, h2osoi_ice=ice)

    def _to_device(self, nt):
        """A host-side StepForcing/StepPhenology as device tensors."""
        return type(nt)(*(torch.as_tensor(np.asarray(v, np.float64),
                                          dtype=self.dtype,
                                          device=self.device) for v in nt))

    def step_inputs(self, date: Date) -> tuple[StepForcing, StepPhenology]:
        """The forcing and phenology of the step starting at ``date``, on
        the device."""
        return (self._to_device(self.forcing.window(date, self.dtime)),
                self._to_device(self.phenology.window(date)))

    def advance(self, date: Date) -> step_mod.StepDiagnostics:
        """One dt starting at ``date``; replaces self.state."""
        forc, phen = self.step_inputs(date)
        self.state, diags = step_mod.advance(
            self.land, self.psnveg, self.albveg, self.snicar, self.params,
            self.state, forc, phen, self.dtime, psn_mode=self.psn_mode,
            mixed_radiation=self.mixed_radiation,
            elm_correct_seb=self.elm_correct_seb,
            warm_start=self.warm_start, mixed_canopy=self.mixed_canopy)
        return diags

    def run(self, start: Date, nsteps: int,
            callback: Callable | None = None):
        """Tick the time loop (reference: ``kokkos_driver.cc:50-85``)."""
        date = start.copy()
        last = None
        for _ in range(nsteps):
            last = self.advance(date)
            if callback is not None:
                callback(date, self.state, last)
            date.increment_seconds(int(self.dtime))
        return last
