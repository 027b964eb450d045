"""The plain reference: the frozen step (:mod:`portbench.reference.elm`)
over a chosen set of a configuration's columns.

It builds what ``elmkernels_torch.driver.model.Model`` derives from the
parameter files and the surfdata (the parameters, the trait tables, the
cold start), for the columns ``cols`` only, takes each step's forcing,
phenology and deposition from the providers the configuration's input
kinds give it (``portbench/sources/``; the synthetic forcing and
phenology where none is given), and advances a state one step at a time
from each step's host inputs, as ``Model.run`` and
``MinimalInterface.advance_with_forcing`` build them.  Columns are
independent, so the step over ``cols`` gives what the whole grid's step
gives in those columns.  Imports nothing of ``elmkernels_torch``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.elm import constants as c
from portbench.reference.elm.data import forcing as forcing_mod
from portbench.reference.elm.data import params as params_mod
from portbench.reference.elm.data.state import (AERO_DEP_KEYS, StepForcing,
                                                StepPhenology, cold_start)
from portbench.reference.elm.driver import step as step_mod
from portbench.reference.elm.physics.photosynthesis import psn_mode_of

# the flags of a configuration file that the step takes as they are
STEP_FLAGS = ("mixed_radiation", "elm_correct_seb", "warm_start",
              "mixed_canopy", "elm_correct_snow_aging")


def grid_fields(cfg: dict, files: dict) -> dict:
    """The per-column site fields of the configuration's whole grid, as
    ``Model``'s keywords: numpy arrays over every column for a surfdata
    grid, the configuration's scalars for a site."""
    if cfg["grid"] == "site":
        return dict(cfg["site"])
    from portbench.reference.elm.data.surfdata import read_surfdata
    sd = read_surfdata(files["surfdata"], cfg["ncol"])
    return dict(vtype=sd.vtype.astype(np.int64), lat_deg=sd.lat_deg,
                lon_deg=sd.lon_deg, soil_color=sd.soil_color,
                mxsoil_color=sd.mxsoil_color, pct_sand=sd.pct_sand,
                pct_clay=sd.pct_clay, organic=sd.organic,
                topo_slope_raw=sd.topo_slope, topo_std=sd.topo_std)


def _pick(v, cols):
    a = np.asarray(v)
    return a[cols] if a.ndim else v


class Columns:
    """The configuration ``cfg`` (a configuration file's object) over the
    columns ``cols`` of its grid, in ``dtype`` on ``device``.  ``grid`` is
    :func:`grid_fields`; ``files`` names the parameter and input files;
    ``providers`` ({role: provider}) gives the ``forcing`` (``window(date,
    dtime)`` over these columns, ``qbot_is_rh``), the ``phenology``
    (``window(date)``) and the ``aerosol`` deposition (``rates(date)``)
    that the configuration's input kinds read."""

    def __init__(self, cfg: dict, grid: dict, files: dict, cols,
                 dtype=torch.float64, device="cpu", providers=None):
        providers = providers or {}
        self.cols = np.asarray(cols, np.int64)
        self.ncol = n = len(self.cols)
        self.dtype, self.device = dtype, torch.device(device)
        self.dtime = float(cfg["dtime"])
        self.flags = {k: bool(cfg["flags"][k]) for k in STEP_FLAGS}
        pft = files["pft"]
        vt_all = np.asarray(grid["vtype"], np.int64)
        if vt_all.ndim == 0:
            self.psnveg = params_mod.load_pft_psn(pft, int(vt_all), dtype,
                                                  self.device)
            self.albveg = params_mod.load_pft_alb(pft, int(vt_all), dtype,
                                                  self.device)
            self.psn_mode = psn_mode_of(self.psnveg)
        else:
            table = params_mod.load_pft_table(pft)
            vt = vt_all[self.cols]
            self.psnveg = params_mod.gather_pft_psn(table, vt, dtype,
                                                    self.device)
            self.albveg = params_mod.gather_pft_alb(table, vt, dtype,
                                                    self.device)
            # the pathway is the whole grid's (C3 and C4 meet somewhere)
            self.psn_mode = psn_mode_of(
                params_mod.gather_pft_psn(table, vt_all, torch.float64))
        self.land = c.LandType(ltype=int(cfg.get("ltype", c.ISTSOIL)),
                               ctype=1, vtype=int(vt_all.flat[0]))
        self.snicar = params_mod.read_snicar_data(files["snicar"], dtype,
                                                  self.device)
        kw = {k: _pick(v, self.cols) for k, v in grid.items()}
        kw["vtype"] = _pick(vt_all, self.cols)
        self.params = params_mod.default_params(
            n, pft, kw.pop("vtype"), kw.pop("lat_deg"), kw.pop("lon_deg"),
            ltype=int(cfg.get("ltype", c.ISTSOIL)), dtype=dtype,
            device=self.device, **kw)
        lat_r = self.params.lat_r.cpu().numpy()
        lon_r = self.params.lon_r.cpu().numpy()
        self.forcing = (providers.get("forcing")
                        or forcing_mod.SyntheticForcing(n, lat_r, lon_r))
        self.phenology = (providers.get("phenology")
                          or forcing_mod.SyntheticPhenology(n))
        self.aerosol = providers.get("aerosol")

    def cold_start(self):
        """The configuration's cold-start state of these columns."""
        return cold_start(self.ncol, self.dtype, self.device)

    def _dev(self, nt):
        return type(nt)(*(None if v is None else
                          torch.as_tensor(np.asarray(v, np.float64),
                                          dtype=self.dtype,
                                          device=self.device) for v in nt))

    def _aero(self, forc: StepForcing, date) -> StepForcing:
        if self.aerosol is None:
            return forc
        rates = self.aerosol.rates(date)
        return forc._replace(aero=np.stack([rates[k]
                                            for k in AERO_DEP_KEYS]))

    def _advance(self, state, forc, phen, qbot_is_rh: bool):
        return step_mod.advance(
            self.land, self.psnveg, self.albveg, self.snicar, self.params,
            state, self._dev(forc), self._dev(phen), self.dtime,
            psn_mode=self.psn_mode, qbot_is_rh=qbot_is_rh,
            het_ltype=False, **self.flags)

    def step(self, state, date):
        """One step from ``date`` on the configuration's own forcing and
        phenology: ``(new state, diagnostics)``."""
        forc = self._aero(self.forcing.window(date, self.dtime), date)
        return self._advance(state, forc, self.phenology.window(date),
                             getattr(self.forcing, "qbot_is_rh", False))

    def step_host(self, state, date, atm: dict, phen: dict):
        """One step on a host model's forcing and phenology ([ncol] numpy
        arrays of these columns, keyed as ``HostForcing`` and
        ``HostPhenology``), entered as a degenerate bracket, with specific
        humidity."""
        def pair(x):
            a = np.asarray(x, np.float64)
            return np.stack([a, a])
        forc = StepForcing(
            wt1=1.0, wt2=0.0, tbot=pair(atm["atm_tbot"]),
            pbot=pair(atm["atm_pbot"]), qbot=pair(atm["atm_qbot"]),
            flds=pair(atm["atm_flds"]), wind=pair(atm["atm_wind"]),
            fsds=np.asarray(atm["atm_fsds"], np.float64),
            prec=np.asarray(atm["atm_prec"], np.float64),
            decday=date.decimal_doy() + 1.0)
        forc = self._aero(forc, date)
        ph = StepPhenology(wt1=1.0, wt2=0.0, mlai=pair(phen["lai"]),
                           msai=pair(phen["sai"]), mhtop=pair(phen["htop"]),
                           mhbot=pair(phen["hbot"]))
        return self._advance(state, forc, ph, False)
