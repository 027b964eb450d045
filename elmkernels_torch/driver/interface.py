"""Host-model (ATS-style) coupling interface.

Counterpart of ``elmkernels_tpu/driver/interface.py``, after the
reference's ``MinimalInterface`` / ``interface_data_transfer`` sketch
(``driver/kokkos/minimal_elm_interface.cc``,
``interface_data_transfer.hh:6-127``): a host hydrology model hands in
already-interpolated forcing and receives the exchange fluxes
(qflx_rootsoi, qflx_top_soil, evaporation terms) and a PrimaryVars
snapshot for convergence recovery.  The exchange travels as numpy arrays
on the host, as in the JAX package; the model runs where its ``device``
says.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from elmkernels_torch.data.state import StepForcing, StepPhenology
from elmkernels_torch.driver import step as step_mod
from elmkernels_torch.driver.model import Model
from elmkernels_torch.utils import checkpoint
from elmkernels_torch.utils.dates import Date


class ExchangeFluxes(NamedTuple):
    """Surface fluxes exported to the host hydrology model (reference:
    ``interface_data_transfer.hh`` required-output list), numpy arrays."""
    qflx_rootsoi: np.ndarray     # [ncol, nlevgrnd] transpiration sink
    qflx_top_soil: np.ndarray    # water into top soil layer
    qflx_evap_tot: np.ndarray
    eflx_sh_tot: np.ndarray
    eflx_lh_tot: np.ndarray
    eflx_lwrad_out: np.ndarray


class HostForcing(NamedTuple):
    """Host-provided atmospheric forcing, already interpolated to the step
    time, [ncol] each: the reference ATS pathway's
    ``atm_data::AtmosphereFileInput`` (``input_containers.h:8-30``).
    ``atm_qbot`` is specific humidity [kg/kg].  ``atm_zbot`` is carried
    for interface parity; the step pins the forcing heights as the
    reference's ``ProcessZBOT`` does (30 m)."""
    atm_tbot: np.ndarray
    atm_pbot: np.ndarray
    atm_qbot: np.ndarray
    atm_flds: np.ndarray
    atm_fsds: np.ndarray
    atm_prec: np.ndarray
    atm_wind: np.ndarray
    atm_zbot: np.ndarray | None = None


class HostPhenology(NamedTuple):
    """Host-provided phenology, already month-interpolated, [ncol] each
    (reference ``phen_data::PhenologyFileInput``,
    ``input_containers.h:33-45``); the snow-burial adjustment still runs
    inside the step."""
    lai: np.ndarray
    sai: np.ndarray
    htop: np.ndarray
    hbot: np.ndarray


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _copy(tree):
    """A copy of every tensor of a NamedTuple or dict: a snapshot never
    aliases the state it came from, nor the state restored from it."""
    if isinstance(tree, dict):
        return {k: v.clone() for k, v in tree.items()}
    return type(tree)(*(v.clone() for v in tree))


@dataclasses.dataclass
class MinimalInterface:
    """setup/advance/getPrimaryVars, mirroring the reference
    ``ELMInterface`` surface (``elm_kokkos_interface.hh``).

    Two forcing modes, the reference's two coupling designs:

    - :meth:`advance`: the model's own forcing and phenology providers
      (the standalone ``ELMInterface``);
    - :meth:`advance_with_forcing`: the HOST supplies per-step,
      already-interpolated forcing and phenology (:class:`HostForcing`,
      :class:`HostPhenology`): the ATS input-container pathway
      (``input_containers.h:8-45``).

    ``model_kw`` passes through to :class:`Model` (parameter files, site,
    flags, ``device``)."""
    ncol: int
    model_kw: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.model = Model(ncol=self.ncol, **self.model_kw)

    def setup(self):
        return self

    def _exchange(self, d: step_mod.StepDiagnostics) -> ExchangeFluxes:
        return ExchangeFluxes(*(_host(getattr(d, k))
                                for k in ExchangeFluxes._fields))

    def advance(self, date: Date, dt_seconds: float) -> ExchangeFluxes:
        assert dt_seconds == self.model.dtime
        return self._exchange(self.model.advance(date))

    def advance_with_forcing(self, date: Date, dt_seconds: float,
                             atm: HostForcing,
                             phen: HostPhenology) -> ExchangeFluxes:
        """One dt driven by host-provided forcing.

        The host's values enter the step as a degenerate bracket (both
        samples equal, wt1=1), which the step's time interpolation
        reproduces exactly; all derived-forcing physics (theta/rho/qsat,
        the FSDS spectral split, the rain/snow partition) runs in the step
        as in :meth:`advance`.  ``atm_qbot`` is specific humidity, so the
        step runs with ``qbot_is_rh=False`` whatever the model's own
        provider delivers; every other flag is the model's."""
        assert dt_seconds == self.model.dtime
        m = self.model

        def arr(x):
            a = np.asarray(x, np.float64)
            if a.shape != (self.ncol,):
                raise ValueError(f"host forcing field shape {a.shape} "
                                 f"!= ({self.ncol},)")
            return a

        def pair(x):
            a = arr(x)
            return np.stack([a, a])

        forc = StepForcing(
            wt1=1.0, wt2=0.0, tbot=pair(atm.atm_tbot),
            pbot=pair(atm.atm_pbot), qbot=pair(atm.atm_qbot),
            flds=pair(atm.atm_flds), wind=pair(atm.atm_wind),
            fsds=arr(atm.atm_fsds), prec=arr(atm.atm_prec),
            decday=date.decimal_doy() + 1.0)
        forc = m._attach_aero(forc, date)
        phen_step = StepPhenology(
            wt1=1.0, wt2=0.0, mlai=pair(phen.lai), msai=pair(phen.sai),
            mhtop=pair(phen.htop), mhbot=pair(phen.hbot))
        m.state, d = step_mod.advance(
            m.land, m.psnveg, m.albveg, m.snicar, m.params, m.state,
            m._to_device(forc), m._to_device(phen_step), m.dtime,
            psn_mode=m.psn_mode, qbot_is_rh=False,
            mixed_radiation=m.mixed_radiation,
            elm_correct_seb=m.elm_correct_seb, warm_start=m.warm_start,
            mixed_canopy=m.mixed_canopy, het_ltype=m.het_ltype,
            elm_correct_snow_aging=m.elm_correct_snow_aging)
        return self._exchange(d)

    def get_primary_vars(self) -> dict:
        """A copy of the reference's restart subset (``copyPrimaryVars``,
        ``elm_kokkos_interface.cc:324-347``), on the model's device."""
        return _copy(checkpoint.primary_vars(self.model.state))

    def set_primary_vars(self, pv: dict) -> None:
        """Restore a :meth:`get_primary_vars` snapshot (host-model
        convergence recovery); the state takes copies."""
        self.model.state = self.model.state._replace(**_copy(pv))

    def snapshot(self):
        """A copy of the WHOLE model state.  Exact re-advance after a
        failed step also needs the carried non-primary state (t_veg/t10,
        snow aerosol masses, previous-step fluxes, solver warm-start
        carries), so the recovery loop snapshots everything, as the JAX
        package does."""
        return _copy(self.model.state)

    def restore(self, snap) -> None:
        """Restore a :meth:`snapshot`.  Copies, never aliases, so a
        recovery loop may restore the same snapshot twice."""
        self.model.state = _copy(snap)
