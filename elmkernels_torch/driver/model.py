"""Host-side model API: setup, the step, and the time loops.

Counterpart of ``elmkernels_tpu/driver/model.py``.  The model runs on the
first CUDA device unless the caller passes ``device="cpu"``; with no card
and no explicit ``"cpu"`` it raises rather than falling back.

Four loops drive the step over time, with the same results:

- :meth:`Model.run` builds each step's inputs on the host and copies them
  to the device step by step (the reference's own loop).
- :meth:`Model.run_scan` ships per-step stacks of the inputs of ``nsteps``
  steps to the device in one set of copies, then runs the steps from it.
- :meth:`Model.run_scan_series` ships the forcing *series* (the samples on
  the forcing-time grid) and the monthly phenology/aerosol bracket pairs
  once; each step gathers its brackets on the device, by host-side
  integer indices, with no host wait.
- :meth:`Model.run_windows` runs ``nsteps`` as windows of either layout,
  assembling the next window on a host thread and copying it on a side
  stream while the current one computes.

The three device loops copy from pinned memory when the model is on a
card, and reduce each step's diagnostics on the device
(:class:`ScanDiagnostics`).

``Model(..., packed_carry=True)`` carries the state of the three device
loops in one ``[ncol, K]`` buffer per dtype (:mod:`elmkernels_torch.utils.
packing`): the same results bit for bit, the carry at fixed addresses for
the life of the model.  The state's fields are then views into those
buffers, which the next device loop overwrites: clone what is kept.

On a card the four loops replay one captured step
(:mod:`elmkernels_torch.driver.graphs`, the counterpart of the JAX
package's jitted step and scans): the first step under a configuration
runs eagerly, the next is captured as a CUDA graph, and every later step
copies its inputs into the graph's static buffers and launches it, bit
for bit with the eager step.  The state then lives in the packed carry
whatever ``packed_carry`` says, and the model's state after a loop is
views into it, which the next step overwrites (as JAX's donated state is
invalid after a jitted call): clone what is kept.  A state set from
outside (a rollback, a restore) is copied into the carry.
:func:`~elmkernels_torch.driver.graphs.disable_graphs` gives the eager
path; the CPU always runs it.

``Model(ncol=mesh.ncol, col0=mesh.col0, sharding=mesh)``, with ``mesh``
from :func:`elmkernels_torch.parallel.column_mesh`, runs one rank's block
of a column axis split over a ``torch.distributed`` group.  The step is
the same and crosses no rank; only the domain diagnostics do, once per
window of a device loop and once per :meth:`Model.reduce_diags` call.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from elmkernels_torch import constants as c
from elmkernels_torch.data import forcing as forcing_mod
from elmkernels_torch.data import params as params_mod
from elmkernels_torch.data.state import (AERO_DEP_KEYS, ModelState,
                                         StepForcing, StepPhenology,
                                         cold_start)
from elmkernels_torch.driver import graphs
from elmkernels_torch.driver import step as step_mod
from elmkernels_torch.physics.photosynthesis import psn_mode_of
from elmkernels_torch.utils.clock import span
from elmkernels_torch.utils.dates import Date, month_indices
from elmkernels_torch.utils.device import resolve_device
from elmkernels_torch.utils.packing import PackedCarry, template_of


# The parameter files the JAX package's Model reads by default: the
# reference's clm_params NetCDF and its SnowOptics text fixture, in the
# reference's input data directory (its build's INPUT_DATA_DIR).  The port
# takes that directory from the environment variable ELM_INPUT_DATA_DIR,
# else the working directory.
INPUT_DATA_DIR = os.environ.get("ELM_INPUT_DATA_DIR", "")
DEFAULT_PFT_PATH = os.path.join(INPUT_DATA_DIR, "clm_params_c180524.nc")
DEFAULT_SNICAR_PATH = os.path.join(INPUT_DATA_DIR, "SnowOptics_IN.txt")


def _parameter_file(path) -> str:
    """``path`` as a string; a missing file raises, naming it."""
    if path is None or not os.path.isfile(path):
        raise FileNotFoundError(
            f"parameter file {str(path)!r} not found "
            f"(elmkernels_torch.data.synthetic.parameter_files() writes "
            f"synthetic ones)")
    return str(path)


class ScanDiagnostics(NamedTuple):
    """Per-step domain reductions of a device loop ([nsteps] each): the
    reference's ``min_max_sum`` diagnostics (``utils.hh:45-103``),
    computed on the device."""
    errh2o_max: torch.Tensor
    errh2o_led_max: torch.Tensor
    errh2osno_max: torch.Tensor
    errh2osno_steady_max: torch.Tensor
    errsol_max: torch.Tensor
    errlon_max: torch.Tensor
    errseb_max: torch.Tensor
    eflx_sh_mean: torch.Tensor
    eflx_lh_mean: torch.Tensor
    fsa_mean: torch.Tensor
    t_ref2m_mean: torch.Tensor
    niters_canopy_max: torch.Tensor
    niters_canopy_mean: torch.Tensor
    niters_ci_mean: torch.Tensor


def _reduce_diags(d: step_mod.StepDiagnostics) -> tuple:
    """One step's ScanDiagnostics fields, as 0-d tensors on the device."""
    wdt = d.fsa.dtype
    return (d.errh2o.abs().max(), d.errh2o_led.abs().max(),
            d.errh2osno.abs().max(), d.errh2osno_steady.abs().max(),
            d.errsol.abs().max(), d.errlon.abs().max(),
            d.errseb.abs().max(), d.eflx_sh_tot.mean(),
            d.eflx_lh_tot.mean(), d.fsa.mean(), d.t_ref2m.mean(),
            d.niters_canopy.max(), d.niters_canopy.to(wdt).mean(),
            d.niters_ci.to(wdt).mean())


def reduce_diags(d: step_mod.StepDiagnostics) -> ScanDiagnostics:
    """One step's diagnostics reduced as a device loop reduces them
    ([1] each)."""
    return ScanDiagnostics(*(v.reshape(1) for v in _reduce_diags(d)))


# the ScanDiagnostics fields that are domain means; the others are maxima
_MEAN_FIELDS = frozenset(("eflx_sh_mean", "eflx_lh_mean", "fsa_mean",
                          "t_ref2m_mean", "niters_canopy_mean",
                          "niters_ci_mean"))
_IS_MEAN = tuple(k in _MEAN_FIELDS for k in ScanDiagnostics._fields)


def _partial_diags(d: step_mod.StepDiagnostics) -> tuple:
    """One step's ScanDiagnostics fields over this rank's columns: the
    maxima as :func:`_reduce_diags` takes them, float64 sums in place of
    the means."""
    f64 = torch.float64
    return (d.errh2o.abs().max(), d.errh2o_led.abs().max(),
            d.errh2osno.abs().max(), d.errh2osno_steady.abs().max(),
            d.errsol.abs().max(), d.errlon.abs().max(),
            d.errseb.abs().max(), d.eflx_sh_tot.sum(dtype=f64),
            d.eflx_lh_tot.sum(dtype=f64), d.fsa.sum(dtype=f64),
            d.t_ref2m.sum(dtype=f64), d.niters_canopy.max(),
            d.niters_canopy.sum(dtype=f64), d.niters_ci.sum(dtype=f64))


def _global_diags(mesh, fields: list, wdt) -> ScanDiagnostics:
    """[nsteps] ScanDiagnostics over every rank's columns from this rank's
    [nsteps] partials, field by field: one MAX and one SUM collective for
    the window.  Maxima come back in their own dtype; means are the global
    float64 sums over the global column count, in the model's dtype
    ``wdt``."""
    from elmkernels_torch.parallel.reductions import combine
    maxima, sums = combine(
        mesh, maxima=[f for f, m in zip(fields, _IS_MEAN) if not m],
        sums=[f for f, m in zip(fields, _IS_MEAN) if m])
    mx, sm = iter(maxima), iter(sums / mesh.ncol_global)
    return ScanDiagnostics(*((next(sm).to(wdt) if m
                              else next(mx).to(f.dtype))
                             for f, m in zip(fields, _IS_MEAN)))


def _stack_host(items: list):
    """A list of NamedTuples of numpy arrays/floats (or None fields)
    stacked field by field along a new leading axis."""
    cls = type(items[0])
    return cls(*(None if vals[0] is None else
                 np.stack([np.asarray(v) for v in vals])
                 for vals in zip(*items)))


@dataclasses.dataclass
class Model:
    """A batch of independent land columns and the step.

    ``pft_path`` is a clm_params NetCDF and ``snicar_path`` a
    snicar_optics_5bnd NetCDF or, for any path not ending in ``.nc``, the
    reference's SnowOptics text fixture; they default to the reference's
    files, :data:`DEFAULT_PFT_PATH` and :data:`DEFAULT_SNICAR_PATH`
    (``elmkernels_torch.data.synthetic`` writes synthetic ones).
    ``vtype`` is one PFT for every column or an [ncol] sequence:
    per-column traits are gathered from the clm_params trait matrix, and
    the photosynthesis runs ``"mixed"`` when C3 and C4 PFTs meet
    (reference ``initialize_elm_kokkos.cc:374-431``).  The site fields
    take a scalar or an [ncol] array (texture: also [ncol, nlevsoi]);
    :meth:`from_surfdata` fills them from a surfdata file.
    ``ltype`` is one landunit type for the domain or an [ncol] sequence
    (mixed soil/crop/ice/wetland batches: each landunit branch then
    selects per column, and non-soil columns cold-start from the
    reference's init kernels).  ``elm_correct_snow_aging=True`` ages the
    snow grains from the ``snicar_drdt`` tables at ``snow_aging_path``.
    The flags default to the JAX ``Model``'s production defaults.
    ``packed_carry=True`` packs the device loops' state carry (module
    docstring).

    On a card ``advance`` (so ``run``), ``run_scan``, ``run_scan_series``
    and ``run_windows`` replay the step captured as a CUDA graph (module
    docstring): the state is then carried packed, and ``self.state`` after
    a step is views into the carry that the next step overwrites, as the
    JAX package's donated state is.  Inside
    ``graphs.disable_graphs()``, and on the CPU, the step runs eagerly."""
    ncol: int
    dtime: float = 1800.0
    vtype: int | list | tuple = 12
    pft_path: str = DEFAULT_PFT_PATH
    snicar_path: str = DEFAULT_SNICAR_PATH
    lat_deg: float | np.ndarray = 71.323
    lon_deg: float | np.ndarray = 203.3886
    ltype: int | np.ndarray = 1
    soil_color: int | np.ndarray = 15
    mxsoil_color: int = 20
    pct_sand: float | np.ndarray = 40.0
    pct_clay: float | np.ndarray = 20.0
    organic: float | np.ndarray = 10.0
    topo_slope_raw: float | np.ndarray = 0.070044865858546
    topo_std: float | np.ndarray = 3.96141847422387
    # month-per-file NetCDF forcing basename ("<basename>YYYY-MM.nc");
    # None selects the synthetic forcing
    forcing_basename: str | None = None
    # surfdata NetCDF with MONTHLY_LAI/SAI/HEIGHT_* (12, pft, cells);
    # None selects the synthetic phenology climatology
    phenology_path: str | None = None
    # aerosoldep_monthly*.nc deposition climatology (12, cells); None
    # keeps the static ModelParams.aero_* rates
    aerosol_path: str | None = None
    col0: int = 0  # global column offset of this host's shard
    # a ColumnMesh (elmkernels_torch.parallel.column_mesh): this model is
    # its rank's block, ncol=mesh.ncol and col0=mesh.col0, on its device;
    # None runs every column in one process
    sharding: object = None
    # snicar_drdt_bst*.nc snow-aging tables; needed by
    # elm_correct_snow_aging=True, inert otherwise
    snow_aging_path: str | None = None
    # ELM's snow grain aging (the reference clamps the radius to
    # SNW_RDS_MIN from both sides); default False is reference-exact
    elm_correct_snow_aging: bool = False
    mixed_radiation: bool = True
    elm_correct_seb: bool = False
    warm_start: bool = True
    mixed_canopy: bool = True
    # carry the device loops' state in one [ncol, K] buffer per dtype
    # (utils/packing.py); run, the per-step loop, is left unpacked
    packed_carry: bool = False
    device: object = None
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        mesh = self.sharding
        if mesh is not None:
            if (self.ncol, self.col0) != (mesh.ncol, mesh.col0):
                raise ValueError(
                    f"Model(ncol={self.ncol}, col0={self.col0}) is not rank "
                    f"{mesh.rank}'s block of its mesh: ncol={mesh.ncol}, "
                    f"col0={mesh.col0}")
            if self.device is None:
                self.device = mesh.device
            elif torch.device(self.device) != mesh.device:
                raise ValueError(f"device {self.device} is not the "
                                 f"mesh's {mesh.device}")
        self.device = resolve_device(self.device)
        pft_path = _parameter_file(self.pft_path)
        snicar_path = _parameter_file(self.snicar_path)
        dev, dt = self.device, self.dtype
        vt = np.asarray(self.vtype, np.int64)
        lt = np.asarray(self.ltype, np.int64)
        self.het_ltype = lt.ndim > 0
        if self.het_ltype and lt.shape != (self.ncol,):
            raise ValueError(f"ltype shape {lt.shape} != ({self.ncol},)")
        snowage_tables = None
        if self.snow_aging_path is not None:
            snowage_tables = params_mod.read_snowrds_data(
                self.snow_aging_path)
        elif self.elm_correct_snow_aging:
            raise ValueError(
                "elm_correct_snow_aging=True ages the snow grains from "
                "snicar_drdt tables: pass snow_aging_path=... (the "
                "placeholder tables are inert only under the reference's "
                "double clamp)")
        if vt.ndim == 0:
            self.psnveg = params_mod.load_pft_psn(pft_path, int(vt),
                                                  dt, dev)
            self.albveg = params_mod.load_pft_alb(pft_path, int(vt),
                                                  dt, dev)
        else:
            if vt.shape != (self.ncol,):
                raise ValueError(
                    f"vtype shape {vt.shape} != ({self.ncol},)")
            table = params_mod.load_pft_table(pft_path)
            self.psnveg = params_mod.gather_pft_psn(table, vt, dt, dev)
            self.albveg = params_mod.gather_pft_alb(table, vt, dt, dev)
        # the domain's LandType keeps an int; a per-column ltype rides in
        # params.ltype and replaces it inside the step (het_ltype)
        self.land = c.LandType(ltype=c.ISTSOIL if self.het_ltype
                               else int(lt), ctype=1, vtype=int(vt.flat[0]))
        self.psn_mode = psn_mode_of(self.psnveg)
        if snicar_path.endswith(".nc"):
            self.snicar = params_mod.read_snicar_data(snicar_path, dt, dev)
        else:
            self.snicar = params_mod.load_snicar_from_text(snicar_path, dt,
                                                           dev)
        self.params = params_mod.default_params(
            self.ncol, pft_path, vt, self.lat_deg, self.lon_deg,
            soil_color=self.soil_color, pct_sand=self.pct_sand,
            pct_clay=self.pct_clay, organic=self.organic,
            mxsoil_color=self.mxsoil_color,
            snowage_tables=snowage_tables, ltype=self.ltype,
            topo_slope_raw=self.topo_slope_raw, topo_std=self.topo_std,
            dtype=dt, device=dev)
        self.state = cold_start(self.ncol, dt, dev)
        self._carry = None
        self._graphs = None
        if self.het_ltype or self.land.ltype not in (c.ISTSOIL, c.ISTCROP):
            self.state = self._ltype_cold_start(self.state)
        lat_r = self.params.lat_r.cpu().numpy()
        lon_r = self.params.lon_r.cpu().numpy()
        if self.forcing_basename is not None:
            self.forcing = forcing_mod.NetCDFForcing(
                self.forcing_basename, self.ncol, lat_r, lon_r,
                col0=self.col0)
        else:
            self.forcing = forcing_mod.SyntheticForcing(self.ncol, lat_r,
                                                        lon_r)
        if self.phenology_path is not None:
            from elmkernels_torch.data.phenology_data import \
                PhenologyDataManager
            self.phenology = PhenologyDataManager(
                self.phenology_path, self.ncol,
                np.broadcast_to(vt, (self.ncol,)).astype(np.int32),
                col0=self.col0)
        else:
            self.phenology = forcing_mod.SyntheticPhenology(self.ncol)
        if self.aerosol_path is not None:
            from elmkernels_torch.data.aerosol_data import AerosolDataManager
            self.aerosol = AerosolDataManager(self.aerosol_path, self.ncol,
                                              col0=self.col0)
        else:
            self.aerosol = None

    @classmethod
    def from_surfdata(cls, surfdata_path: str, ncol: int, col0: int = 0,
                      **kw) -> "Model":
        """A heterogeneous-grid Model from one surfdata-style NetCDF:
        per-column lat/lon, soil color, soil texture profiles, topography
        and (from PCT_NAT_PFT or PFT) the dominant PFT of each column
        (reference ``initialize_elm_kokkos.cc:267-340``,
        ``utils.cc:46-69``).  ``col0``/``ncol`` select this host's shard
        of the flattened cell axis; any other Model field passes through
        ``**kw``, and an explicit ``vtype`` overrides the file's PFTs."""
        from elmkernels_torch.data.surfdata import read_surfdata
        sd = read_surfdata(surfdata_path, ncol, col0)
        if "vtype" not in kw:
            kw["vtype"] = (sd.vtype.tolist() if sd.vtype is not None
                           else cls.vtype)
        for field, val in (("topo_slope_raw", sd.topo_slope),
                           ("topo_std", sd.topo_std)):
            if val is not None and field not in kw:
                kw[field] = val
        return cls(ncol=ncol, col0=col0, lat_deg=sd.lat_deg,
                   lon_deg=sd.lon_deg, soil_color=sd.soil_color,
                   mxsoil_color=sd.mxsoil_color, pct_sand=sd.pct_sand,
                   pct_clay=sd.pct_clay, organic=sd.organic, **kw)

    def _ltype_cold_start(self, state: ModelState) -> ModelState:
        """Ice/wet landunits start from the reference's init kernels
        (``init_soil_temp``/``init_soilh2o_state``) instead of the
        hardwired soil column: an ice sheet ice-filled at 250 K, a wetland
        water-filled.  Soil and crop columns, and every column's snow
        layers and mesh, keep the hardwired start."""
        from elmkernels_torch.physics import init_state as ini
        land = (dataclasses.replace(self.land, ltype=self.params.ltype)
                if self.het_ltype else self.land)
        t, t_grnd = ini.init_soil_temp(land, state.snl, self.ncol,
                                       self.dtype)
        vol, liq, ice = ini.init_soilh2o_state(land, state.snl,
                                               self.params.watsat, t,
                                               state.dz)
        soil = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
        return state._replace(
            t_soisno=c.lsel(soil, state.t_soisno, t),
            t_grnd=c.lsel(soil, state.t_grnd, t_grnd),
            h2osoi_vol=c.lsel(soil, state.h2osoi_vol, vol),
            h2osoi_liq=c.lsel(soil, state.h2osoi_liq, liq),
            h2osoi_ice=c.lsel(soil, state.h2osoi_ice, ice))

    # ---- one step --------------------------------------------------------

    def _step_flags(self) -> dict:
        """``step.advance``'s static keyword arguments for this model."""
        return dict(psn_mode=self.psn_mode,
                    qbot_is_rh=getattr(self.forcing, "qbot_is_rh", False),
                    mixed_radiation=self.mixed_radiation,
                    elm_correct_seb=self.elm_correct_seb,
                    warm_start=self.warm_start,
                    mixed_canopy=self.mixed_canopy, het_ltype=self.het_ltype,
                    elm_correct_snow_aging=self.elm_correct_snow_aging)

    def _step(self, forc: StepForcing, phen: StepPhenology):
        """Advance self.state by one dt from device inputs."""
        self.state, diags = step_mod.advance(
            self.land, self.psnveg, self.albveg, self.snicar, self.params,
            self.state, forc, phen, self.dtime, **self._step_flags())
        return diags

    def _attach_aero(self, forc: StepForcing, date: Date) -> StepForcing:
        if self.aerosol is None:
            return forc
        rates = self.aerosol.rates(date)
        return forc._replace(aero=np.stack([rates[k]
                                            for k in AERO_DEP_KEYS]))

    def _to_device(self, nt):
        """A host-side StepForcing/StepPhenology as device tensors."""
        return type(nt)(*(None if v is None else
                          torch.as_tensor(np.asarray(v, np.float64),
                                          dtype=self.dtype,
                                          device=self.device) for v in nt))

    def step_inputs(self, date: Date) -> tuple[StepForcing, StepPhenology]:
        """The forcing and phenology of the step starting at ``date``, on
        the device, copied there now."""
        forc = self._attach_aero(self.forcing.window(date, self.dtime),
                                 date)
        return (self._to_device(forc),
                self._to_device(self.phenology.window(date)))

    def _host_inputs(self, date: Date):
        """:meth:`step_inputs` as CPU tensors in the model's dtype, pinned
        on a card, for copying into a graph's buffers without a wait."""
        cuda = self.device.type == "cuda"

        def host(nt):
            return type(nt)(*(None if v is None else torch.as_tensor(
                np.asarray(v, np.float64), dtype=self.dtype) for v in nt))
        forc = self._attach_aero(self.forcing.window(date, self.dtime),
                                 date)
        pair = (host(forc), host(self.phenology.window(date)))
        return _map(pair, torch.Tensor,
                    lambda t: t.pin_memory() if cuda else t)

    def advance(self, date: Date) -> step_mod.StepDiagnostics:
        """One dt starting at ``date``; replaces self.state (on a card by
        the captured step, whose diagnostics are copied out)."""
        if not graphs.uses_graphs(self.device):
            return self._step(*self.step_inputs(date))
        (d, _, _), replayed = self._graph_step(self._carry_of(True),
                                               *self._host_inputs(date))
        return type(d)(*(t.clone() for t in d)) if replayed else d

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

    # ---- domain diagnostics ----------------------------------------------

    def _step_diags(self, d) -> tuple:
        """A step's reductions inside a device loop: the domain's own, or
        on a sharded model this rank's partials."""
        return (_reduce_diags(d) if self.sharding is None
                else _partial_diags(d))

    def _window_diags(self, per_step: list) -> ScanDiagnostics:
        """The [nsteps] ScanDiagnostics of a window's :meth:`_step_diags`;
        on a sharded model they are combined over the ranks here, once."""
        return self._window_fields([torch.stack(v) for v in zip(*per_step)])

    def _window_fields(self, fields: list) -> ScanDiagnostics:
        """:meth:`_window_diags` from the [nsteps] fields."""
        if self.sharding is None:
            return ScanDiagnostics(*fields)
        return _global_diags(self.sharding, fields, self.dtype)

    def reduce_diags(self, d: step_mod.StepDiagnostics) -> ScanDiagnostics:
        """A :meth:`run` step's diagnostics reduced as a device loop
        reduces them ([1] each), over every rank's columns on a sharded
        model (two collectives)."""
        return self._window_diags([self._step_diags(d)])

    # ---- device loops ----------------------------------------------------

    def _promote(self, t: torch.Tensor) -> torch.Tensor:
        """A floating input in the model's dtype.  Series variables may
        arrive at their on-disk float32; promoting the gathered rows
        reproduces the host's float64 read bit for bit."""
        return t.to(self.dtype) if t.is_floating_point() else t

    def _pin(self, tree):
        """Every numpy array of a (nested) tuple as a CPU tensor, pinned
        when the model is on a card.  Host work only, so it may run on a
        prefetch thread."""
        cuda = self.device.type == "cuda"

        def pin(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.pin_memory() if cuda else t
        return _map(tree, np.ndarray, pin)

    def _put(self, tree):
        """The pinned tensors of ``tree`` copied to the device, without
        waiting: one copy each, issued on the current stream."""
        return _map(tree, torch.Tensor,
                    lambda t: t.to(self.device, non_blocking=True))

    def host_windows(self, start: Date, nsteps: int):
        """[nsteps]-stacked StepForcing and StepPhenology as numpy arrays:
        host work only, safe on a prefetch thread."""
        date = start.copy()
        forcs, phens = [], []
        for _ in range(nsteps):
            forcs.append(self._attach_aero(
                self.forcing.window(date, self.dtime), date))
            phens.append(self.phenology.window(date))
            date.increment_seconds(int(self.dtime))
        return _stack_host(forcs), _stack_host(phens)

    def stack_windows(self, start: Date, nsteps: int):
        """:meth:`host_windows` on the device, in one set of copies."""
        return self._put(self._pin(self.host_windows(start, nsteps)))

    def _carry_of(self, graphed: bool) -> PackedCarry | None:
        """With ``packed_carry`` or on the graph path (``graphed``):
        ``self.state`` made the model's packed carry, whose buffers are
        allocated at the first device loop and kept while the state's
        shapes and dtypes hold (a state set from outside is copied into
        them); else None."""
        if not (graphed or self.packed_carry):
            return None
        carry = self._carry
        if carry is None or carry.template != template_of(self.state):
            carry = self._carry = PackedCarry(self.state)
        elif self.state is not carry.state:
            carry.update(self.state)
        self.state = carry.state
        return carry

    def _loop_step(self, carry, forc: StepForcing, phen: StepPhenology):
        """One eager step of a device loop: its reductions, taken before a
        packed carry's buffers take the new state."""
        red = self._step_diags(self._step(forc, phen))
        if carry is not None:
            carry.update(self.state)
            self.state = carry.state
        return red

    # ---- the captured step -----------------------------------------------

    def _graph_key(self, carry: PackedCarry, inputs: tuple) -> tuple:
        """The key of the step's graph (``graphs.key_of``)."""
        static = (self.land, self.dtime, self.sharding is None,
                  *self._step_flags().items())
        return graphs.key_of(static, (self.params, self.psnveg,
                                      self.albveg, self.snicar),
                             carry, inputs, self.device)

    def _graph_body(self, carry: PackedCarry):
        """The captured step: ``body(forcing, phenology)`` advances the
        carry's state by one step and copies the new state into the
        carry; it returns the step's diagnostics, its reductions
        (:meth:`_step_diags`) packed in one float64 [14] tensor, and their
        dtypes.  It holds no reference to the model."""
        args = (self.land, self.psnveg, self.albveg, self.snicar,
                self.params)
        dtime, kw = self.dtime, self._step_flags()
        reduce = _reduce_diags if self.sharding is None else _partial_diags

        def body(forc, phen):
            new, d = step_mod.advance(*args, carry.state, forc, phen, dtime,
                                      **kw)
            red = reduce(d)
            packed = torch.stack([r.to(torch.float64) for r in red])
            carry.update(new)
            return d, packed, tuple(r.dtype for r in red)
        return body

    def _graph_step(self, carry: PackedCarry, forc: StepForcing,
                    phen: StepPhenology):
        """One step through the model's graph: ``((diagnostics, packed
        reductions, their dtypes), replayed)``; the outputs of a replay
        are the graph's own, which the next replay overwrites."""
        if self._graphs is None:
            self._graphs = graphs.StepGraphs()
        out, replayed = self._graphs.step(
            self._graph_key(carry, (forc, phen)), self._graph_body(carry),
            (forc, phen), self.device, writes=carry.buffers,
            counters=((carry, "updates"), (carry, "bytes_copied")))
        self.state = carry.state
        return out, replayed

    def _run_steps(self, steps, nsteps: int, poll=None) -> ScanDiagnostics:
        """A device loop's ``nsteps`` steps of ``(forcing, phenology)``
        from ``steps``: eager, or through the graph, whose reductions are
        copied into one [nsteps, 14] block with no host wait.  ``poll()``
        runs after each step.  Each step, from taking its inputs from
        ``steps`` to the poll, is the span ``elm.window.step``."""
        graphed = graphs.uses_graphs(self.device)
        carry = self._carry_of(graphed)
        steps = iter(steps)
        if not graphed:
            out = []
            for _ in range(nsteps):
                with span("elm.window.step"):
                    out.append(self._loop_step(carry, *next(steps)))
                    if poll is not None:
                        poll()
            return self._window_diags(out)
        rows = torch.empty((nsteps, len(ScanDiagnostics._fields)),
                           dtype=torch.float64, device=self.device)
        dtypes = ()
        for k in range(nsteps):
            with span("elm.window.step"):
                (_, packed, dtypes), _ = self._graph_step(carry,
                                                          *next(steps))
                rows[k].copy_(packed)
                if poll is not None:
                    poll()
        return self._window_fields([rows[:, i].to(dt) for i, dt in
                                    enumerate(dtypes)])

    def _scan(self, payload, poll=None) -> ScanDiagnostics:
        """The steps of a per-step stack payload, sliced on the device;
        ``poll()`` runs after each step."""
        forc, phen = payload
        n = forc.tbot.shape[0]
        steps = ((StepForcing(*(None if v is None else self._promote(v[k])
                                for v in forc)),
                  StepPhenology(*(self._promote(v[k]) for v in phen)))
                 for k in range(n))
        return self._run_steps(steps, n, poll)

    def run_scan(self, start: Date, nsteps: int) -> ScanDiagnostics:
        """Advance ``nsteps`` from inputs copied to the device once;
        replaces self.state.  Returns [nsteps]-shaped domain-reduced
        diagnostics."""
        return self._scan(self.stack_windows(start, nsteps))

    def _host_series(self, start: Date, nsteps: int):
        """The forcing-series payload, on the host: the forcing samples on
        the forcing-time grid, per-step bracket indices and weights, and
        the monthly phenology/aerosol bracket pairs, once per month pair
        (works for both forcing providers)."""
        ser, steps = self.forcing.series(start, nsteps, self.dtime)
        # pad nt to the worst-case span, so every window has one shape
        ntfix = int(np.ceil(nsteps * self.dtime
                            / self.forcing.dt_forcing)) + 2
        pad = ntfix - ser.tbot.shape[0]
        if pad > 0:
            ser = type(ser)(*(np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                              for a in ser))
        # monthly streams: the bracket pair is the same for every step of
        # a window but across a month rollover (<= 2 unique pairs), so the
        # unique pairs ship once with per-step indices and weights; the
        # device interpolates with the host path's float64 arithmetic
        date = start.copy()
        mkeys, uniq, uniq_aero, idxs, wt1s, wt2s = [], [], [], [], [], []
        for _ in range(nsteps):
            key = month_indices(date)
            ph = self.phenology.window(date)
            if key not in mkeys:
                mkeys.append(key)
                uniq.append(ph)
                if self.aerosol is not None:
                    uniq_aero.append(self.aerosol.bracket(date))
            idxs.append(mkeys.index(key))
            wt1s.append(ph.wt1)
            wt2s.append(ph.wt2)
            date.increment_seconds(int(self.dtime))
        # pad to >= 2 unique pairs, so windows share one shape
        while len(uniq) < 2:
            uniq.append(uniq[-1])
            if self.aerosol is not None:
                uniq_aero.append(uniq_aero[-1])
        phen_uniq = _stack_host(uniq)
        phen_steps = (np.asarray(idxs, np.int32), np.asarray(wt1s),
                      np.asarray(wt2s))
        aero_uniq = (np.stack(uniq_aero) if self.aerosol is not None
                     else None)
        return ser, steps, (phen_uniq, phen_steps), aero_uniq

    def _pin_series(self, host):
        """A :meth:`_host_series` payload pinned, its bracket indices kept
        on the host as ints (the steps slice by them with no host wait)."""
        ser, steps, (phen_uniq, phen_steps), aero_uniq = host
        idx1 = [int(i) for i in steps.idx1]
        pidx = [int(i) for i in phen_steps[0]]
        pinned = self._pin((ser, steps._replace(idx1=None),
                            phen_uniq._replace(wt1=None, wt2=None),
                            phen_steps[1:], aero_uniq))
        return idx1, pidx, pinned

    def _scan_series(self, idx1, pidx, payload,
                     poll=None) -> ScanDiagnostics:
        """The steps of a series payload: each gathers its bracket rows on
        the device and promotes them after the gather; ``poll()`` runs
        after each step."""
        ser, steps, phen_uniq, (pwt1, pwt2), aero_uniq = payload

        def row(a, i):
            return self._promote(a[i])

        def pair(a, i):
            return self._promote(a[i:i + 2])

        def inputs(k, i, j):
            aero = None
            if aero_uniq is not None:
                ab = row(aero_uniq, j)      # [2, 11, ncol]
                aero = pwt1[k] * ab[0] + pwt2[k] * ab[1]
            forc = StepForcing(
                wt1=steps.wt1[k], wt2=steps.wt2[k], tbot=pair(ser.tbot, i),
                pbot=pair(ser.pbot, i), qbot=pair(ser.qbot, i),
                flds=pair(ser.flds, i), wind=pair(ser.wind, i),
                fsds=row(ser.fsds, i), prec=row(ser.prec, i),
                decday=steps.decday[k], aero=aero)
            phen = StepPhenology(
                wt1=pwt1[k], wt2=pwt2[k], mlai=row(phen_uniq.mlai, j),
                msai=row(phen_uniq.msai, j), mhtop=row(phen_uniq.mhtop, j),
                mhbot=row(phen_uniq.mhbot, j))
            return forc, phen

        return self._run_steps(
            (inputs(k, i, j) for k, (i, j) in enumerate(zip(idx1, pidx))),
            len(idx1), poll)

    def run_scan_series(self, start: Date, nsteps: int) -> ScanDiagnostics:
        """:meth:`run_scan` over the series layout: the same trajectory
        from far fewer bytes shipped; replaces self.state."""
        idx1, pidx, pinned = self._pin_series(
            self._host_series(start, nsteps))
        return self._scan_series(idx1, pidx, self._put(pinned))

    def run_windows(self, start: Date, nsteps: int, window: int = 48,
                    callback: Callable | None = None,
                    series: bool = False) -> ScanDiagnostics:
        """Advance ``nsteps`` as ``nsteps // window`` windows.  A host
        thread assembles and pins the NEXT window while the CURRENT one
        runs; on a card its copy is issued on a side stream as soon as it
        is ready (polled between steps), and the compute stream waits for
        that copy only where the window starts.  At most two windows'
        payloads are alive at once.  ``callback(date, state, diags)`` fires
        per window with the window's diagnostics.  ``series=True`` ships
        each window in the forcing-series layout."""
        if nsteps % window:
            raise ValueError(f"nsteps={nsteps} not a multiple of "
                             f"window={window} (one payload shape)")
        ex = cf.ThreadPoolExecutor(max_workers=1)
        # one copy stream for the whole call: the caching allocator reuses
        # a freed payload's memory only for allocations on the stream that
        # made it, so window i+2's payload takes window i's blocks
        side = (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)
        try:
            date = start.copy()
            nxt = _NextWindow(self, ex, side, date, window, series)
            diags_all = []
            for i in range(nsteps // window):
                host, payload = nxt.take()
                date.increment_seconds(int(self.dtime) * window)
                more = (i + 1) * window < nsteps
                nxt = (_NextWindow(self, ex, side, date, window, series)
                       if more else None)
                poll = nxt.poll if more else None
                d = (self._scan_series(host[0], host[1], payload, poll)
                     if series else self._scan(payload, poll))
                diags_all.append(d)
                if callback is not None:
                    callback(date, self.state, d)
        finally:
            ex.shutdown(wait=True, cancel_futures=True)
        return ScanDiagnostics(*(torch.cat(v) for v in zip(*diags_all)))


class _NextWindow:
    """One window's payload of :meth:`Model.run_windows`: assembled and
    pinned on the host thread, then copied to the device, on a card on the
    call's side stream ``side``, as soon as it is ready."""

    def __init__(self, model: Model, ex, side, date: Date, window: int,
                 series: bool):
        self.model, self.side, self.series = model, side, series
        self.host = self.payload = self.copied = None
        prepare = ((lambda d: model._pin_series(
            model._host_series(d, window))) if series
            else (lambda d: model._pin(model.host_windows(d, window))))
        self.fut = ex.submit(prepare, date.copy())

    def poll(self) -> None:
        """Issue the copy if the host part is ready (no wait)."""
        if self.payload is None and self.fut.done():
            self._copy()

    def _copy(self) -> None:
        """Take the host part (span ``elm.window.wait``, opened even when
        it is ready) and issue its copy (span ``elm.window.copy``)."""
        m = self.model
        with span("elm.window.wait"):
            self.host = self.fut.result()
        with span("elm.window.copy"):
            pinned = self.host[2] if self.series else self.host
            if self.side is None:
                self.payload = m._put(pinned)
                return
            with torch.cuda.stream(self.side):
                self.payload = m._put(pinned)
                self.copied = torch.cuda.Event()
                self.copied.record(self.side)

    def take(self):
        """(host part, device payload), ready for the compute stream."""
        if self.payload is None:
            self._copy()
        if self.copied is not None:
            compute = torch.cuda.current_stream(self.model.device)
            compute.wait_event(self.copied)
            # the payload was allocated on the side stream: keep its
            # memory from reuse until the compute stream is done with it
            _map(self.payload, torch.Tensor,
                 lambda t: t.record_stream(compute))
        return self.host, self.payload


def _map(tree, leaf_type, fn):
    """``fn`` applied to every ``leaf_type`` leaf of a nested tuple (or
    NamedTuple); other leaves pass through."""
    if isinstance(tree, leaf_type):
        return fn(tree)
    if isinstance(tree, tuple):
        vals = [_map(v, leaf_type, fn) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    return tree
