"""The two ways a cell drives the program, by the traffic mix's
``entry``:

- ``windows``: the production loop, ``Model.run_windows(series=True)``,
  called again and again, ``call_steps`` steps to a call in windows of
  ``window`` steps, until the measured window has passed;
- ``coupled``: one closed-loop caller of
  ``MinimalInterface.advance_with_forcing``, which builds each step's
  forcing on the host, hands it in and waits for the exchange fluxes
  before it sends the next step.

Each keeps, for the columns the reference follows, the state at the
points the comparison starts and ends (``snaps``), taken on the device by
one gather a field.

A ``windows`` drive given a ``group`` (:class:`portbench.ranks.Group`) is
one rank's block of the grid: ``Model.from_surfdata(..., col0=mesh.col0,
sharding=mesh)`` over ``parallel.column_mesh``, the seed's edits and
compared columns drawn for the whole grid and cut to the block, and the
measured window run in lockstep with the other ranks.  Only this module
imports the program."""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import inputs
from portbench.reference.columns import STEP_FLAGS


def _date(spec: str):
    from elmkernels_torch.utils.dates import Date
    day, clock = spec.split(" ")
    y, m, d = (int(v) for v in day.split("-"))
    hh, mm = (int(v) for v in clock.split(":"))
    date = Date.from_ymd(y, m, d)
    date.increment_seconds(hh * 3600 + mm * 60)
    return date


def _later(date, seconds: int):
    out = date.copy()
    out.increment_seconds(int(seconds))
    return out


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gather(state, idx: torch.Tensor) -> dict:
    """The rows ``idx`` of every field of a state, as new tensors."""
    return {k: v.index_select(0, idx) for k, v in zip(state._fields, state)}


def model_kw(cfg: dict, files: dict, device) -> dict:
    """``Model``'s keywords for a configuration (everything but the
    grid's columns)."""
    kw = dict(pft_path=files["pft"], snicar_path=files["snicar"],
              dtime=float(cfg["dtime"]), device=device,
              dtype=getattr(torch, cfg["dtype"]),
              **{k: bool(cfg["flags"][k]) for k in STEP_FLAGS})
    for key, name in (("phenology", "phenology_path"),
                      ("aerosol", "aerosol_path")):
        if key in files:
            kw[name] = files[key]
    return kw


def build_model(cfg: dict, files: dict, ncol: int, device, mesh=None):
    """The configuration's ``Model`` of ``ncol`` columns; with ``mesh``
    (a ``ColumnMesh``) its rank's block of them."""
    from elmkernels_torch.driver.model import Model
    kw = model_kw(cfg, files, device)
    if mesh is not None:
        ncol = mesh.ncol
        kw.update(col0=mesh.col0, sharding=mesh)
    if cfg["grid"] == "global":
        return Model.from_surfdata(files["surfdata"], ncol, **kw)
    return Model(ncol=ncol, **cfg["site"], **kw)


class Drive:
    """One cell's program: set-up, the measured window, and what the
    reference needs to judge it.  ``ncol`` is the grid's columns, and
    this process's where there is no ``group``; with one, ``mesh`` is this
    rank's block and ``ncol`` its columns."""

    group = mesh = None

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 ncol: int | None = None, compare_columns: int | None = None,
                 group=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.ncol = cfg["ncol"] if ncol is None else ncol
        self.files = inputs.files_of(cfg, self.ncol)
        if group is not None:
            from elmkernels_torch.parallel import column_mesh
            self.group = group
            self.mesh = column_mesh(self.ncol, device=self.device)
            self.ncol = self.mesh.ncol
        self.dtime = float(cfg["dtime"])
        self.count = (traffic["compare"]["columns"]
                      if compare_columns is None else compare_columns)
        self.start = _date(traffic["start"])

    @property
    def grid_ncol(self) -> int:
        """The columns of the whole grid."""
        return self.ncol if self.mesh is None else self.mesh.ncol_global

    @property
    def block(self):
        """This rank's columns of the grid (None: all of them)."""
        return None if self.mesh is None else slice(self.mesh.lo,
                                                     self.mesh.hi)

    def reseed(self, seed: int) -> None:
        """The inputs of ``seed``, and the count of steps back to 0.  The
        edits and the compared columns (``cols``, on the grid) are drawn
        for the whole grid, whatever the ranks; ``idx`` is where this
        process holds ``cols``."""
        self.seed = seed
        self.edits = inputs.state_edits(self.traffic["state"],
                                        self.grid_ncol, seed)
        cols = inputs.compared_columns(self.grid_ncol, self.count, seed)
        lo = 0 if self.mesh is None else self.mesh.lo
        self.cols = cols[(cols >= lo) & (cols < lo + self.ncol)]
        self.idx = torch.as_tensor(self.cols - lo, device=self.device)
        self.steps_done = 0          # steps since the cold start
        self.snaps: dict[int, dict] = {}   # step count -> gathered state

    def setup(self, keep_cold: bool = False) -> None:
        """Build the program and start it from the seed's inputs;
        ``keep_cold`` keeps a copy of its cold start for :meth:`begin`."""
        self.build()
        self.cold = ({k: v.clone() for k, v in
                      zip(self.state._fields, self.state)}
                     if keep_cold else None)
        self.begin(self.seed)

    def begin(self, seed: int) -> None:
        """Start from the cold start with ``seed``'s inputs (again, after
        ``setup(keep_cold=True)``), and warm up."""
        self.reseed(seed)
        st = (self.state if self.cold is None else type(self.state)(
            **{k: v.clone() for k, v in self.cold.items()}))
        self.state = inputs.apply_edits(st, self.edits, self.block)
        self.warm_up()

    def date_at(self, step: int):
        return _later(self.start, step * self.dtime)

    def _snap(self, state) -> None:
        self.snaps[self.steps_done] = gather(state, self.idx)

    def snow(self) -> dict:
        """The columns under snow now: with a snow layer (``layered``),
        with any snow (``covered``), and their snow layers in all
        (``layers``)."""
        st = self.state
        return dict(step=self.steps_done, layered=int((st.snl > 0).sum()),
                    covered=int((st.h2osno > 0).sum()),
                    layers=int(st.snl.sum()))


class WindowsDrive(Drive):
    """``Model.run_windows(series=True)``: ``call_steps`` steps a call, in
    windows of ``window`` steps."""

    def build(self) -> None:
        self.call_steps = int(self.traffic["call_steps"])
        self.window = int(self.traffic["window"])
        self.model = build_model(self.cfg, self.files, self.ncol,
                                 self.device, self.mesh)
        self.start_check = (0, self.window)

    @property
    def state(self):
        return self.model.state

    @state.setter
    def state(self, value) -> None:
        self.model.state = value

    def warm_up(self) -> None:
        self.diags = []
        self.call()                      # warms every shape the window uses
        self.diags.clear()

    def _window_done(self, date, state, d) -> None:
        self.steps_done += self.window
        # the start of the comparison, and the state the last window
        # ended with; the first window after the cold start is kept too
        keep = {self.window, self.steps_done - self.window}
        with record_function("portbench.keep"):
            self._snap(state)
        self.snaps = {k: v for k, v in self.snaps.items()
                      if k in keep or k == self.steps_done}

    def call(self):
        """One call of the loop; returns its [call_steps] diagnostics."""
        with record_function("portbench.run_windows"):
            d = self.model.run_windows(
                self.date_at(self.steps_done), self.call_steps,
                window=self.window, series=True,
                callback=self._window_done)
        self.diags.append(d)
        return d

    def measure(self, seconds: float) -> dict:
        """Calls until ``seconds`` have passed; the window ends at the first
        call boundary after that, once the card has finished.  Over ranks
        the window starts at a barrier, rank 0 decides at each call
        boundary whether it has passed, so that every rank makes the same
        calls, and it ends at a barrier once every card has finished; the
        rate is the whole grid's on rank 0's clock."""
        snow0 = self.snow()
        sync(self.device)
        if self.group is not None:
            self.group.barrier()
        n0 = self.steps_done
        cpu0, t0 = time.process_time(), time.perf_counter()
        calls = []
        while True:
            a = time.perf_counter()
            self.call()
            calls.append(time.perf_counter() - a)
            done = time.perf_counter() - t0 >= seconds
            if self.group is not None:
                done = self.group.decide(done)
            if done:
                break
        sync(self.device)
        if self.group is not None:
            self.group.barrier()
        wall = time.perf_counter() - t0
        steps = self.steps_done - n0
        rate = self.grid_ncol * steps / wall
        # a grid over cards spreads more than a card alone: its cell reads
        # the rate as an end-to-end metric of its own, with its own bound
        return dict(steps=steps, wall_s=wall, calls_s=calls,
                    cpu_s=time.process_time() - cpu0,
                    column_steps_per_s=rate, grid_column_steps_per_s=rate,
                    snow=[snow0, self.snow()])

    def traced(self) -> dict:
        """One more call, for the profiler: its steps, the snow at its
        start, and its diagnostics ({field: [steps] numpy array}), which
        the rooflines count from."""
        snow = self.snow()
        d = self.call()
        return dict(steps=self.call_steps, snow=snow,
                    diags={k: v.double().cpu().numpy()
                           for k, v in zip(d._fields, d)})

    def conservation(self) -> dict:
        """The window's conservation errors, the largest over every column
        at each step: {name: [steps] numpy array}."""
        return {k: torch.cat([getattr(x, k) for x in self.diags])
                .double().cpu().numpy()
                for k in ("errh2o_led_max", "errlon_max", "errsol_max")}

    def diag_rows(self) -> np.ndarray:
        """Every domain diagnostic of the window's calls, [steps, fields]
        float64."""
        return torch.stack([torch.cat([getattr(x, k) for x in self.diags])
                            .double() for k in self.diags[0]._fields],
                           dim=1).cpu().numpy()

    def release(self) -> None:
        del self.model, self.cold


class CoupledDrive(Drive):
    """One caller in a closed loop over
    ``MinimalInterface.advance_with_forcing``."""

    def build(self) -> None:
        if self.mesh is not None:
            raise ValueError("the coupled drive runs on one card")
        from elmkernels_torch.driver.interface import (HostForcing,
                                                       HostPhenology,
                                                       MinimalInterface)
        self.HostForcing, self.HostPhenology = HostForcing, HostPhenology
        kw = model_kw(self.cfg, self.files, self.device)
        kw.update(self.cfg["site"])
        self.iface = MinimalInterface(self.ncol, model_kw=kw).setup()
        self.keep = int(self.traffic["compare"]["steps"])
        self.start_check = (0, int(self.traffic["warmup_steps"]))

    @property
    def state(self):
        return self.iface.model.state

    @state.setter
    def state(self, value) -> None:
        self.iface.model.state = value

    def warm_up(self) -> None:
        self.host = inputs.HostForcing(self.ncol, self.seed)
        self.forcing_s: list[float] = []    # each step's forcing build
        self.fluxes: dict[int, dict] = {}
        self.nonfinite = 0
        for _ in range(self.start_check[1]):
            self.step()
        self.fluxes.clear()
        self.nonfinite = 0

    def step(self) -> float:
        """One coupled step, timed from the host's first work on its forcing
        to the exchange fluxes back on the host; the state before it and
        its fluxes are kept for the comparison's last steps."""
        t0 = time.perf_counter()
        date = self.date_at(self.steps_done)
        with record_function("portbench.host_forcing"):
            atm, phen = self.host.step(date, self.dtime)
        self.forcing_s.append(time.perf_counter() - t0)
        with record_function("portbench.advance_with_forcing"):
            ex = self.iface.advance_with_forcing(
                date, self.dtime, self.HostForcing(**atm),
                self.HostPhenology(**phen))
        took = time.perf_counter() - t0
        k = self.steps_done
        self.steps_done += 1
        with record_function("portbench.keep"):
            self.fluxes[k] = {f: np.asarray(v)[self.cols]
                              for f, v in zip(ex._fields, ex)}
            # a NaN or an infinity anywhere makes the sum not finite
            self.nonfinite += int(not all(np.isfinite(np.add.reduce(
                v, axis=None)) for v in ex))
            self._snap(self.state)
        first = self.steps_done - self.keep
        self.snaps = {s: v for s, v in self.snaps.items()
                      if s >= first or s == self.start_check[1]}
        self.fluxes = {s: v for s, v in self.fluxes.items() if s >= first}
        return took

    def measure(self, seconds: float) -> dict:
        sync(self.device)
        n0 = self.steps_done
        self.nonfinite = 0
        self.forcing_s = []
        times = []
        cpu0, t0 = time.process_time(), time.perf_counter()
        while True:
            times.append(self.step())
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        steps = self.steps_done - n0
        ms = [1e3 * t for t in times]
        slow = sorted(range(len(ms)), key=ms.__getitem__)[-10:]
        return dict(steps=steps, wall_s=wall,
                    cpu_s=time.process_time() - cpu0, step_s=times,
                    coupled_steps_per_s=steps / wall,
                    coupled_step_ms_p95=p95(ms),
                    coupled_step_ms_mean=sum(ms) / len(ms),
                    coupled_step_ms_p50=statistics.median(ms),
                    forcing_ms_mean=1e3 * sum(self.forcing_s) / len(ms),
                    slowest=[[i, ms[i]] for i in reversed(slow)])

    def traced(self) -> dict:
        n = int(self.traffic["traced_steps"])
        for _ in range(n):
            self.step()
        return dict(steps=n)

    def release(self) -> None:
        del self.iface, self.cold


def p95(values) -> float:
    """The 95th percentile of every value, by Python's ``statistics``
    (exclusive method); a single value is its own."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20)[18]


DRIVES = {"windows": WindowsDrive, "coupled": CoupledDrive}
