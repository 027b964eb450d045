"""What every way of driving the program shares.  A traffic mix's
``entry`` names its drive, a file of its own, ``drives/<entry>.py``
(``portbench/manifest.py``): ``windows``, the production loop, and
``coupled``, one closed-loop caller of the coupling interface.

A drive builds the configuration's ``Model`` from its parameter files,
its grid and the keywords its input kinds give (``sources/``), starts it
from the seed's edits, warms it up, measures, and keeps, for the columns
the reference follows, the state at the points the comparison starts and
ends (``snaps``), taken on the device by one gather a field.

A drive given a ``group`` (:class:`portbench.ranks.Group`) is one rank's
block of the grid: ``Model.from_surfdata(..., col0=mesh.col0,
sharding=mesh)`` over ``parallel.column_mesh``, the seed's edits and
compared columns drawn for the whole grid and cut to the block.  Only
this module and the drives import the program."""

from __future__ import annotations

import statistics

import torch

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


def model_kw(cfg: dict, files: dict, device, kinds: dict) -> dict:
    """``Model``'s keywords for a configuration (everything but the
    grid's columns): its parameters, type and flags, and what each of its
    input kinds feeds (``kinds``, {kind: module})."""
    kw = dict(pft_path=files["pft"], snicar_path=files["snicar"],
              dtime=float(cfg["dtime"]), device=device,
              dtype=getattr(torch, cfg["dtype"]),
              **{k: bool(cfg["flags"][k]) for k in STEP_FLAGS})
    for kind in kinds.values():
        kw.update(kind.model_kw(cfg, files))
    return kw


def build_model(cfg: dict, files: dict, ncol: int, device, kinds: dict,
                mesh=None):
    """The configuration's ``Model`` of ``ncol`` columns, fed by its input
    kinds (``kinds``, {kind: module}); with ``mesh`` (a ``ColumnMesh``) its
    rank's block of them."""
    from elmkernels_torch.driver.model import Model
    kw = model_kw(cfg, files, device, kinds)
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
    rank's block and ``ncol`` its columns.  ``kinds`` ({kind: module})
    are the configuration's input kinds."""

    group = mesh = None

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 kinds: dict, ncol: int | None = None,
                 compare_columns: int | None = None, group=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.ncol = cfg["ncol"] if ncol is None else ncol
        self.kinds = kinds
        self.files = inputs.files_of(cfg, kinds, self.ncol)
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


def p95(values) -> float:
    """The 95th percentile of every value, by Python's ``statistics``
    (exclusive method); a single value is its own."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20)[18]

