"""How ``correct`` is decided: the plain reference
(:mod:`portbench.reference.columns`) follows the columns the drive kept,
and each number compared is held to its limit.

The windows cells and the coupled cell compare:

- ``state_gap``: the widest gap, over every field of the state and every
  column the reference follows, between the program's state and the
  reference's, as a share of the largest magnitude of that field in the
  reference (a sentinel (|x| >= 1e30) or NaN where the other side has
  none: the gap is infinite).  Two stretches: from the cold start through
  the set-up's first steps (the reference from the same inputs), and the
  measured window's last steps (the reference from the program's own state
  where they start).
- the windows cells: the conservation errors the loop reports for every
  column and step of the window (``errh2o_led_max``, ``errlon_max``,
  ``errsol_max``), held to the limits the configuration states;
- a cell over ranks: ``ranks_disagree``, the window's domain diagnostics
  (a step's field) that some rank holds otherwise than rank 0 (limit 0:
  the collectives hand every rank the same numbers);
- the coupled cell: ``flux_gap``, the same gap over the exchange fluxes
  handed back in the last steps, and ``nonfinite_steps``, the steps
  whose fluxes hold a value that is not finite (limit 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import inputs
from portbench.reference.columns import Columns, grid_fields
from portbench.reference.elm.data.state import ModelState

SENTINEL = 1.0e30


def field_gap(a: np.ndarray, b: np.ndarray) -> float:
    """The gap of one field: the largest |a - b| over the entries both
    hold, over the largest |b| there; infinite where a sentinel or a NaN
    stands on one side only."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    sa, sb = np.abs(a) >= SENTINEL, np.abs(b) >= SENTINEL
    if (sa != sb).any() or (np.isnan(a) != np.isnan(b)).any():
        return math.inf
    m = ~sb & ~np.isnan(b)
    if not m.any():
        return 0.0
    d = float(np.abs(a[m] - b[m]).max())
    scale = float(np.abs(b[m]).max())
    if d == 0.0:
        return 0.0
    return d / scale if scale > 0.0 else math.inf


def widest_gap(prog: dict, ref: dict) -> tuple[float, str]:
    """(the widest field gap, its field) over the fields of ``ref``."""
    worst, where = 0.0, ""
    for k, b in ref.items():
        g = field_gap(_np(prog[k]), _np(b))
        if g > worst or not where:
            worst, where = g, k
    return worst, where


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().double().cpu().numpy()
    return np.asarray(v, np.float64)


def _state_of(fields: dict, dtype, device) -> ModelState:
    """A reference state from a gathered state, in ``dtype``."""
    def conv(v):
        v = v.to(device)
        return v.to(dtype) if v.is_floating_point() else v
    return ModelState(*(conv(fields[k]) for k in ModelState._fields))


def _fields(state) -> dict:
    return {k: v for k, v in zip(state._fields, state)}


class Reference:
    """The reference over a drive's columns, in ``dtype`` (the
    configuration's own, or the control's lower one)."""

    def __init__(self, drive, dtype=None, device=None):
        cfg = drive.cfg
        self.drive = drive
        self.dtype = dtype or getattr(torch, cfg["dtype"])
        self.device = device or drive.device
        ref_cfg = dict(cfg, ncol=drive.grid_ncol)
        grid = grid_fields(ref_cfg, drive.files)
        # each input kind's reader of its files, over the compared columns
        providers = {k.ROLE: k.reference(ref_cfg, drive.files, drive.cols,
                                         grid)
                     for k in drive.kinds.values()}
        self.cols = Columns(ref_cfg, grid, drive.files, drive.cols,
                            self.dtype, self.device, providers)

    def cold(self) -> ModelState:
        """The cold start of these columns with the drive's edits."""
        return inputs.apply_edits(self.cols.cold_start(), self.drive.edits,
                                  self.drive.cols)

    def follow(self, state, first: int, steps: int):
        """``steps`` steps from step ``first``: (state, [per-step
        diagnostics])."""
        from portbench.reference.elm.utils.dates import Date
        d = self.drive
        date0 = d.date_at(first)
        date = Date(date0.year, date0.doy, date0.sec)
        diags = []
        for k in range(steps):
            if hasattr(d, "host"):
                atm, phen = d.host.step(date, d.dtime, d.cols)
                state, dg = self.cols.step_host(state, date, atm, phen)
            else:
                state, dg = self.cols.step(state, date)
            diags.append(dg)
            date.increment_seconds(int(d.dtime))
        return state, diags


def stretches(drive) -> list[tuple[int, int]]:
    """(first step, steps) of each stretch the reference follows: the
    start, from the cold start, and the window's last steps."""
    first, n0 = drive.start_check
    last = max(drive.snaps)
    steps = min(last - n0, drive.window if hasattr(drive, "window")
                else int(drive.traffic["compare"]["steps"]))
    return [(first, n0)] + ([(last - steps, steps)] if steps > 0 else [])


EXCHANGE = ("qflx_rootsoi", "qflx_top_soil", "qflx_evap_tot",
            "eflx_sh_tot", "eflx_lh_tot", "eflx_lwrad_out")


class _Gaps:
    """The widest gaps of one side against the reference, and where."""

    def __init__(self):
        self.values, self.where = {}, {}

    def add(self, name: str, got: dict, want: dict) -> None:
        g, f = widest_gap(got, want)
        if g >= self.values.get(name, 0.0):
            self.values[name], self.where[name] = g, f


def _ledger(diags) -> float:
    """The largest |errh2o_led| of a stretch's diagnostics."""
    return max((float(d.errh2o_led.abs().max()) for d in diags),
               default=0.0)


def readings(drive, control=None) -> dict:
    """The gaps of the program against the reference: ``values`` {name:
    widest gap} and ``where`` {name: its field}; ``ledger``, the largest
    closed-ledger error of the reference over its stretches; with
    ``control`` (a dtype below the configuration's) also ``control``, the
    gaps of the reference computed in that dtype in the program's place,
    over the same stretches from the same states, and its ledger error in
    ``ledger``."""
    ref = Reference(drive)
    low = None if control is None else Reference(drive, control)
    coupled = hasattr(drive, "host")
    prog, ctrl = _Gaps(), _Gaps()
    ledger = dict(reference=0.0)
    for first, steps in stretches(drive):
        start = (ref.cold() if first == 0
                 else _state_of(drive.snaps[first], ref.dtype, ref.device))
        want, want_d = ref.follow(start, first, steps)
        ledger["reference"] = max(ledger["reference"], _ledger(want_d))
        want_flux = [{x: getattr(dg, x) for x in EXCHANGE} for dg in want_d]
        prog.add("state_gap", drive.snaps[first + steps], _fields(want))
        if coupled and first > 0:
            for k in range(steps):
                prog.add("flux_gap", drive.fluxes[first + k], want_flux[k])
        if low is not None:
            lstate, ldiags = low.follow(
                _state_of(_fields(start), low.dtype, low.device), first,
                steps)
            ctrl.add("state_gap", _fields(lstate), _fields(want))
            ledger["control"] = max(ledger.get("control", 0.0),
                                    _ledger(ldiags))
            if coupled and first > 0:
                for k, dg in enumerate(ldiags):
                    ctrl.add("flux_gap", {x: getattr(dg, x)
                                          for x in EXCHANGE}, want_flux[k])
    out = dict(values=prog.values, where=prog.where, ledger=ledger)
    if low is not None:
        out["control"] = ctrl.values
    return out


def over_ranks(read: dict, group, diags=None) -> dict | None:
    """:func:`readings` over the ranks of ``group``, on rank 0 (None on
    the others): each gap the widest any rank read, its field naming that
    rank, and each ledger error the largest.  With ``diags`` (each rank's
    [steps, fields] domain diagnostics of the window) also
    ``ranks_disagree``: how many of them some rank holds otherwise than
    rank 0, where the collectives hand every rank the same numbers."""
    got = group.gather((read, diags))
    if group.rank:
        return None
    out = dict(read, values={}, where={})
    for r, (part, _) in enumerate(got):
        for k, v in part["values"].items():
            if k not in out["values"] or v > out["values"][k]:
                out["values"][k] = v
                out["where"][k] = f"{part['where'][k]} (rank {r})"
    for key in ("control", "ledger"):
        if key in read:
            out[key] = {k: max(part[key][k] for part, _ in got)
                        for k in read[key]}
    if diags is not None:
        first = got[0][1]
        same = np.ones(first.shape, bool)
        for _, d in got[1:]:
            same &= (d == first) | (np.isnan(d) & np.isnan(first))
        out["values"]["ranks_disagree"] = int((~same).sum())
        out["where"]["ranks_disagree"] = "the window's domain diagnostics"
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}); a number
    that is not finite is not within any limit."""
    checks = {}
    ok = True
    for k, v in values.items():
        lim = limits[k]
        good = math.isfinite(v) and v <= lim
        ok &= good
        checks[k] = dict(value=v, limit=lim)
    return ok, checks
