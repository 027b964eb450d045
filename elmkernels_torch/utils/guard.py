"""Failure detection and rollback around the time step.

Counterpart of ``elmkernels_tpu/utils/guard.py``.  The reference keeps a
``PrimaryVars`` snapshot "in case of convergence issues"
(``elm_state.h:15-48``) but never validates a step or restores it.  Here
:class:`StepGuard` snapshots the primary variables on the device, validates
the post-step state (finiteness and conservation-error bounds), and hands
back the last validated snapshot on failure, reporting what tripped.

On a sharded model (a guard given the model's
:class:`~elmkernels_torch.parallel.ColumnMesh`) every check decides on the
maxima over all ranks, so that every rank passes, or trips and rolls its
own block back, together: a guard that decided per rank would let the
ranks' states drift apart without a word.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from elmkernels_torch.utils.checkpoint import primary_vars


def errsol_bound(ncol: int, nsteps: int = 48, base: float = 2.5e-5) -> float:
    """Batch- and horizon-scaled shortwave-closure bound of the
    mixed-radiation production flags (float32 SNICAR and two-stream inside
    the float64 step).

    ``errsol`` is checked as the largest over ``ncol`` columns and
    ``nsteps`` steps of a float32 roundoff, whose maximum grows like
    sqrt(log N) in the number of samples N; the bound scales from the
    calibration size of 8192 columns by one 48-step window.  The
    grazing-zenith columns of a global grid come closest to it.
    Pure-float64 radiation closes to ~1e-13 and needs no scaling."""
    n = ncol * nsteps / (8192.0 * 48.0)
    return base * math.sqrt(1.0 + max(0.0, math.log2(n)) / 2.0)


@dataclasses.dataclass
class GuardReport:
    ok: bool
    reasons: list[str]
    # a validated snapshot exists, so the caller MAY roll back via
    # StepGuard.restore_into (check() itself never mutates state)
    can_roll_back: bool


_ERR_CHECKS = ("errh2o", "errh2o_led", "errh2osno", "errh2osno_steady",
               "errsol", "errseb")


class StepGuard:
    """Validate each step's (or window's) diagnostics; roll the primary
    variables back on failure.  A threshold of ``None`` disables its check.

    ``diags`` is a per-step :class:`StepDiagnostics` (full [ncol] fields)
    or a window's :class:`ScanDiagnostics` (``<name>_max`` fields), or any
    object with such fields (numpy arrays too).  A check reduces every
    field on the device into one small tensor and pulls it once: one host
    wait per check; ``every`` > 1 checks every ``every``-th call only
    (rollback then restores the last *validated* snapshot).  ``ncol``
    scales the default shortwave bound with the batch
    (:func:`errsol_bound`; on a mesh give the global count); an explicit
    ``errsol_max`` always wins.  With ``mesh`` each check is a collective
    (one MAX over the ranks), which every rank must call."""

    # sentinel default, so that an explicit errsol_max is never replaced
    # by the batch-scaled bound
    _ERRSOL_UNSET = object()

    def __init__(self, errh2o_max=0.1, errh2o_led_max=1e-9,
                 errh2osno_max=1e-6, errh2osno_steady_max=1e-7,
                 errsol_max=_ERRSOL_UNSET, errseb_max=None, every=1,
                 ncol=None, mesh=None):
        self.errh2o_max = errh2o_max
        # the closed ledger is exact to rounding: any excursion is a leak
        self.errh2o_led_max = errh2o_led_max
        self.errh2osno_max = errh2osno_max
        # the re-timed, transition-masked snow balance closes to ~1e-15
        # when healthy; 1e-7 leaves margin for batch-scaled rounding
        self.errh2osno_steady_max = errh2osno_steady_max
        self.errseb_max = errseb_max
        self.every = every
        self.ncol = ncol
        self.mesh = mesh
        if errsol_max is StepGuard._ERRSOL_UNSET:
            errsol_max = errsol_bound(ncol) if ncol is not None else 1e-6
        self.errsol_max = errsol_max
        self._snapshot = None
        self._step = 0
        self.failures: list[tuple[int, list[str]]] = []

    def snapshot(self, state) -> None:
        """Keep a device copy of ``state``'s primary variables."""
        self._snapshot = {k: v.clone()
                          for k, v in primary_vars(state).items()}

    def check(self, state, diags) -> GuardReport:
        """Validate the post-step state and diagnostics.

        Never mutates ``state``: on failure the report lists the tripped
        bounds and ``can_roll_back`` says whether a validated snapshot
        exists; the caller decides whether to recover by
        :meth:`restore_into`.  On success the state becomes the new
        validated snapshot."""
        self._step += 1
        if self.every > 1 and (self._step % self.every) != 0:
            return GuardReport(True, [], False)

        dev = state.t_grnd.device
        names, vals = [], [(~torch.isfinite(state.t_grnd)).any(),
                           (~(state.h2osno >= 0.0)).any()]
        for name in _ERR_CHECKS:
            bound = getattr(self, name + "_max")
            if bound is None:
                continue
            field = getattr(diags, name, getattr(diags, name + "_max", None))
            if field is None:
                continue
            names.append((name, bound))
            vals.append(torch.as_tensor(field, device=dev).abs().max())
        if self.mesh is not None and self.mesh.group is not None:
            from elmkernels_torch.parallel.reductions import combine
            vals = combine(self.mesh, maxima=vals)[0]
        pulled = torch.stack([v.to(torch.float64) for v in vals]).tolist()

        reasons = []
        if pulled[0]:
            reasons.append("non-finite t_grnd")
        if pulled[1]:
            reasons.append("negative h2osno")
        for (name, bound), v in zip(names, pulled[2:]):
            if not v <= bound:   # catches NaN too
                reasons.append(f"{name}={v:.3e} > {bound:g}")

        if reasons:
            self.failures.append((self._step, reasons))
            return GuardReport(False, reasons, self._snapshot is not None)
        self.snapshot(state)
        return GuardReport(True, [], False)

    def restore_into(self, state):
        """``state`` with its primary variables replaced by copies of the
        last validated snapshot (raises if none exists); the snapshot
        stays, so a retry may roll back to it again."""
        if self._snapshot is None:
            raise RuntimeError("no validated snapshot to restore")
        return state._replace(**{k: v.clone()
                                 for k, v in self._snapshot.items()})
