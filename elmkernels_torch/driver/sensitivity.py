"""Forward-mode sensitivities through the full coupled water+energy step:
the tangent-linear model.

Counterpart of ``elmkernels_tpu/driver/sensitivity.py``: ``jax.jvp``
becomes ``torch.func.jvp`` over the steps of a window.  The step is plain
PyTorch but for its two kernels on the card, which it reaches through
``torch.autograd.Function``\\ s with a forward-mode rule: the ci solve's
``jvp`` launches the tangent kernel (K1-T, the solve on (value, tangent)
pairs, which carries the tangent through every secant and Brent iterate as
``jax.jvp`` of the masked while_loops does), the pentadiagonal solve's
launches K4 again for dx = A^-1 (db - dA x).  On the CPU the tangents flow
through the plain versions.

``torch.func.jvp`` differentiates floating tensors only, so the parameters
and the forcing window are split into their floating fields, which are
differentiated (with zero tangents where unseeded), and the rest (the
integer PFT and landunit indices, absent aerosol fields), which are closed
over: the counterpart of JAX's ``float0`` tangents.

Uses: flux sensitivities to forcing (dSH/dTbot, the land-atmosphere
coupling strength), parameter sensitivities and calibration Jacobians
(d(fluxes)/d(soil porosity)), tangent-linear runs for data assimilation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from elmkernels_torch.data.state import StepForcing, StepPhenology
from elmkernels_torch.driver import step as step_mod
from elmkernels_torch.utils.dates import Date


class SensitivityResult(NamedTuple):
    """Primal trajectory and its directional derivative.

    ``diags``/``d_diags`` are :class:`StepDiagnostics` with a leading
    ``[nsteps]`` axis; ``state``/``d_state`` are the final
    :class:`ModelState` and its tangent (integer fields: zero)."""
    state: object
    diags: object
    d_state: object
    d_diags: object


def _floating(nt) -> dict:
    return {k: v for k, v in nt._asdict().items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()}


def _zero_tangent(nt):
    """``nt`` with zeros for its floating tensors and ``None`` elsewhere:
    the tangent a seed function fills in."""
    return type(nt)(*(torch.zeros_like(v) if isinstance(v, torch.Tensor)
                      and v.is_floating_point() else None for v in nt))


def seed_field(name: str, value=1.0):
    """Seed helper: a tangent of ``value`` in every element of the forcing
    or parameter field ``name``.

    ``seed_forcing=seed_field("tbot")`` gives d/dT_atm (the forcing window
    holds the two bracketing samples ``[nsteps, 2, ncol]``; both are
    seeded, a constant offset of the series);
    ``seed_params=seed_field("watsat")`` a soil-porosity direction."""
    def seed(primal, zeros):
        return zeros._replace(**{name: torch.full_like(getattr(primal, name),
                                                       value)})
    return seed


def trajectory(model, forc_stack: StepForcing, phen_stack: StepPhenology,
               params=None):
    """Run the ``[nsteps]``-stacked inputs from ``model.state`` with the
    step's default flags (the reference-exact ones, as the JAX package's
    ``run_jvp`` runs them); returns the final state and the stacked
    :class:`StepDiagnostics`.  Leaves ``model.state`` as it was."""
    params = model.params if params is None else params
    state, diags = model.state, []
    for k in range(forc_stack.tbot.shape[0]):
        f = StepForcing(*(None if v is None else v[k] for v in forc_stack))
        p = StepPhenology(*(v[k] for v in phen_stack))
        state, d = step_mod.advance(model.land, model.psnveg, model.albveg,
                                    model.snicar, params, state, f, p,
                                    model.dtime)
        diags.append(d)
    return state, type(diags[0])(*(torch.stack(v) for v in zip(*diags)))


def run_jvp(model, start: Date, nsteps: int,
            seed_forcing: Callable | None = None,
            seed_params: Callable | None = None,
            forc_stack=None, phen_stack=None) -> SensitivityResult:
    """Run ``nsteps`` from ``start`` and return the trajectory and its
    directional derivative along a perturbation direction.

    The direction is given by ``seed_*(primal, zeros) -> tangent``
    callables, ``zeros`` being the all-zero tangent of ``primal`` (see
    :func:`seed_field`); the run computes d(outputs)/d(eps)
    for ``forcing + eps*tangent_f``, ``params + eps*tangent_p`` at eps=0 in
    one forward pass.  Does NOT mutate ``model.state``.  ``forc_stack``/
    ``phen_stack`` override the assembled windows (e.g. for a
    finite-difference check against a perturbed trajectory)."""
    if forc_stack is None or phen_stack is None:
        forc_stack, phen_stack = model.stack_windows(start, nsteps)
    promote = model._promote
    forc_stack = StepForcing(*(None if v is None else promote(v)
                               for v in forc_stack))
    phen_stack = StepPhenology(*(promote(v) for v in phen_stack))

    d_forc = _zero_tangent(forc_stack)
    if seed_forcing is not None:
        d_forc = seed_forcing(forc_stack, d_forc)
    d_params = _zero_tangent(model.params)
    if seed_params is not None:
        d_params = seed_params(model.params, d_params)

    pf, ff = _floating(model.params), _floating(forc_stack)

    def run(pf, ff):
        return trajectory(model, forc_stack._replace(**ff), phen_stack,
                          model.params._replace(**pf))

    (fin, diags), (d_fin, d_diags) = torch.func.jvp(
        run, (pf, ff), ({k: getattr(d_params, k) for k in pf},
                        {k: getattr(d_forc, k) for k in ff}))
    return SensitivityResult(fin, diags, d_fin, d_diags)
