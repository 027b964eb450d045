"""Forward-mode differentiation around the port's CUDA kernels.

A kernel launched through ``ctypes`` reads raw pointers and writes fresh
tensors, so under ``torch.func.jvp`` (or ``torch.autograd.forward_ad``) its
outputs would carry no tangent and the sensitivity would be lost without a
word.  So each kernel wrapper refuses a tensor that carries a tangent
(:func:`refuse`), and the step reaches the kernels through
``torch.autograd.Function``\\ s whose ``jvp`` launches the tangent kernel
(``ops.ci_solver.CiSolve``, ``ops.pdma.PdmaSolve``).  Inside a ``jvp`` the
saved tensors and tangents are wrapped by the transform; :func:`primal`
takes their plain values and :func:`plain_dispatch` runs the launch outside
the transform, so that the kernel sees tensors with storage.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.forward_ad as fwAD
from torch._C import _functorch


def carries_tangent(t: torch.Tensor) -> bool:
    """Whether ``t`` is differentiated through: it requires grad, carries
    a forward-mode tangent, or is wrapped by a ``torch.func`` transform."""
    return (t.requires_grad or _functorch.is_functorch_wrapped_tensor(t)
            or (fwAD._current_level >= 0
                and fwAD.unpack_dual(t).tangent is not None))


def refuse(name: str, function: str, tensors,
           instead: str = "whose jvp launches the tangent kernel") -> None:
    """Raise if a tensor handed to the kernel wrapper ``name`` carries a
    tangent: the kernel would drop it.  The message names ``function``,
    the entry point to call, and what it does ``instead``."""
    if any(carries_tangent(t) for t in tensors):
        raise RuntimeError(
            f"{name} launches a CUDA kernel that propagates no tangent, and "
            f"a tensor given to it is being differentiated: call "
            f"{function}, {instead}")


def primal(t: torch.Tensor | None) -> torch.Tensor | None:
    """The plain tensor under ``t``: unwrapped from every ``torch.func``
    level, without its forward-mode tangent."""
    if t is None:
        return None
    while _functorch.is_functorch_wrapped_tensor(t):
        t = _functorch.get_unwrapped(t)
    # outside the transform, or unpacking would wrap the result again
    with plain_dispatch():
        return fwAD.unpack_dual(t).primal


@contextlib.contextmanager
def plain_dispatch():
    """Run the body outside any active ``torch.func`` transform, so that
    the tensors it makes are plain (with storage)."""
    from torch._functorch.pyfunctorch import \
        temporarily_clear_interpreter_stack
    with temporarily_clear_interpreter_stack():
        yield
