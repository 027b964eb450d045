"""A rank's block of the column axis, and cutting global trees to it.

Counterpart of ``elmkernels_tpu/parallel/mesh.py``.  Where the JAX package
places one global array over a device mesh, a :class:`ColumnMesh` holds
one rank's share: its process group, its ``(lo, hi)`` column range
(``utils/domain.py:rank_block``, never padded) and its device.  Run one
rank per device, e.g. ``torchrun --nproc-per-node N``; rank ``r`` takes
``cuda:{LOCAL_RANK % device_count}``, or the CPU when asked for.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from elmkernels_torch.utils.domain import rank_block


@dataclasses.dataclass(frozen=True)
class ColumnMesh:
    """One rank's block of ``ncol_global`` columns that start at column
    ``col0_global`` of the grid.  ``group`` is the process group the
    diagnostics reduce over (None: one process, no collective)."""
    group: object
    rank: int
    nranks: int
    ncol_global: int
    col0_global: int
    lo: int
    hi: int
    device: torch.device

    @property
    def ncol(self) -> int:
        """This rank's columns: ``Model(ncol=mesh.ncol, ...)``."""
        return self.hi - self.lo

    @property
    def col0(self) -> int:
        """This rank's first column on the grid: ``Model(col0=...)``."""
        return self.col0_global + self.lo

    def cut(self, x, axis: int = 0):
        """This rank's columns of ``x`` (numpy or torch, global along
        ``axis``) as a tensor on the rank's device."""
        if np.shape(x)[axis] != self.ncol_global:
            raise ValueError(f"axis {axis} of shape {tuple(np.shape(x))} "
                             f"is not the {self.ncol_global} columns")
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        return t.narrow(axis, self.lo, self.ncol).to(self.device).clone()


def _device_of_rank(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("a sharded rank runs on a CUDA device and none "
                           "is available; pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def column_mesh(ncol: int, col0: int = 0, group=None,
                device=None) -> ColumnMesh:
    """This rank's :class:`ColumnMesh` of ``ncol`` columns starting at grid
    column ``col0``.  ``group`` defaults to the initialised default group
    (``torch.distributed.init_process_group``); with none initialised the
    mesh is one rank over every column.  ``device=None`` is this rank's
    card; a rank whose block is empty is refused."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    rank = dist.get_rank(group) if group is not None else 0
    nranks = dist.get_world_size(group) if group is not None else 1
    lo, hi = rank_block(ncol, nranks, rank)
    return ColumnMesh(group=group, rank=rank, nranks=nranks,
                      ncol_global=ncol, col0_global=col0, lo=lo, hi=hi,
                      device=_device_of_rank(device))


def _map(tree, fn):
    """``fn`` on every array leaf of a (nested) tuple; None and Python
    scalars pass through."""
    from elmkernels_torch.driver.model import _map as map_leaves
    return map_leaves(tree, (torch.Tensor, np.ndarray), fn)


def _whole(mesh: ColumnMesh, x):
    return torch.as_tensor(x).to(mesh.device)


def shard_state(mesh: ColumnMesh, state):
    """A global ModelState ([ncol_global, ...] fields) cut to this rank's
    columns, on its device."""
    return _map(state, mesh.cut)


def shard_params(mesh: ColumnMesh, params, ncol: int | None = None):
    """Per-column parameter arrays (leading axis of ``ncol``, default the
    mesh's global count) cut to this rank's columns; lookup tables and
    scalars kept whole; all on the rank's device."""
    ncol = mesh.ncol_global if ncol is None else ncol

    def place(x):
        if np.ndim(x) >= 1 and np.shape(x)[0] == ncol:
            return mesh.cut(x)
        return _whole(mesh, x)
    return _map(params, place)


def shard_forcing(mesh: ColumnMesh, forc, ncol: int | None = None):
    """A StepForcing: [ncol] arrays cut on axis 0, [k, ncol] arrays (the
    [2, ncol] brackets, the [11, ncol] deposition rates) on axis 1, scalar
    weights kept whole; all on the rank's device."""
    ncol = mesh.ncol_global if ncol is None else ncol

    def place(x):
        if np.ndim(x) == 1 and np.shape(x)[0] == ncol:
            return mesh.cut(x)
        if np.ndim(x) == 2 and np.shape(x)[1] == ncol:
            return mesh.cut(x, axis=1)
        return _whole(mesh, x)
    return _map(forc, place)
