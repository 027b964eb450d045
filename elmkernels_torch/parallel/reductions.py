"""Domain reductions across the ranks of a :class:`ColumnMesh`.

Counterpart of ``elmkernels_tpu/parallel/reductions.py`` (the reference's
MPI ``min_max_sum`` diagnostics, ``src/utils/utils.hh:45-103``).  Each
rank reduces its own columns on its device; the partial results meet by
``torch.distributed.all_reduce``: MIN and MAX (as a MIN of negated
maxima), SUM, and a mean as the global sum over the global count.  With no
mesh, or a mesh of no group, the reductions are the local ones.  None of
this runs inside the step: the model calls it once per step (``run``'s
callers) or once per window (the device loops).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class MinMaxSum(NamedTuple):
    min: torch.Tensor
    max: torch.Tensor
    sum: torch.Tensor


def _all_reduce(t: torch.Tensor, op, mesh) -> torch.Tensor:
    """``t`` reduced over the mesh's ranks by ``op`` (in place, on the
    mesh's device)."""
    t = t.to(mesh.device)
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def _grouped(mesh) -> bool:
    return mesh is not None and mesh.group is not None


def min_max_sum(x, mesh=None) -> MinMaxSum:
    """Global min, max and sum of a column tensor ``x`` (this rank's
    columns), as 0-d tensors: two collectives."""
    lo, hi, s = x.min(), x.max(), x.sum()
    if not _grouped(mesh):
        return MinMaxSum(lo, hi, s)
    mm = _all_reduce(torch.stack([lo, -hi]), dist.ReduceOp.MIN, mesh)
    s = _all_reduce(s.reshape(1).clone(), dist.ReduceOp.SUM, mesh)[0]
    return MinMaxSum(mm[0], -mm[1], s)


def min_max_mean(x, mesh=None) -> MinMaxSum:
    """:func:`min_max_sum` with the mean in the sum's place: the global
    sum over the global count of elements."""
    if not _grouped(mesh):
        return MinMaxSum(x.min(), x.max(), x.mean())
    mms = min_max_sum(x, mesh)
    n = _all_reduce(torch.tensor([float(x.numel())], dtype=torch.float64),
                    dist.ReduceOp.SUM, mesh)[0]
    return mms._replace(sum=(mms.sum.double() / n).to(x.dtype))


def combine(mesh, maxima=None, sums=None):
    """Global maxima and sums of per-rank partial results, stacked along
    a new leading axis (each input a tensor of one shape; float64
    results): one MAX and one SUM collective.  A NaN on any rank stays a
    NaN in the maximum, as in a local ``max`` (the collectives' MAX need
    not keep it)."""
    mx = sm = None
    if maxima is not None:
        mx = torch.stack([v.to(torch.float64) for v in maxima])
    if sums is not None:
        sm = torch.stack([v.to(torch.float64) for v in sums])
    if not _grouped(mesh):
        return mx, sm
    if mx is not None:
        nan = torch.isnan(mx)
        both = _all_reduce(torch.stack([torch.where(nan, -torch.inf, mx),
                                        nan.to(torch.float64)]),
                           dist.ReduceOp.MAX, mesh)
        mx = torch.where(both[1] > 0, torch.nan, both[0])
    if sm is not None:
        sm = _all_reduce(sm, dist.ReduceOp.SUM, mesh)
    return mx, sm


def global_means(mesh, fields):
    """The mean of each column field of ``fields`` over every rank's
    columns, as float64: local float64 sums, one SUM collective, over the
    global column count."""
    _, sums = combine(mesh, sums=[f.sum(dtype=torch.float64)
                                  for f in fields])
    ncol = mesh.ncol_global if mesh is not None else fields[0].shape[0]
    return sums / ncol
