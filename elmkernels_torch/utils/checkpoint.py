"""Checkpoint and restore of the model state.

Counterpart of ``elmkernels_tpu/utils/checkpoint.py``.  The reference has
no checkpoint files; its ``PrimaryVars`` snapshot (``elm_state.h:15-48``)
names the minimal prognostic set, which :class:`ModelState` supersets.
Here the whole state is written by ``torch.save`` as a dict of tensors and
read back by ``torch.load(weights_only=True)`` onto the model's device.

The files are PyTorch's, not orbax's: a checkpoint of the JAX package
cannot be read here, nor one of the port there.

A sharded model (given its :class:`~elmkernels_torch.parallel.ColumnMesh`)
writes one file per rank, ``<path>.rank<r>-of-<n>``, which records the
rank's ``col0``, ``ncol`` and the number of ranks; a restore on a mesh
reads its rank's file and refuses one written for another block, and an
unsharded restore refuses a rank's file (and the other way round).
"""

from __future__ import annotations

import pathlib

import torch

from elmkernels_torch.data.state import ModelState
from elmkernels_torch.utils.device import resolve_device

# the reference's PrimaryVars restart subset (elm_state.h:17-48)
PRIMARY_VARS = ("snl", "snow_depth", "frac_sno", "int_snow", "snw_rds",
                "h2osoi_liq", "h2osoi_ice", "h2osoi_vol", "h2ocan", "h2osno",
                "h2osfc", "t_soisno", "t_grnd", "t_h2osfc", "dz", "z", "zi")


_SHARD_KEY = "__shard__"


def _shard(mesh) -> dict | None:
    """What a rank's checkpoint records of its block (None unsharded)."""
    if mesh is None:
        return None
    return {"col0": mesh.col0, "ncol": mesh.ncol, "nranks": mesh.nranks}


def shard_path(path, mesh=None) -> pathlib.Path:
    """The file of ``mesh``'s rank for checkpoint ``path``."""
    path = pathlib.Path(path)
    if mesh is None:
        return path
    return path.with_name(f"{path.name}.rank{mesh.rank}-of-{mesh.nranks}")


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where it is a view into a larger buffer (a
    packed carry's, ``utils/packing.py``): ``torch.save`` writes a view's
    whole storage, and the file holds each field on its own."""
    whole = (t.is_contiguous() and t.storage_offset() == 0
             and t.untyped_storage().nbytes() == t.numel() * t.element_size())
    return t if whole else t.clone(memory_format=torch.contiguous_format)


def save(path, state: ModelState, mesh=None) -> None:
    """Write ``state`` to the file ``path`` (its directory is made); on a
    mesh, this rank's block to its own file, :func:`shard_path`."""
    path = shard_path(path, mesh)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = {k: _own(v) for k, v in state._asdict().items()}
    if mesh is not None:
        data[_SHARD_KEY] = _shard(mesh)
    torch.save(data, path)


def restore(path, like: ModelState | None = None, device=None,
            mesh=None) -> ModelState:
    """Read a checkpoint onto ``device`` (default: ``like``'s device, else
    the card, as ``Model`` resolves it: pass ``device="cpu"`` for the
    CPU); on a mesh this rank's file, which must have been written for the
    same block.  With ``like``, every field must have its shape and
    dtype."""
    if device is None:
        device = (like.t_grnd.device if like is not None
                  else resolve_device(None))
    path = shard_path(path, mesh)
    data = torch.load(path, map_location=device, weights_only=True)
    written = data.pop(_SHARD_KEY, None)
    if written != _shard(mesh):
        raise ValueError(f"checkpoint {path} was written for block "
                         f"{written}, not this one, {_shard(mesh)} "
                         f"(None: unsharded)")
    missing = set(ModelState._fields) - set(data)
    unknown = set(data) - set(ModelState._fields)
    if missing or unknown:
        raise ValueError(f"checkpoint {path}: missing fields "
                         f"{sorted(missing)}, unknown fields "
                         f"{sorted(unknown)}")
    state = ModelState(**data)
    if like is not None:
        bad = [k for k in ModelState._fields
               if getattr(state, k).shape != getattr(like, k).shape
               or getattr(state, k).dtype != getattr(like, k).dtype]
        if bad:
            raise ValueError(f"checkpoint {path} does not fit the model: "
                             f"fields {bad} differ in shape or dtype")
    return state


def primary_vars(state: ModelState) -> dict:
    """The reference's PrimaryVars restart subset (``elm_state.h:17-48``),
    for host-model (ATS-style) snapshot and exchange."""
    return {k: getattr(state, k) for k in PRIMARY_VARS}
