"""Checkpoint and restore of the model state.

Counterpart of ``elmkernels_tpu/utils/checkpoint.py``.  The reference has
no checkpoint files; its ``PrimaryVars`` snapshot (``elm_state.h:15-48``)
names the minimal prognostic set, which :class:`ModelState` supersets.
Here the whole state is written by ``torch.save`` as a dict of tensors and
read back by ``torch.load(weights_only=True)`` onto the model's device.

The files are PyTorch's, not orbax's: a checkpoint of the JAX package
cannot be read here, nor one of the port there.
"""

from __future__ import annotations

import pathlib

import torch

from elmkernels_torch.data.state import ModelState

# the reference's PrimaryVars restart subset (elm_state.h:17-48)
PRIMARY_VARS = ("snl", "snow_depth", "frac_sno", "int_snow", "snw_rds",
                "h2osoi_liq", "h2osoi_ice", "h2osoi_vol", "h2ocan", "h2osno",
                "h2osfc", "t_soisno", "t_grnd", "t_h2osfc", "dz", "z", "zi")


def save(path, state: ModelState) -> None:
    """Write ``state`` to the file ``path`` (its directory is made)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state._asdict(), path)


def restore(path, like: ModelState | None = None,
            device=None) -> ModelState:
    """Read a checkpoint onto ``device`` (default: ``like``'s device, else
    the CPU).  With ``like``, every field must have its shape and dtype."""
    if device is None:
        device = like.t_grnd.device if like is not None else "cpu"
    data = torch.load(path, map_location=device, weights_only=True)
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
