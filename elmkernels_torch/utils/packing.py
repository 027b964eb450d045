"""Packed state carry: the state's ``[ncol, ...]`` fields held in one
contiguous ``[ncol, K]`` buffer per dtype, the fields views into it.

Counterpart of ``elmkernels_tpu/utils/packing.py``.  There, packing fuses
the scan carry so that XLA stages a few large buffers across the loop
boundary instead of ~41 small ones.  An eager loop has no scan carry to
stage; what packing gives it is a carry at fixed addresses: the state a
device loop hands from one step to the next lives in the same buffers for
the whole loop (:class:`PackedCarry`), which a CUDA graph of the step
needs.  Packing is ``reshape`` and ``cat``, unpacking slicing and
``view``, and a step's new fields are copied into the buffers once a step:
no arithmetic touches the values, and the results are bit for bit those of
the unpacked loop.

The column axis stays first, so a rank of a sharded model packs only its
own block.
"""

from __future__ import annotations

import torch

__all__ = ["pack_tree", "unpack_tree", "template_of", "PackedCarry"]


def _width(shape) -> int:
    """A field's trailing width (product of its non-column dims)."""
    k = 1
    for n in shape[1:]:
        k *= int(n)
    return k


def template_of(state) -> list:
    """``[(shape, dtype), ...]`` of a state's fields, in field order."""
    return [(tuple(a.shape), a.dtype) for a in state]


def _order(template) -> list:
    """The buffers' dtypes, in sorted dtype-name order."""
    return sorted({dt for _, dt in template}, key=str)


def pack_tree(state) -> tuple:
    """One ``[ncol, K]`` buffer per dtype (a copy), in sorted dtype-name
    order, holding a NamedTuple of ``[ncol, ...]`` tensors field after
    field."""
    groups: dict = {}
    for a in state:
        groups.setdefault(a.dtype, []).append(
            a.reshape(a.shape[0], _width(a.shape)))
    return tuple(torch.cat(groups[dt], dim=1)
                 for dt in _order(template_of(state)))


def unpack_tree(buffers: tuple, template, cls):
    """Inverse of :func:`pack_tree`: the NamedTuple ``cls`` whose fields
    are views into ``buffers`` (slice and reshape, no copy).  ``template``
    is :func:`template_of` of the packed state."""
    by_dtype = dict(zip(_order(template), buffers))
    offsets = dict.fromkeys(by_dtype, 0)
    leaves = []
    for shape, dt in template:
        k, off = _width(shape), offsets[dt]
        leaves.append(by_dtype[dt][:, off:off + k].view(shape))
        offsets[dt] = off + k
    return cls(*leaves)


def _is_view_of(t: torch.Tensor, slot: torch.Tensor) -> bool:
    """Whether ``t`` is ``slot`` itself: the same memory, shape and
    strides."""
    return (t.data_ptr() == slot.data_ptr() and t.shape == slot.shape
            and t.stride() == slot.stride() and t.dtype == slot.dtype)


class PackedCarry:
    """A device loop's state carry, packed: :attr:`state` is the state
    whose fields are views into :attr:`buffers`, and :meth:`update` copies
    a step's new state into them.  The buffers are allocated once, so the
    carry keeps its addresses for the whole loop."""

    def __init__(self, state):
        self.template = template_of(state)
        self.cls = type(state)
        self.buffers = pack_tree(state)
        self.state = unpack_tree(self.buffers, self.template, self.cls)
        # what the updates copied: their count and bytes
        self.updates = 0
        self.bytes_copied = 0

    def update(self, new) -> None:
        """Copy the fields of ``new``, a step's output from
        :attr:`state`, into the buffers; :attr:`state` then holds them.
        A field that still is its slot (a step that passes it through) is
        not copied; a field that is a view into the buffers elsewhere is
        read before any slot is written."""
        if type(new) is not self.cls:
            raise TypeError(f"{type(new).__name__} is not the carry's "
                            f"{self.cls.__name__}")
        ptrs = [(b.data_ptr(), b.data_ptr() + b.numel() * b.element_size())
                for b in self.buffers]
        pending = []
        for name, slot, t in zip(self.cls._fields, self.state, new):
            if (tuple(t.shape), t.dtype) != (tuple(slot.shape), slot.dtype):
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} does "
                                 f"not fit its slot {tuple(slot.shape)} "
                                 f"{slot.dtype}")
            if _is_view_of(t, slot):
                continue
            if any(lo <= t.data_ptr() < hi for lo, hi in ptrs):
                t = t.clone()
            pending.append((slot, t))
        for slot, t in pending:
            slot.copy_(t)
        self.updates += 1
        self.bytes_copied += sum(t.numel() * t.element_size()
                                 for _, t in pending)

    def nbytes_per_step(self, new) -> int:
        """Bytes :meth:`update` would copy for ``new``."""
        return sum(t.numel() * t.element_size()
                   for slot, t in zip(self.state, new)
                   if not _is_view_of(t, slot))
