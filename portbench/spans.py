"""The program's own spans in a traced record.

``elmkernels_torch`` marks sections of its host work on the profiler's
clock, on the calling thread, as ``elm.<layer>.<what>`` host operations
(``elmkernels_torch/utils/clock.py``: ``span``).  A program without them
(before they were added) leaves none in the record, and the readers of
``metrics/`` that read them then read nothing."""

from __future__ import annotations


def ms_per_step(rec: dict, names) -> float | None:
    """Host milliseconds a step inside the spans called one of ``names``
    that lie inside the traced window, summed over the traced steps; None
    where the record holds none of them."""
    if not rec.get("window"):
        return None
    w0, w1 = rec["window"]
    total, n = 0.0, 0
    for name, a, b in rec["host"]:
        if name in names and w0 <= a and b <= w1:
            total += b - a
            n += 1
    return total / 1e3 / rec["steps"] if n else None
