"""Host calls that issue device work, a step of the time loop: the
CUDA runtime and driver API launches, copies and fills in the traced call
(a graph launch counts once), over its steps (``driver/graphs.py``)."""

from portbench import trace


def read(rec: dict):
    return trace.issues(rec) / rec["steps"] if rec.get("window") else None
