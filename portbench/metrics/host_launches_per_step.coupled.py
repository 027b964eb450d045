"""Host calls that issue device work, a coupled step
(``driver/interface.py`` and the step it drives eagerly): the CUDA runtime
and driver API launches, copies and fills in the traced steps, over
them."""

from portbench import trace


def read(rec: dict):
    return trace.issues(rec) / rec["steps"] if rec.get("window") else None
