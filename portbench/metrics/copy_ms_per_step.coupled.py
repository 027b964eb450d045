"""Device milliseconds of the copies between host and device a coupled
step (``driver/interface.py``: the forcing in, the exchange fluxes out)."""

from portbench import trace


def read(rec: dict):
    ms, n = trace.device_ms(rec, trace.is_copy)
    return ms / rec["steps"] if n else None
