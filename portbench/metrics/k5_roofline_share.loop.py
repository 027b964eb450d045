"""K5's share of its roofline (``ops/snow.py`` +
``csrc/snow_hydrology.cu``): the bound of one launch (``rooflines/k5.py``
on the cell's shapes; its melting layers are not seen from outside the
step and count 0, so the bound is low where snow melts, by at most one
element a snow layer at the traced call's start, which the run prints)
over K5's mean device time a launch in the trace, in percent."""

from portbench import trace

ROOFLINE = "k5"


def read(rec: dict):
    ms, n = trace.device_ms(rec, lambda name: "snow_kernel" in name)
    bound = rec["bound_ms"]
    if not n or bound is None:
        return None
    return 100.0 * bound / (ms / n)
