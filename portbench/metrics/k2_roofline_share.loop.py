"""K2's share of its roofline (``ops/canopy.py`` +
``csrc/canopy_stability.cu``): the bound of one launch
(``rooflines/k2.py`` on the cell's shapes, traits and the traced steps'
canopy passes) over K2's mean device time a launch in the trace, in
percent."""

from portbench import trace

ROOFLINE = "k2"


def read(rec: dict):
    ms, n = trace.device_ms(rec, lambda name: "canopy_kernel" in name)
    bound = rec["bound_ms"]
    if not n or bound is None:
        return None
    return 100.0 * bound / (ms / n)
