"""K7's device milliseconds a step (``ops/soil_temperature.py`` +
``csrc/soil_temperature.cu``, the soil temperature module): every launch of
the kernel whose name holds ``soil_temperature_kernel`` in the traced call,
summed, over its steps.  A program without K7 reads nothing, and the
metric is left out."""

from portbench import trace


def read(rec: dict):
    ms, n = trace.device_ms(rec,
                            lambda name: "soil_temperature_kernel" in name)
    return ms / rec["steps"] if n else None
