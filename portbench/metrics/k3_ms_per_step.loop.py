"""K3's device milliseconds a step (``ops/snicar.py`` +
``csrc/snow_snicar.cu``, SNICAR's sweep): every launch of the kernel whose
name holds ``snicar_kernel`` in the traced call, summed, over its steps.
A program without K3 reads nothing, and the metric is left out."""

from portbench import trace


def read(rec: dict):
    ms, n = trace.device_ms(rec, lambda name: "snicar_kernel" in name)
    return ms / rec["steps"] if n else None
