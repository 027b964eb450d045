"""``step_device_ms.loop`` of the file-fed loop: every kernel, copy and
fill of the traced call, summed, over its steps."""

from portbench import trace


def read(rec: dict):
    ms, n = trace.device_ms(rec)
    return ms / rec["steps"] if n else None
