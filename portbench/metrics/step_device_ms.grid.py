"""``step_device_ms.loop`` on rank 0's card of a grid over cards: every
device operation of the traced call, its collectives' kernels with them
(``collective_ms_per_step.shard``), summed, over its steps."""

from portbench import trace


def read(rec: dict):
    ms, n = trace.device_ms(rec)
    return ms / rec["steps"] if n else None
