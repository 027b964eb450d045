"""Device milliseconds a step in the ranks' collectives (``parallel/
reductions.py`` ``combine``, which ``driver/model.py`` ``_global_diags``
calls once a window): every NCCL kernel on rank 0's card in the traced
call (``ncclDevKernel_AllReduce_Sum_f64_RING_LL`` on an H100 with NCCL
2.28; the profiler's ``nccl:all_reduce`` annotation over it is not device
work, ``trace.device_work``), summed, over its steps.  An NCCL kernel spins
until its peers have arrived, so this reads the collectives and the ranks'
skew together.  A group of one rank launches none, and reads nothing."""

from portbench import trace


def read(rec: dict):
    ms, n = trace.device_ms(rec, lambda name: "nccl" in name.lower())
    return ms / rec["steps"] if n else None
