"""``host_cpu_ms_per_step.loop`` on rank 0 of a grid over cards: its
process's CPU time, all threads, over the measured window's steps."""


def read(rec: dict):
    m = rec["measured"]
    return 1e3 * m["cpu_s"] / m["steps"]
