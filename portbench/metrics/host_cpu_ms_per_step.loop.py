"""Host CPU milliseconds a step of the time loop (``driver/model.py``
``run_windows``, ``_host_series``): the process's CPU time, all threads,
over the measured window's steps, which run before the profiler starts
(the profiler slows the host), over those steps."""


def read(rec: dict):
    m = rec["measured"]
    return 1e3 * m["cpu_s"] / m["steps"]
