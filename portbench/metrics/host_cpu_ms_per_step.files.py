"""``host_cpu_ms_per_step.loop`` of the file-fed loop: the process's CPU
time, all threads, over the untraced window's steps, the native reader's
decode of the month files included, hidden or not."""


def read(rec: dict):
    m = rec["measured"]
    return 1e3 * m["cpu_s"] / m["steps"]
