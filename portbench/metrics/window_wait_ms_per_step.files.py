"""``window_wait_ms_per_step.loop`` of the file-fed loop: the program's
span ``elm.window.wait`` (the main thread's wait for the next window's
payload, which the host thread assembles from the month files) in the
traced call, over its steps."""

from portbench import spans


def read(rec: dict):
    return spans.ms_per_step(rec, ("elm.window.wait",))
