"""``window_wait_ms_per_step.loop`` on rank 0 of a grid over cards: the
program's span ``elm.window.wait`` in the traced call, over its steps."""

from portbench import spans


def read(rec: dict):
    return spans.ms_per_step(rec, ("elm.window.wait",))
