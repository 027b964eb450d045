"""Host milliseconds the time loop's main thread spends on each replayed
step (``driver/model.py`` ``_run_steps``, ``driver/graphs.py``): the
inputs' gather, the copies into the graph's buffers, the graph's launch,
the reductions' row copy and the poll for the next window, with any wait
inside them: the program's span ``elm.window.step`` in the traced call,
over its steps."""

from portbench import spans


def read(rec: dict):
    return spans.ms_per_step(rec, ("elm.window.step",))
