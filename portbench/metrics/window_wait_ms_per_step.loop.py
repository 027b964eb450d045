"""Host milliseconds a step in which the time loop's main thread
(``driver/model.py`` ``run_windows``) waits for the host thread's next
window payload: the program's span ``elm.window.wait``, opened once a
window, in the traced call, over its steps."""

from portbench import spans


def read(rec: dict):
    return spans.ms_per_step(rec, ("elm.window.wait",))
