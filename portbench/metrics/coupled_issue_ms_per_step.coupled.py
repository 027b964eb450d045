"""Host milliseconds a coupled step in which ``advance_with_forcing``
(``driver/interface.py``) issues the eager step, with any wait for the
card inside it: the program's span ``elm.coupled.step`` in the traced
steps, over them."""

from portbench import spans


def read(rec: dict):
    return spans.ms_per_step(rec, ("elm.coupled.step",))
