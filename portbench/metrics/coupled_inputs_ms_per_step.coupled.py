"""Host milliseconds a coupled step in which ``advance_with_forcing``
(``driver/interface.py``) builds the step's inputs from the host's arrays
and copies them to the device: the program's spans ``elm.coupled.inputs``
and ``elm.coupled.copy_in`` in the traced steps, over them."""

from portbench import spans


def read(rec: dict):
    return spans.ms_per_step(rec, ("elm.coupled.inputs",
                                   "elm.coupled.copy_in"))
