"""Host milliseconds a coupled step in which ``advance_with_forcing``
(``driver/interface.py``) waits for the card and copies the exchange
fluxes back to the host: the program's span ``elm.coupled.exchange`` in
the traced steps, over them."""

from portbench import spans


def read(rec: dict):
    return spans.ms_per_step(rec, ("elm.coupled.exchange",))
