"""The mean of the coupled steps' times in the untraced window
(``driver/interface.py`` and the step it drives), by the host's clock:
each step from the host's first work on its forcing to the exchange fluxes
back.  It stands beside the end-to-end 95th percentile: a shift of every
step moves both, a few slow stretches only the tail."""


def read(rec: dict):
    return rec["measured"]["coupled_step_ms_mean"]
