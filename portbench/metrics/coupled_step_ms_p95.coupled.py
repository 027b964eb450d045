"""The 95th percentile of the coupled steps' times in the untraced window
(``statistics.quantiles``, n=20, over every step), by the host's clock:
each step from the host's first work on its forcing to the exchange fluxes
back.  The tail of one closed-loop caller on a shared host swings from run
to run by more than any bound could hold, so it stands beside the cell's
rate as a reading of its layer, with the mean: a shift of every step moves
both, a few slow stretches only the tail."""


def read(rec: dict):
    return rec["measured"]["coupled_step_ms_p95"]
