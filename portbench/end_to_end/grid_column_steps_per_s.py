"""End-to-end: column-steps a second over a grid split over cards, the
same quantity as ``column_steps_per_s`` (the whole grid's column-steps
completed in the window over rank 0's wall time, host clock), under a
metric of its own: a grid over cards spreads more than a card alone, so
its cell reads the rate with its own bound."""


def read(measured: dict):
    return measured["column_steps_per_s"]
