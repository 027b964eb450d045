"""End-to-end: column-steps a second of the file-fed loop, the same
quantity as ``column_steps_per_s`` (every column-step completed in the
window over its whole wall time, host clock), under a metric of its own:
a month's decode runs at the host's speed, so this rate spreads more than
the loop's on pre-staged forcing, and has its own bound."""


def read(measured: dict):
    return measured["column_steps_per_s"]
