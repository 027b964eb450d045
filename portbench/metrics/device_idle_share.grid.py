"""``device_idle_share.loop`` on rank 0's card of a grid over cards:
percent of the traced call in which no device operation ran."""

from portbench import trace


def read(rec: dict):
    return trace.idle_share(rec)
