"""Percent of the traced call in which no device operation ran: 1 minus
the union of the device intervals over the call's wall time."""

from portbench import trace


def read(rec: dict):
    return trace.idle_share(rec)
