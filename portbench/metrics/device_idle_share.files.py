"""``device_idle_share.loop`` of the file-fed loop: percent of the traced
call in which no device operation ran."""

from portbench import trace


def read(rec: dict):
    return trace.idle_share(rec)
