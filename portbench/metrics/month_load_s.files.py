"""Seconds a month's load stalls the file-fed loop (forcing ingest:
``data/forcing.py`` ``NetCDFForcing``, ``io/native.py``,
``csrc/elmio.cc``): the longest call of the untraced window less the
median call, on the host clock.  Every call runs the same 48 steps on the
same shapes; the call that crosses into a month also waits for that
month's decode, where the loop's host thread does not hide it."""

import statistics


def read(rec: dict):
    calls = rec["measured"].get("calls_s")
    return max(calls) - statistics.median(calls) if calls else None
