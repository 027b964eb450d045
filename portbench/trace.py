"""The traced run's record and the arithmetic the per-layer readers share.

:func:`record` runs a callable under ``torch.profiler`` (CPU and CUDA
activities) inside a range of the harness's own and returns a plain dict:

- ``device``: every kernel, copy and fill on the device, ``[name, start,
  end]`` in microseconds on the profiler's clock;
- ``host``: every event on the host (torch operations, runtime and driver
  calls, the harness's ranges), the same way;
- ``window``: ``[start, end]`` of the harness's range around the traced
  call, which ends once the card has finished;
- ``steps``: the steps the traced call ran.

The readers in ``metrics/`` take such a record (with what the harness adds
to it) and return a number, or None where there is nothing to read."""

from __future__ import annotations

import collections

RANGE = "portbench.traced"
# host calls that issue device work: the CUDA runtime and driver API
# launches, asynchronous copies and fills (a graph launch counts once)
_ISSUES = ("Launch", "Memcpy", "Memset")


def record(fn) -> dict:
    """``fn()`` under the profiler; ``fn`` must end with the card idle and
    return a dict that counts the ``steps`` it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(RANGE):
            out = fn()
    device, host, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a range shows on the device timeline too, as an annotation
            # over its kernels: not device work
            if not e.name.startswith("portbench."):
                device.append([e.name, a, b])
        else:
            if e.name == RANGE:
                window = [a, b]
            host.append([e.name, a, b])
    return dict(device=device, host=host, window=window,
                steps=out["steps"], out=out)


def merged(intervals) -> list:
    """The union of ``intervals`` as sorted disjoint [start, end] pairs."""
    out = []
    for a, b in sorted((a, b) for a, b in intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clipped(rec: dict) -> list:
    """The device intervals inside the traced window."""
    w0, w1 = rec["window"]
    return [[max(a, w0), min(b, w1)] for _, a, b in rec["device"]
            if b > w0 and a < w1]


def busy_us(rec: dict) -> float:
    """Microseconds of the window in which some device operation ran."""
    return sum(b - a for a, b in merged(clipped(rec)))


def window_us(rec: dict) -> float:
    w0, w1 = rec["window"]
    return w1 - w0


def idle_share(rec: dict) -> float | None:
    """Percent of the window in which no device operation ran."""
    if not rec.get("window") or window_us(rec) <= 0 or not rec["device"]:
        return None
    return 100.0 * (1.0 - busy_us(rec) / window_us(rec))


def issues(rec: dict) -> int:
    """Host calls that issued device work inside the window."""
    w0, w1 = rec["window"]
    return sum(1 for name, a, _ in rec["host"]
               if name.startswith("cu") and w0 <= a <= w1
               and any(k in name for k in _ISSUES))


def device_ms(rec: dict, match=lambda name: True) -> tuple[float, int]:
    """(device milliseconds, operations) of the device operations whose
    name ``match`` accepts."""
    ms, n = 0.0, 0
    for name, a, b in rec["device"]:
        if match(name):
            ms += (b - a) / 1e3
            n += 1
    return ms, n


def is_copy(name: str) -> bool:
    """A copy between host and device."""
    return "Memcpy" in name and ("HtoD" in name or "DtoH" in name)


def top_device_ops(rec: dict, k: int = 10) -> list:
    """The ``k`` device operation names that took most time: [[name,
    seconds]]."""
    total = collections.Counter()
    for name, a, b in rec["device"]:
        total[name[:120]] += (b - a) / 1e6
    return [[n, s] for n, s in total.most_common(k)]


def idle_gaps(rec: dict, k: int = 10, longest: int = 2000) -> list:
    """The idle stretches of the device inside the window, by what the host
    was doing in the middle of each (the shortest host event around that
    moment other than the harness's range): [[what, seconds]], the ``k``
    largest totals over the ``longest`` gaps."""
    import numpy as np
    if not rec.get("window"):
        return []
    w0, w1 = rec["window"]
    busy = merged(clipped(rec))
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    host = [h for h in rec["host"] if h[0] != RANGE]
    if not host:
        return []
    names = [h[0] for h in host]
    st = np.array([h[1] for h in host])
    en = np.array([h[2] for h in host])
    total = collections.Counter()
    for a, b in gaps[:longest]:
        mid = 0.5 * (a + b)
        inside = np.nonzero((st <= mid) & (en >= mid))[0]
        what = ("nothing traced" if not len(inside) else
                names[inside[np.argmin((en - st)[inside])]][:120])
        total[what] += (b - a) / 1e6
    return [[n, s] for n, s in total.most_common(k)]
