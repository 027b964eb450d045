"""Where the time of one step of the port goes on the card.

    python -m elmkernels_torch.tools.profile_step [--ncol 262144] [--steps 4]
        [--out profile.json]

Builds ``Model(ncol)`` with the production flags from synthetic parameter
files (written under ``build/synthetic``), runs two warm-up summer steps,
then ``--steps`` steps under ``torch.profiler`` (CPU and CUDA activities).
Prints one JSON line, and writes it to ``--out`` when given:

- ``ms_per_step``: host clock over the window, ending in a synchronize;
- ``device_busy_share``: the union of the kernels' and copies' device
  intervals over the window's wall time (the rest is the card idle, waiting
  on the host);
- ``launches_per_step`` and ``device_ms_per_step`` by kernel name (top 20)
  and in all;
- ``syncs_per_step``: the host waits on the card the CUDA runtime recorded
  (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``), with ``copies_h2d_per_step``;
- ``canopy_iters_per_step``: the canopy loop's iterations, each ending in
  one ``.any()`` test on the host;
- ``phases``: host and device milliseconds per step of the step's inputs
  (forcing, phenology and their copies to the card) and of its three
  phases, each wrapped here in a ``record_function`` range (a kernel counts
  for the range whose device span it starts in);
- ``port_kernels``: device milliseconds and launches per step of the
  port's own CUDA kernels.

Needs a CUDA card; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import sys
import time

_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize")
_PHASES = ("step_inputs", "surface_phase", "flux_phase", "column_phase")
_PORT_KERNELS = ("ci_hybrid_kernel", "pdma_kernel")


def _ranged(fn, name):
    """``fn`` inside a profiler range called ``name``."""
    import functools

    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=262144)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver import step as step_mod
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date

    for name in _PHASES[1:]:
        setattr(step_mod, name, _ranged(getattr(step_mod, name), name))
    Model.step_inputs = _ranged(Model.step_inputs, "step_inputs")

    repo = pathlib.Path(__file__).resolve().parents[2]
    files = repo / "build" / "synthetic"
    files.mkdir(parents=True, exist_ok=True)
    pft, snicar = files / "clm_params.nc", files / "snicar_optics.nc"
    synthetic.write_clm_params(pft)
    synthetic.write_snicar_optics(snicar)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]

    model = Model(ncol=args.ncol, pft_path=str(pft), snicar_path=str(snicar))
    # noon of July 1 (step 24), after two warm-up steps
    date = Date.from_ymd(1985, 7, 1)
    date.increment_seconds(22 * 1800)
    for _ in range(2):
        model.advance(date)
        date.increment_seconds(1800)
    torch.cuda.synchronize()

    iters = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            d = model.advance(date)
            iters.append(d.niters_canopy)
            date.increment_seconds(1800)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = args.steps

    dev_ms = collections.Counter()
    launches = collections.Counter()
    intervals = []
    syncs = h2d = 0
    phases = {k: dict(host_ms_per_step=0.0, device_ms_per_step=0.0)
              for k in _PHASES}
    # a range shows twice: on the host, and as an annotation spanning its
    # kernels on the device timeline, which is not device work itself
    spans = []
    for e in prof.events():
        if e.name in phases:
            if e.device_type == DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end, e.name))
            else:
                phases[e.name]["host_ms_per_step"] += (
                    e.cpu_time_total / 1e3 / n)
        elif e.device_type == DeviceType.CUDA:
            dev_ms[e.name] += (e.time_range.end - e.time_range.start) / 1e3
            launches[e.name] += 1
            intervals.append((e.time_range.start, e.time_range.end))
            h2d += "HtoD" in e.name
        elif e.name in _SYNCS:
            syncs += 1
    for a, b in intervals:
        for lo, hi, name in spans:
            if lo <= a < hi:
                phases[name]["device_ms_per_step"] += (b - a) / 1e3 / n
                break
    busy_us = _union_us(intervals)
    top = sorted(dev_ms, key=dev_ms.get, reverse=True)[:20]
    res = dict(
        device=torch.cuda.get_device_name(0), card=card, ncol=args.ncol,
        steps=n, ms_per_step=wall / n * 1e3,
        columns_per_s=args.ncol * n / wall,
        device_busy_share=busy_us / (wall * 1e6),
        device_ms_per_step=sum(dev_ms.values()) / n,
        launches_per_step=sum(launches.values()) / n,
        syncs_per_step=syncs / n, copies_h2d_per_step=h2d / n,
        canopy_iters_per_step=[int(i.max().item()) for i in iters],
        phases=phases,
        port_kernels={k: dict(device_ms_per_step=dev_ms[k] / n,
                              launches_per_step=launches[k] / n)
                      for k in dev_ms if any(p in k for p in _PORT_KERNELS)},
        top_kernels=[dict(name=k[:120], device_ms_per_step=dev_ms[k] / n,
                          launches_per_step=launches[k] / n) for k in top])
    line = json.dumps(res)
    print(line)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
