"""Where the time of one step of the port goes on the card.

    python -m elmkernels_torch.tools.profile_step [--ncol 262144] [--steps 4]
        [--loop {run,series,windows}] [--window 4]
        [--grid {uniform,global,landunits}] [--packed] [--out profile.json]

Builds a model with the production flags from synthetic input files
(written under ``build/``): ``--grid uniform`` is ``Model(ncol)``, one PFT
at one site; ``--grid global`` is ``Model.from_surfdata`` on the
ncol-cell global grid (per-column PFTs, phenology and aerosol-deposition
files, synthetic forcing); ``--grid landunits`` is that grid with
per-column landunit types (``synthetic.landunit_map``, seed 0: soil, crop,
wetland and ice sheet; ice and wetland unvegetated) and live snow aging
on synthetic ``snicar_drdt`` tables; ``--packed`` gives the model the packed
state carry (``Model(packed_carry=True)``, which the ``series`` and
``windows`` loops use).  It runs two warm-up summer steps, then
``--steps`` steps from noon of July 1 under ``torch.profiler`` (CPU and
CUDA activities): ``--loop run`` through ``Model.advance`` (each step's
inputs built on the host and copied), ``--loop series`` through
``Model.run_scan_series`` (one window payload assembled, pinned and copied
once, the steps sliced from it on the card), ``--loop windows`` through
``Model.run_windows(series=True, window=--window)`` (``--steps`` a multiple
of the window: each next window assembled on a host thread and copied on a
side stream while the current one runs).  Prints one JSON line, and
writes it to ``--out`` when given:

- ``ms_per_step``: host clock over the window, ending in a synchronize;
- ``device_busy_share``: the union of the kernels' and copies' device
  intervals over the window's wall time (the rest is the card idle, waiting
  on the host);
- ``launches_per_step`` and ``device_ms_per_step`` by kernel name (top 20)
  and in all;
- ``syncs_per_step``: the host waits on the card the CUDA runtime recorded
  (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``), with ``copies_h2d_per_step``;
- ``canopy_iters_per_step``: the canopy loop's iterations (K2 runs them
  all in one launch; the plain loop ends each in an ``.any()`` test on the
  host);
- ``phases``: host and device milliseconds per step of the step's inputs
  (``run``: forcing, phenology and their copies to the card; ``series``:
  the window's host assembly and pinning, and its copy to the card) and
  of the step's three phases, each wrapped here in a ``record_function``
  range (a kernel or copy counts for the range whose device span it starts
  in);
- ``copies_h2d_outside_window_copy_per_step``: host-to-device copies that
  did not start inside the window's copy (``series``: the steps' own);
- ``port_kernels``: device milliseconds and launches per step of the
  port's own CUDA kernels;
- ``windows`` (``--loop windows``): per window, the device milliseconds of
  its payload's copies and the share of them that ran while a kernel ran
  (the overlap with the previous window's steps), and the caching
  allocator's device allocations (``num_device_alloc``) and reserved bytes
  after the window's steps were issued.

Needs a CUDA card; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import pathlib
import subprocess
import sys
import time

_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize")
_STEP_PHASES = ("surface_phase", "flux_phase", "column_phase")
_INPUTS = {"run": ("step_inputs",),
           "series": ("window_assembly", "window_copy"),
           "windows": ("window_assembly", "window_copy")}
_PORT_KERNELS = ("canopy_kernel", "ci_hybrid_kernel", "pdma_kernel")


def _ranged(fn, name):
    """``fn`` inside a profiler range called ``name``."""
    import functools

    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _merged(intervals) -> list:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union_us(intervals) -> float:
    return sum(b - a for a, b in _merged(intervals))


def _overlap_us(a, b, merged, starts) -> float:
    """How much of [a, b) the disjoint sorted ``merged`` covers."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < b:
        total += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=262144)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--loop", choices=("run", "series", "windows"),
                    default="run")
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--grid", choices=("uniform", "global", "landunits"),
                    default="uniform")
    ap.add_argument("--packed", action="store_true",
                    help="the packed state carry (series and windows loops)")
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

    phase_names = _INPUTS[args.loop] + _STEP_PHASES
    for name in _STEP_PHASES:
        setattr(step_mod, name, _ranged(getattr(step_mod, name), name))
    Model.step_inputs = _ranged(Model.step_inputs, "step_inputs")
    Model._host_series = _ranged(Model._host_series, "window_assembly")
    Model._pin_series = _ranged(Model._pin_series, "window_assembly")
    Model._put = _ranged(Model._put, "window_copy")

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

    if args.grid in ("global", "landunits"):
        inputs = synthetic.write_global_inputs(repo / "build" / "global",
                                               args.ncol)
        surfdata = inputs.pop("surfdata")
        if args.grid == "landunits":
            from elmkernels_torch.data.surfdata import read_surfdata
            sd = read_surfdata(surfdata, args.ncol)
            ltype = synthetic.landunit_map(sd.lat_deg, seed=0)
            aging = files / "snicar_drdt.nc"
            synthetic.write_snow_aging_tables(aging)
            inputs.update(ltype=ltype, vtype=synthetic.landunit_vtypes(
                sd.vtype, ltype).tolist(), elm_correct_snow_aging=True,
                snow_aging_path=str(aging))
        model = Model.from_surfdata(surfdata, args.ncol, pft_path=str(pft),
                                    snicar_path=str(snicar),
                                    packed_carry=args.packed, **inputs)
    else:
        model = Model(ncol=args.ncol, pft_path=str(pft),
                      snicar_path=str(snicar), packed_carry=args.packed)
    # noon of July 1 (step 24), after two warm-up steps
    date = Date.from_ymd(1985, 7, 1)
    date.increment_seconds(22 * 1800)
    for _ in range(2):
        model.advance(date)
        date.increment_seconds(1800)
    torch.cuda.synchronize()

    iters, alloc = [], []

    def window_done(date, state, d):
        stats = torch.cuda.memory_stats()
        alloc.append(dict(num_device_alloc=stats["num_device_alloc"],
                          reserved_bytes=stats["reserved_bytes.all.current"]))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if args.loop == "windows":
            d = model.run_windows(date, args.steps, window=args.window,
                                  series=True, callback=window_done)
            iters = list(d.niters_canopy_max)
        elif args.loop == "series":
            d = model.run_scan_series(date, args.steps)
            iters = list(d.niters_canopy_max)
        else:
            for _ in range(args.steps):
                d = model.advance(date)
                iters.append(d.niters_canopy.max())
                date.increment_seconds(1800)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = args.steps

    dev_ms = collections.Counter()
    launches = collections.Counter()
    intervals, h2d, copies, kernels = [], [], [], []
    syncs = 0
    phases = {k: dict(host_ms_per_step=0.0, device_ms_per_step=0.0)
              for k in phase_names}
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
            if "HtoD" in e.name:
                h2d.append(e.time_range.start)
                copies.append((e.time_range.start, e.time_range.end))
            elif "Memcpy" not in e.name and "Memset" not in e.name:
                kernels.append((e.time_range.start, e.time_range.end))
        elif e.name in _SYNCS:
            syncs += 1
    for a, b in intervals:
        for lo, hi, name in spans:
            if lo <= a < hi:
                phases[name]["device_ms_per_step"] += (b - a) / 1e3 / n
                break
    in_copy = sum(1 for a in h2d
                  if any(lo <= a < hi for lo, hi, name in spans
                         if name == "window_copy"))
    busy_us = _union_us(intervals)
    windows = None
    if args.loop == "windows":
        # each window_copy range on the host issues one payload's copies
        ranges = sorted((lo, hi) for lo, hi, name in spans
                        if name == "window_copy")
        busy = _merged(kernels)
        starts = [a for a, _ in busy]
        windows = []
        for k, (lo, hi) in enumerate(ranges):
            mine = [(a, b) for a, b in copies if lo <= a < hi]
            ms = sum(b - a for a, b in mine) / 1e3
            over = sum(_overlap_us(a, b, busy, starts)
                       for a, b in mine) / 1e3
            windows.append(dict(window=k, copies=len(mine), copy_ms=ms,
                                copy_ms_under_kernels=over,
                                **(alloc[k] if k < len(alloc) else {})))
    top = sorted(dev_ms, key=dev_ms.get, reverse=True)[:20]
    res = dict(
        device=torch.cuda.get_device_name(0), card=card, ncol=args.ncol,
        steps=n, loop=args.loop, grid=args.grid, packed=args.packed,
        psn_mode=model.psn_mode,
        ms_per_step=wall / n * 1e3,
        columns_per_s=args.ncol * n / wall,
        device_busy_share=busy_us / (wall * 1e6),
        device_ms_per_step=sum(dev_ms.values()) / n,
        launches_per_step=sum(launches.values()) / n,
        syncs_per_step=syncs / n, copies_h2d_per_step=len(h2d) / n,
        copies_h2d_in_window_copy=in_copy,
        copies_h2d_outside_window_copy_per_step=(len(h2d) - in_copy) / n,
        canopy_iters_per_step=[int(i.item()) for i in iters],
        phases=phases, windows=windows,
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
