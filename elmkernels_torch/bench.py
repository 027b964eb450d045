"""Benchmark: full coupled water and energy step throughput on one card.

    python -m elmkernels_torch.bench

The port's twin of the JAX package's ``bench.py``.  It prints ONE JSON
line on stdout,

  {"metric": "full-step gridcell-columns/s per chip", "value": N,
   "unit": "columns/s", "vs_baseline": 1.0}

and comment lines (``# ...``) on stderr.  The estimator is the JAX
bench's: consecutive windows of ``BENCH_STEPS`` steps, each timed, after
a first window (the kernels' load), a warm-up window and a trace-or-skip
window; the headline is the best of ``BENCH_DAYS`` full diurnal days (48
steps of 1800 s each), per step, over the columns.  Each window ends in
``torch.cuda.synchronize``, whose own cost on an idle card (the median of
seven) is subtracted, as the JAX bench subtracts its scalar pull.

The parameter files are the synthetic ones ``chip_smoke.py`` writes under
``build/`` (``elmkernels_torch/data/synthetic.py``); a comment line names
them.  Environment knobs, as in the JAX bench:

  BENCH_NCOL    columns (default 8192)
  BENCH_STEPS   steps per window (default 12; 4 windows = 1 day)
  BENCH_DAYS    full diurnal days timed (default 2; best-of is used)
  BENCH_F32     1: the all-float32 model (default float64)
  BENCH_SCAN    1 (default): ``Model.run_windows(series=True)``, the
                production loop, one window per window; 0: ``Model.run``
                (per-step inputs), consecutive steps, one window a day
  BENCH_MIXED   1 (default): the production flags (float32 radiative
                solvers and canopy-loop interior, warm-started solvers);
                0: the reference-exact flags
  BENCH_WARM    override warm_start alone (default follows BENCH_MIXED)
  BENCH_MIXED_CANOPY  override mixed_canopy alone (default follows
                BENCH_MIXED)
  BENCH_PACKED  1: the packed state carry (``Model(packed_carry=True)``,
                one [ncol, K] buffer per dtype, ``utils/packing.py``);
                default 0
  BENCH_HETERO  1: the synthetic global grid through
                ``Model.from_surfdata``; default 0: the reference site
  BENCH_PLATFORM  ``cpu``: run on the CPU (``device="cpu"``); default
                the first CUDA device, which must exist
  BENCH_TRACE   a path: a ``torch.profiler`` trace (Chrome JSON) of the
                trace window is written there

``BENCH_COMPILE_EFFORT`` (XLA's compile effort) means nothing here and is
refused.  Exit 2 on a refused knob, and, as in the JAX bench, when the production
flags in float64 break the batch-scaled shortwave contract
(``utils/guard.py:errsol_bound``).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

METRIC = "full-step gridcell-columns/s per chip"
STEPS_PER_DAY = 48
# the JAX bench's knobs that have no counterpart in eager PyTorch
REFUSED = {"BENCH_COMPILE_EFFORT": "nothing is compiled by XLA here"}


def _flag(name: str, default: str) -> bool:
    return os.environ.get(name, default) == "1"


def _refused() -> str | None:
    for name, why in REFUSED.items():
        val = os.environ.get(name, "")
        if val:
            return f"{name}={val} is refused: {why}"
    platform = os.environ.get("BENCH_PLATFORM", "")
    if platform not in ("", "cpu", "cuda", "gpu"):
        return f"BENCH_PLATFORM={platform} is refused: cpu or the card"
    return None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> int:
    refused = _refused()
    if refused:
        print(f"# {refused}", file=sys.stderr)
        return 2
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.ops import ci_solver, pdma
    from elmkernels_torch.utils.dates import Date
    from elmkernels_torch.utils.guard import errsol_bound

    f32 = _flag("BENCH_F32", "0")
    ncol = int(os.environ.get("BENCH_NCOL", "8192"))
    nsteps = int(os.environ.get("BENCH_STEPS", "12"))
    ndays = int(os.environ.get("BENCH_DAYS", "2"))
    use_scan = _flag("BENCH_SCAN", "1")
    # windows per timed diurnal day
    wpd = max(1, round(STEPS_PER_DAY / nsteps)) if use_scan else 1
    mixed = _flag("BENCH_MIXED", "1")
    warm = _flag("BENCH_WARM", "1" if mixed else "0")
    mixed_can = _flag("BENCH_MIXED_CANOPY", "1" if mixed else "0")
    hetero = _flag("BENCH_HETERO", "0")
    packed = _flag("BENCH_PACKED", "0")
    device = "cpu" if os.environ.get("BENCH_PLATFORM") == "cpu" else None

    pft, snicar = synthetic.parameter_files()
    kw = dict(pft_path=pft, snicar_path=snicar, mixed_radiation=mixed,
              warm_start=warm, mixed_canopy=mixed_can,
              packed_carry=packed, device=device,
              dtype=torch.float32 if f32 else torch.float64)
    if hetero:
        surfdata = synthetic.global_surfdata(ncol)
        print(f"# parameter files (synthetic): {pft} {snicar} {surfdata}",
              file=sys.stderr)
        model = Model.from_surfdata(surfdata, ncol, **kw)
    else:
        print(f"# parameter files (synthetic): {pft} {snicar}",
              file=sys.stderr)
        model = Model(ncol=ncol, **kw)
    dev = model.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    nwin = 3 + ndays * wpd
    date = Date.from_ymd(1985, 7, 1, 6 * 3600)
    trace = os.environ.get("BENCH_TRACE")
    prof = None
    stamps, errsol = [], []
    kernels = (ci_solver.ci_hybrid_solve, pdma.pdma_solve,
               pdma.pdma_solve_f32)
    for k in kernels:
        k.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def window_done(i: int) -> None:
        """End of window ``i``: wait for the card, stamp, and start or
        stop the trace around window 2."""
        nonlocal prof
        _sync(dev)
        stamps.append(time.perf_counter())
        if trace and i == 1:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        elif prof is not None and i == 2:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(trace)
            prof = None

    _sync(dev)
    t0 = time.perf_counter()
    if use_scan:
        def cb(_date, _state, d):
            errsol.append(d.errsol_max.abs().max())
            window_done(len(stamps))
        model.run_windows(date, nwin * nsteps, window=nsteps, series=True,
                          callback=cb)
    else:
        for i in range(nwin):
            model.run(date, nsteps, lambda _date, _state, d: errsol.append(
                d.errsol.abs().max()))
            date.increment_seconds(int(model.dtime) * nsteps)
            window_done(i)
    # the cost of the sync itself, on an idle card
    samples = []
    for _ in range(7):
        s0 = time.perf_counter()
        _sync(dev)
        samples.append(time.perf_counter() - s0)
    sync_s = sorted(samples)[len(samples) // 2]

    print(f"# first window (kernel load): {stamps[0] - t0:.1f}s  "
          f"ncol={ncol} dtype={'f32' if f32 else 'f64'} "
          f"mode={'windows(series)' if use_scan else 'run'}x{nsteps}"
          f"{' mixed-radiation' if mixed else ''}"
          f"{' warm-start' if warm else ''}"
          f"{' mixed-canopy' if mixed_can else ''}"
          f"{' hetero' if hetero else ''}"
          f"{' packed-carry' if packed else ''}  device={name}",
          file=sys.stderr)
    wtimes = [max(stamps[i] - stamps[i - 1] - sync_s, 0.0)
              for i in range(3, nwin)]
    day_totals = [sum(wtimes[d * wpd:(d + 1) * wpd]) for d in range(ndays)]
    steps_per_day = wpd * nsteps
    per_step = min(day_totals) / steps_per_day
    errsol_v = float(torch.stack(errsol[3:]).max())
    med = sorted(wtimes)[len(wtimes) // 2] / nsteps
    print(f"# per-step: {per_step * 1e3:.2f} ms best-of-{ndays}-days "
          f"(day totals {[round(t, 3) for t in day_totals]} s / "
          f"{steps_per_day} steps each; per-window ms/step "
          f"{[round(t / nsteps * 1e3, 2) for t in wtimes]}; median window "
          f"{med * 1e3:.2f}; sync {sync_s * 1e3:.3f} ms), "
          f"errsol_max={errsol_v:.2e}", file=sys.stderr)
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        total = torch.cuda.get_device_properties(dev).total_memory
        print(f"# device memory: peak {peak / 2**30:.2f} GiB / "
              f"{total / 2**30:.2f} GiB ({peak / ncol:.0f} B/col peak)",
              file=sys.stderr)
    print("# launches: " + json.dumps(
        {k.__name__: k.launches for k in kernels}), file=sys.stderr)
    print(json.dumps({"metric": METRIC, "value": round(ncol / per_step, 1),
                      "unit": "columns/s", "vs_baseline": 1.0}))
    if mixed and not f32:
        bound = errsol_bound(ncol)
        if not errsol_v <= bound:
            print(f"# CONTRACT VIOLATION: errsol_max {errsol_v:.3e} > "
                  f"errsol_bound({ncol}) = {bound:.3e}", file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
