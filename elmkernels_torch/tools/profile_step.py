"""Where the time of one step of the port goes on the card.

    python -m elmkernels_torch.tools.profile_step [--ncol 262144] [--steps 4]
        [--loop {run,series,windows}] [--window 4]
        [--grid {uniform,global,landunits}] [--packed] [--eager]
        [--out profile.json]

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
side stream while the current one runs).  The loops replay the step
captured as a CUDA graph (``driver/graphs.py``), as they do on a card by
default; ``--eager`` runs them under ``disable_graphs()``, op by op.  Prints
one JSON line, and writes it to ``--out`` when given:

- ``ms_per_step``: host clock over the window, ending in a synchronize;
- ``device_busy_share``: the union of the kernels' and copies' device
  intervals over the window's wall time (the rest is the card idle, waiting
  on the host);
- ``launches_per_step`` and ``device_ms_per_step`` by kernel name (top 20)
  and in all;
- ``syncs_per_step``: the host waits on the card the CUDA runtime recorded
  (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``), with ``copies_h2d_per_step``;
- ``syncs_where``: those waits by the input range around them (or
  ``steps``) and the torch operation that made them;
- ``host_launches_per_step``: the launches and asynchronous copies and
  fills the host issued (runtime and driver calls named ``*Launch*``,
  ``*Memcpy*``, ``*Memset*``; a graph launch counts one);
- ``canopy_iters_per_step``: the canopy loop's iterations (K2 runs them
  all in one launch; the plain loop ends each in an ``.any()`` test on the
  host);
- ``phases``: host and device milliseconds per step of the step's inputs
  (``run``: forcing, phenology and their copies to the card; ``series``:
  the window's host assembly and pinning, and its copy to the card) and
  of the step's three phases, each wrapped here in a ``record_function``
  range (a kernel or copy counts for the range whose device span it starts
  in); under replay the step's three phases run inside the graph, where
  no range reaches, and read 0.  Under ``--loop windows`` the window's
  copy is the program's own span ``elm.window.copy``
  (``driver/model.py``, ``utils/clock.py``), read here as
  ``window_copy``: a host operation with no annotation on the device
  timeline, whose device span is that of the copies launched inside it
  (each device operation matched to its runtime call by correlation id).
  Every other range is this tool's;
- ``device_ms_by_module``: device milliseconds per step of each module of
  the port whose functions issued the work (physics and ops modules; the
  innermost one where they nest; ``driver.step`` for the step's own).
  One more step runs eagerly after the profiled window with every
  function of those modules in a range, and each torch operation's device
  work takes the module around it; the profiled window's time of each
  device operation name (under replay, the graph's) is then shared among
  the modules as that name's time was in the eager step
  (``eager_step_read`` says what that step gave);
- ``graph``: the captures (seconds, graph pool bytes) and replays;
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
# the port's kernels by the module that launches them (also for device
# work the eager step's torch operations do not carry: a launch from
# ctypes)
_PORT_MODULES = {"canopy_kernel": "ops.canopy (K2)",
                 "ci_hybrid_kernel": "ops.ci_solver (K1)",
                 "pdma_kernel": "ops.pdma (K4)",
                 "snow_kernel": "ops.snow (K5)"}
_PORT_KERNELS = tuple(_PORT_MODULES)


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


def _module_ranges():
    """Wrap every function of the port's physics and ops modules in a
    profiler range named after its module; returns the undo."""
    import importlib
    import inspect
    import pkgutil

    import elmkernels_torch.ops as ops_pkg
    import elmkernels_torch.physics as physics_pkg
    undo = []
    for pkg in (physics_pkg, ops_pkg):
        for info in pkgutil.iter_modules(pkg.__path__):
            mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
            name = f"module:{pkg.__name__.rsplit('.', 1)[1]}.{info.name}"
            for attr, fn in list(vars(mod).items()):
                # a kernel's entry point keeps its launch count on itself:
                # it stays as it is, its work the caller's
                if (inspect.isfunction(fn) and fn.__module__ == mod.__name__
                        and not hasattr(fn, "launches")):
                    setattr(mod, attr, _ranged(fn, name))
                    undo.append((mod, attr, fn))

    def restore():
        for mod, attr, fn in undo:
            setattr(mod, attr, fn)
    return restore


_ALL_PHASES = set(_STEP_PHASES) | {n for v in _INPUTS.values() for n in v}


def _eager_step_by_module(prof, DeviceType) -> tuple:
    """The eager step's device ms by (device operation's name, module):
    each torch operation inside the ``step_body`` range carries the
    device work it launched (``FunctionEvent.kernels``), under the
    innermost module range around it on the host.  Returns that Counter
    and what was read (host operations with device work, module ranges)."""
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    body = [e for e in cpu if e.name == "step_body"]
    seen = dict(step_body=len(body), operations=0, module_ranges=0)
    out = collections.Counter()
    if not body:
        return out, seen
    b = body[0]
    lo, hi = b.time_range.start, b.time_range.end
    items = []
    for e in cpu:
        a, z = e.time_range.start, e.time_range.end
        if e.thread != b.thread or not (lo <= a and z <= hi):
            continue
        if e.name.startswith("module:"):
            items.append((a, 0, -z, e.name[len("module:"):], None))
            seen["module_ranges"] += 1
        elif e.kernels:
            items.append((a, 1, -z, None, e.kernels))
            seen["operations"] += 1
    # host ranges on one thread nest: an operation belongs to the
    # innermost range open at its start
    stack = []
    for a, kind, negz, mod, kernels in sorted(items, key=lambda t: t[:3]):
        while stack and stack[-1][0] <= a:
            stack.pop()
        if kind == 0:
            stack.append((-negz, mod))
            continue
        m = stack[-1][1] if stack else "driver.step"
        for k in kernels:
            out[(k.name, m)] += k.duration / 1e3
    return out, seen


def _by_module(eager, dev_ms, n: int) -> dict:
    """Device ms per step by module: each device operation name's time in
    the profiled window (``dev_ms``, over ``n`` steps) shared among the
    modules in the proportions that name's time had in the eager step
    (``eager``); a name the eager step's operations do not carry goes to
    its port kernel's module, else to ``"outside the step"`` (the loop's
    input copies)."""
    shares: dict = {}
    for (name, mod), ms in eager.items():
        shares.setdefault(name, collections.Counter())[mod] += ms
    out = collections.Counter()
    for name, ms in dev_ms.items():
        split = shares.get(name)
        if split:
            total = sum(split.values())
            for mod, part in split.items():
                out[mod] += ms / n * part / total
        else:
            port = next((m for k, m in _PORT_MODULES.items() if k in name),
                        "outside the step")
            out[port] += ms / n
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _syncs_where(prof, DeviceType, program) -> dict:
    """The host waits of a profile by where they were made: the input
    range around them (or ``steps``) and the torch operation that made
    them.  ``program`` maps the program's spans to this tool's names."""
    where = collections.Counter()
    for e in prof.events():
        if e.device_type != DeviceType.CPU or e.name not in _SYNCS:
            continue
        op, rng, first = e.cpu_parent, "steps", None
        while op is not None:
            if first is None and not op.name.startswith("cuda"):
                first = op.name
            if program.get(op.name, op.name) in _ALL_PHASES:
                rng = program.get(op.name, op.name)
                break
            op = op.cpu_parent
        where[f"{rng}: {first or 'the profiling loop'} ({e.name})"] += 1
    return dict(where)


def _program_device_spans(prof, DeviceType, program) -> list:
    """``(device start, device end, name)`` of each of the program's spans
    named in ``program`` ({span: this tool's name}): the span of the
    device operations launched by the runtime calls inside it on the
    host, as a ``record_function`` range's annotation on the device
    timeline spans the device work launched inside it."""
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end, program[e.name])
              for e in events
              if e.device_type == DeviceType.CPU and e.name in program]
    if not ranges:
        return []
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU
                and e.name.startswith("cu")}
    device = [(launched[e.id], e.time_range.start, e.time_range.end)
              for e in events
              if e.device_type == DeviceType.CUDA and e.id in launched]
    out = []
    for lo, hi, name in ranges:
        mine = [(a, b) for t, a, b in device if lo <= t <= hi]
        if mine:
            out.append((min(a for a, _ in mine), max(b for _, b in mine),
                        name))
    return out


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
    ap.add_argument("--eager", action="store_true",
                    help="run the loops op by op (disable_graphs()), not "
                         "replayed from the captured step")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    import contextlib

    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver import step as step_mod
    from elmkernels_torch.driver.graphs import disable_graphs
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date

    phase_names = _INPUTS[args.loop] + _STEP_PHASES
    for name in _STEP_PHASES:
        setattr(step_mod, name, _ranged(getattr(step_mod, name), name))
    Model.step_inputs = _ranged(Model.step_inputs, "step_inputs")
    Model._host_series = _ranged(Model._host_series, "window_assembly")
    Model._pin_series = _ranged(Model._pin_series, "window_assembly")
    # run_windows opens its own span around the window's copy
    program = ({"elm.window.copy": "window_copy"} if args.loop == "windows"
               else {})
    if not program:
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
    mode = disable_graphs() if args.eager else contextlib.nullcontext()
    mode.__enter__()
    # noon of July 1 (step 24), after two warm-up steps (replayed: the
    # first runs eagerly, the second captures the step)
    date = Date.from_ymd(1985, 7, 1)
    date.increment_seconds(22 * 1800)
    for _ in range(2):
        model.advance(date)
        date.increment_seconds(1800)
    torch.cuda.synchronize()
    captures = len(model._graphs.captures) if model._graphs else 0

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
    graph = (dict(captures=model._graphs.captures,
                  replays=model._graphs.replays) if model._graphs else None)
    if graph and len(graph["captures"]) != captures:
        raise RuntimeError(f"the step was captured again inside the "
                           f"profiled window: {graph}")
    mode.__exit__(None, None, None)

    # one more step, eager, with the port's modules in ranges: which module
    # issued each of the step's device operations, in order
    restore = _module_ranges()
    advance = step_mod.advance
    step_mod.advance = _ranged(advance, "step_body")
    try:
        with disable_graphs(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as eprof:
            model.advance(date)
            torch.cuda.synchronize()
    finally:
        step_mod.advance = advance
        restore()
    eager_step, eager_seen = _eager_step_by_module(eprof, DeviceType)

    dev_ms = collections.Counter()
    launches = collections.Counter()
    intervals, h2d, copies, kernels = [], [], [], []
    syncs = host_launches = 0
    phases = {k: dict(host_ms_per_step=0.0, device_ms_per_step=0.0)
              for k in phase_names}
    # a range shows twice: on the host, and as an annotation spanning its
    # kernels on the device timeline, which is not device work itself; a
    # program's span shows on the host only
    spans = _program_device_spans(prof, DeviceType, program)
    for e in prof.events():
        name = program.get(e.name, e.name)
        if name in phases:
            if e.device_type == DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end, name))
            else:
                phases[name]["host_ms_per_step"] += (
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
        elif e.name.startswith("cu") and any(
                k in e.name for k in ("Launch", "Memcpy", "Memset")):
            host_launches += 1
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
        replayed=not args.eager, graph=graph, psn_mode=model.psn_mode,
        ms_per_step=wall / n * 1e3,
        columns_per_s=args.ncol * n / wall,
        device_busy_share=busy_us / (wall * 1e6),
        device_ms_per_step=sum(dev_ms.values()) / n,
        launches_per_step=sum(launches.values()) / n,
        syncs_per_step=syncs / n,
        syncs_where=_syncs_where(prof, DeviceType, program),
        host_launches_per_step=host_launches / n,
        copies_h2d_per_step=len(h2d) / n,
        copies_h2d_in_window_copy=in_copy,
        copies_h2d_outside_window_copy_per_step=(len(h2d) - in_copy) / n,
        canopy_iters_per_step=[int(i.item()) for i in iters],
        phases=phases, windows=windows,
        device_ms_by_module=_by_module(eager_step, dev_ms, n),
        eager_step_read=dict(eager_seen, device_ms=sum(eager_step.values())),
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
