"""One run of one cell of the benchmark of ``elmkernels_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; the mix names how the program is driven
(``portbench/drives/<entry>.py``), and the configuration its inputs
(``portbench/sources/<kind>.py``).  The run sets the program up (building
its kernels into ``build/kernels`` and writing the inputs into
``build/portbench`` on the first run in a checkout), measures for
``--seconds``, and with ``--trace 1`` traces one more call under the
profiler for the per-layer metrics.  Then the plain reference follows the
columns it kept and decides ``correct`` (``portbench/check.py``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit,
which also end standard error.

A cell of ``chips`` > 1 runs as that many ranks, one process a card
(``portbench/ranks.py``): the process started is rank 0; it writes the
inputs, starts the others as this command with ``--rank r --port p``, and
prints the result once every rank has ended well.  A rank that fails ends
them all, with no result.

Needs a CUDA card: without one, or with fewer than the cell asks for, it
exits 3 and prints no result.  A cell whose configuration names an input
kind, or whose mix names a drive, that has no file exits 2 at once, with
no result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the checkout's root, not this directory, heads the import path
sys.path[0] = str(ROOT)

# top-level module names that may not be loaded in the process that
# prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "elmkernels_tpu")


def _caches() -> None:
    """Every compiler cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def loaded_forbidden() -> list[str]:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def contract_limit(spec, column_steps: float) -> float:
    """A conservation limit the configuration states: a number, or
    ``{"base", "column_steps"}``: ``base`` at the calibration's
    column-steps, growing like sqrt(log N) over ``column_steps`` (the
    largest of N float roundoffs; ``elmkernels_torch/utils/guard.py:
    errsol_bound``)."""
    if not isinstance(spec, dict):
        return spec
    n = column_steps / spec["column_steps"]
    return spec["base"] * math.sqrt(1.0 + max(0.0, math.log2(n)) / 2.0)


class MissingReading(Exception):
    """A per-layer metric that the manifest lists for the cell read
    nothing."""


def per_layer(cell, drive, m: dict, rec: dict, traced: dict) -> dict:
    """The cell's per-layer metrics from the traced record ``rec``, which
    also carries the untraced window's readings (``measured``).  A metric
    that names a kernel (``ROOFLINE``) reads that kernel's bound of one
    launch (``bound_ms``, from ``rooflines/<kernel>.py`` on the traced
    call).  A metric that the manifest lists for this cell and that reads
    nothing is an error; one that it does not list is left out."""
    run = dict(config=cell.config, files=drive.files, ncol=drive.ncol,
               traced=traced, measured=m)
    rec["measured"] = m
    bounds, out = {}, {}
    for metric in cell.per_layer:
        mod = cell.module("metrics", metric["name"])
        kernel = getattr(mod, "ROOFLINE", None)
        if kernel is not None and kernel not in bounds:
            bounds[kernel] = cell.module("rooflines", kernel).launch_ms(run)
        v = mod.read(rec if kernel is None
                     else dict(rec, bound_ms=bounds[kernel]))
        if v is not None:
            out[metric["name"]] = dict(value=v, unit=metric["unit"])
        elif cell.listed(metric):
            raise MissingReading(f"{metric['name']} read nothing in "
                                 f"{cell.name}, which the manifest lists")
    return out


def _finite(v):
    """A number JSON holds: an infinite gap as 1e308, NaN as None."""
    if isinstance(v, float) and not math.isfinite(v):
        return None if math.isnan(v) else math.copysign(1e308, v)
    return v


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             group=None, **sizes) -> dict | None:
    """Set up, measure, trace (``traced``) and judge one run of ``cell``
    on ``device``; returns the result line's object.  With ``group`` (a
    ``ranks.Group``) this is one rank of the run: every rank runs the
    window, the traced call and the reference over its own columns, and
    rank 0 alone records the trace and returns the result (the others
    None).  ``sizes`` (``ncol``, ``compare_columns``) shrink the cell for
    a rehearsal on the CPU."""
    import torch

    from portbench import check, drive as drive_mod, trace
    cuda = device.type == "cuda"
    lead = group is None or group.rank == 0
    drive = cell.drive(seed, device, group=group, **sizes)
    drive.setup()
    drive_mod.sync(device)
    if group is not None:
        group.barrier()
    setup_s = time.perf_counter() - T_START
    m = drive.measure(seconds)
    print("window: " + json.dumps({k: v for k, v in m.items()
                                   if k != "step_s"}),
          file=sys.stderr, flush=True)

    metrics, breakdown, extra = {}, None, {}
    if traced and not lead:
        drive.traced()               # its collectives need every rank
        drive_mod.sync(device)
    elif traced:
        def traced_call():
            out = drive.traced()
            drive_mod.sync(device)
            return out
        rec = trace.record(traced_call)
        out = rec.pop("out")
        if "snow" in out:
            print(f"traced call: snow {json.dumps(out['snow'])}",
                  file=sys.stderr)
        metrics = per_layer(cell, drive, m, rec, out)
        breakdown = dict(device_ops=trace.top_device_ops(rec),
                         idle_gaps=trace.idle_gaps(rec))
        extra = dict(busy_s=trace.busy_us(rec) / 1e6,
                     window_s=trace.window_us(rec) / 1e6)
        del rec
    else:
        values = dict(m, setup_s=setup_s)
        for metric in cell.end_to_end:
            name = metric["name"]
            # a metric with a file of its own in end_to_end/ reads the
            # window's readings under another name
            v = (cell.module("end_to_end", name).read(values)
                 if cell.has("end_to_end", name) else values[name])
            metrics[name] = dict(value=v, unit=metric["unit"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if group is not None:
        peak = max(group.gather(peak))
    device_info = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        count=cell.chips, memory_peak_bytes=peak, **extra)

    # the window has closed: the program's state goes, and the reference
    # follows the columns the drive kept
    drive.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    read = check.readings(drive)
    print(f"reference: {time.perf_counter() - t_ref:.1f} s over "
          f"{len(drive.cols)} columns; widest gaps in {read['where']}",
          file=sys.stderr)
    if group is not None:
        read = check.over_ranks(read, group, drive.diag_rows())
        if not lead:
            return None
    values, limits = dict(read["values"]), dict(cell.limits)
    if hasattr(drive, "diags"):
        contract = cell.config["contract"]
        per_step = drive.conservation()
        bad = 0
        for k, v in per_step.items():
            limits[k] = contract_limit(contract[k],
                                       drive.grid_ncol * len(v))
            values[k] = float(v.max())
            bad = bad | ~(v <= limits[k])
        failed = int(bad.sum())
        by_window = per_step["errh2o_led_max"].reshape(-1, drive.window)
        print("errh2o_led_max by window: "
              + " ".join(f"{x:.3g}" for x in by_window.max(axis=1)),
              file=sys.stderr)
    else:
        values["nonfinite_steps"] = drive.nonfinite
        failed = drive.nonfinite
    ok, checks = check.judge(values, limits)
    if group is not None:
        print(f"widest gaps over the ranks in {read['where']}",
              file=sys.stderr)
    result = dict(correct=bool(ok), attempted=m["steps"], failed=failed,
                  metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {n: _finite(x) for n, x in v.items()}
                        for k, v in checks.items()}
    return result


def emit(result: dict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error, then the result line."""
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def serve(cell, args, rank: int, port: int, device, **sizes):
    """Rank ``rank`` of a run over ``cell.chips`` ranks: ``(exit code,
    result)``, the result on rank 0 only.  A rank that loaded a forbidden
    module once its run has ended has no result (code 4)."""
    from portbench import ranks
    group = ranks.join(rank, cell.chips, port, device)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device, group=group, **sizes)
    except MissingReading as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 5, None
    ranks.leave()
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"portbench: rank {rank} loaded {forbidden}", file=sys.stderr)
        return 4, None
    return 0, result


def lead(cell, args, argv: list, script, device_of, **sizes) -> int:
    """Rank 0 of a run over ``cell.chips`` ranks: write the inputs, start
    ranks 1.. as ``script`` with ``argv`` and ``--rank r --port p``, run
    rank 0 on ``device_of(0)``, and print the result once every rank has
    ended with 0 (``ranks.lead``)."""
    from portbench import inputs, ranks
    # every rank reads its block of these: written once, before any starts
    inputs.files_of(cell.config, cell.kinds, sizes.get("ncol"))
    port = ranks.free_port()
    cmds = [[sys.executable, str(script), *argv, "--rank", str(r),
             "--port", str(port)] for r in range(1, cell.chips)]
    return ranks.lead(cmds, lambda: serve(cell, args, 0, port, device_of(0),
                                          **sizes), emit)


def follow(cell, args, device, **sizes) -> int:
    """Rank ``args.rank`` > 0, started by rank 0: it ends with its leader,
    and without waiting on the group where it fails."""
    from portbench import ranks
    ranks.follow()
    try:
        code, _ = serve(cell, args, args.rank, args.port, device, **sizes)
    except BaseException:
        import traceback
        traceback.print_exc()
        code = 1
    if code:
        ranks.exit_now(code)
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 for the ranks it starts
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    if not (ROOT / "elmkernels_torch").is_dir():
        print(f"portbench: no elmkernels_torch beside {ROOT / 'portbench'}: "
              f"the benchmark runs from a checkout of the repository",
              file=sys.stderr)
        return 2
    _caches()
    from portbench import manifest
    try:
        cell = manifest.Cell(manifest.load(), args.workload)
    except manifest.Unknown as e:
        # a configuration's input or a mix's drive that the harness has no
        # file for: nothing runs without it
        print(f"portbench: {args.workload}: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA card; the benchmark does not run on the "
              "CPU", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    device = torch.device("cuda", args.rank or 0)
    torch.cuda.set_device(device)
    if args.rank is not None:
        return follow(cell, args, device)
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    if cell.chips > 1:
        return lead(cell, args, argv, __file__,
                    lambda r: torch.device("cuda", r))
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device)
    except MissingReading as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 5
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"portbench: the run loaded {forbidden}", file=sys.stderr)
        return 4
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
