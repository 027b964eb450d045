"""One run of one cell of the benchmark of ``elmkernels_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; the mix names how the program is driven
(``portbench/drive.py``).  The run sets the program up (building its
kernels into ``build/kernels`` and writing the inputs into
``build/portbench`` on the first run in a checkout), measures for
``--seconds``, and with ``--trace 1`` traces one more call under the
profiler for the per-layer metrics.  Then the plain reference follows the
columns it kept and decides ``correct`` (``portbench/check.py``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit,
which also end standard error.

Needs a CUDA card: without one, or with fewer than the cell asks for, it
exits 3 and prints no result."""

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
             **sizes) -> dict:
    """Set up, measure, trace (``traced``) and judge one run of ``cell``
    on ``device``; returns the result line's object.  ``sizes``
    (``ncol``, ``compare_columns``) shrink the cell for a rehearsal on the
    CPU."""
    import torch

    from portbench import check, drive as drive_mod, trace
    cuda = device.type == "cuda"
    drive = drive_mod.DRIVES[cell.traffic["entry"]](
        cell.config, cell.traffic, seed, device, **sizes)
    drive.setup()
    drive_mod.sync(device)
    setup_s = time.perf_counter() - T_START
    m = drive.measure(seconds)
    print("window: " + json.dumps({k: v for k, v in m.items()
                                   if k != "step_s"}),
          file=sys.stderr, flush=True)

    metrics, breakdown, extra = {}, None, {}
    if traced:
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
            metrics[metric["name"]] = dict(value=values[metric["name"]],
                                           unit=metric["unit"])
    device_info = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        count=cell.chips,
        memory_peak_bytes=torch.cuda.max_memory_allocated(device)
        if cuda else 0, **extra)

    # the window has closed: the program's state goes, and the reference
    # follows the columns the drive kept
    drive.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    read = check.readings(drive)
    values, limits = dict(read["values"]), dict(cell.limits)
    if hasattr(drive, "diags"):
        contract = cell.config["contract"]
        per_step = drive.conservation()
        bad = 0
        for k, v in per_step.items():
            limits[k] = contract_limit(contract[k], drive.ncol * len(v))
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
    print(f"reference: {time.perf_counter() - t_ref:.1f} s over "
          f"{len(drive.cols)} columns; widest gaps in {read['where']}",
          file=sys.stderr)
    result = dict(correct=bool(ok), attempted=m["steps"], failed=failed,
                  metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {n: _finite(x) for n, x in v.items()}
                        for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "elmkernels_torch").is_dir():
        print(f"portbench: no elmkernels_torch beside {ROOT / 'portbench'}: "
              f"the benchmark runs from a checkout of the repository",
              file=sys.stderr)
        return 2
    _caches()
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA card; the benchmark does not run on the "
              "CPU", file=sys.stderr)
        return 3
    from portbench import manifest
    cell = manifest.Cell(manifest.load(), args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
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
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
