"""The readings the limits of ``limits/<cell>.json`` are set from: the
numbers a cell compares, for the program on many seeds and for the
control, the reference computed in float32 (the precision below the
configurations' float64) in the program's place.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control 3] [--seconds 5] [--out file.jsonl]

One process builds the cell once; each seed starts the program again from
the cold start with that seed's inputs, warms up, runs ``--seconds`` of
the cell's own loop, and is judged as a run is; the first ``--control``
seeds also give the control's reading over the same stretches.  One JSON
line a seed, with the closed-ledger error of the reference and of the
control over their stretches, and for a windows cell the program's
largest ledger error in each window and the snow at the window's start
and end.  Needs a CUDA card.  The benchmark's own runs do not run
it."""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    from portbench import check, drive as drive_mod, manifest
    cell = manifest.Cell(manifest.load(), args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    drive = drive_mod.DRIVES[cell.traffic["entry"]](
        cell.config, cell.traffic, seeds[0], device)
    t0 = time.perf_counter()
    drive.setup(keep_cold=True)
    print(f"set-up {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds):
        if i:
            drive.begin(seed)
        m = drive.measure(args.seconds)
        t0 = time.perf_counter()
        read = check.readings(
            drive, torch.float32 if i < args.control else None)
        line = dict(workload=args.workload, seed=seed, steps=m["steps"],
                    program=read["values"], where=read["where"],
                    seconds=time.perf_counter() - t0)
        if "control" in read:
            line["control_float32"] = read["control"]
        line["ledger"] = read["ledger"]
        if hasattr(drive, "diags"):
            per_step = drive.conservation()
            line["program"].update({k: float(v.max())
                                    for k, v in per_step.items()})
            line["errh2o_led_max_by_window"] = [
                float(x) for x in per_step["errh2o_led_max"]
                .reshape(-1, drive.window).max(axis=1)]
            line["snow"] = m["snow"]
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
