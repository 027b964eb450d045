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
and end.  A cell over several cards runs as its ranks, as the benchmark
does (``portbench/run.py``), and rank 0 prints each seed's widest gaps
over them.  Needs a CUDA card.  The benchmark's own runs do not run
it."""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def read_seeds(cell, args, device, group=None) -> None:
    """Each seed's readings, one JSON line a seed (on rank 0)."""
    import torch

    from portbench import check
    seeds = [int(s) for s in args.seeds.split(",")]
    drive = cell.drive(seeds[0], device, group=group)
    t0 = time.perf_counter()
    drive.setup(keep_cold=True)
    print(f"set-up {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    lead = group is None or group.rank == 0
    out = open(args.out, "a") if args.out and lead else None
    for i, seed in enumerate(seeds):
        if i:
            drive.begin(seed)
        m = drive.measure(args.seconds)
        t0 = time.perf_counter()
        read = check.readings(
            drive, torch.float32 if i < args.control else None)
        if group is not None:
            read = check.over_ranks(read, group, drive.diag_rows())
        if not lead:
            continue
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    # set by rank 0 for the ranks it starts
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    from portbench import inputs, manifest, ranks
    cell = manifest.Cell(manifest.load(), args.workload)
    device = torch.device("cuda", args.rank or 0)
    torch.cuda.set_device(device)
    if cell.chips == 1:
        read_seeds(cell, args, device)
        return 0

    def serve(rank, port):
        read_seeds(cell, args, device, ranks.join(rank, cell.chips, port,
                                                  device))
        ranks.leave()
        return 0, None
    if args.rank is not None:
        ranks.follow()
        serve(args.rank, args.port)
        return 0
    inputs.files_of(cell.config, cell.kinds)
    port = ranks.free_port()
    cmds = [[sys.executable, __file__, *argv, "--rank", str(r), "--port",
             str(port)] for r in range(1, cell.chips)]
    return ranks.lead(cmds, lambda: serve(0, port), lambda _: None)


if __name__ == "__main__":
    sys.exit(main())
