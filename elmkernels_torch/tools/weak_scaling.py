"""Weak scaling: fixed columns per rank, more ranks, the efficiency
against one rank's rate.

    python -m elmkernels_torch.tools.weak_scaling [--cols-per-dev 256]
        [--steps 5] [--devices 1 2 4 8] [--platform cpu]

The port's twin of the JAX package's ``tools/weak_scaling.py``.  Columns
are independent (no halo), so the ideal efficiency is 1 less the cost of
running more ranks.  For each count ``n`` of ``--devices`` it starts ``n``
ranks of one ``torch.distributed`` group (this module with ``--rank``;
gloo ranks on the CPU, NCCL ranks one a card), each a
``Model(ncol=mesh.ncol, col0=mesh.col0, sharding=mesh)`` block of ``n *
--cols-per-dev`` columns (``elmkernels_torch.parallel.column_mesh``),
builds the step's inputs of 1985-07-01 06:00 once, runs one step, then
times ``--steps`` steps on those inputs between two barriers; the slowest
rank's time is the count's.

On the CPU (``--platform cpu``) this measures the group's machinery, not a
card's throughput.  On cards, counts above the visible cards are left out
and said so; with one card it measures no scaling, and says so.  One JSON
line on stdout, the JAX script's list of {devices, ncol, per_step_ms,
columns_per_s, efficiency}; comment lines on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_main(args) -> int:
    """One rank: its block's step timed; rank 0 prints the slowest
    rank's seconds a step."""
    import torch
    import torch.distributed as dist

    from elmkernels_torch import parallel
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date

    cpu = args.platform == "cpu"
    if cpu:
        torch.set_num_threads(1)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=args.nranks, rank=args.rank)
    try:
        ncol = args.cols_per_dev * args.nranks
        mesh = parallel.column_mesh(ncol, device="cpu" if cpu else None)
        pft, snicar = synthetic.parameter_files()
        model = Model(ncol=mesh.ncol, col0=mesh.col0, sharding=mesh,
                      pft_path=pft, snicar_path=snicar)
        dev = model.device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        forc, phen = model.step_inputs(Date.from_ymd(1985, 7, 1, 6 * 3600))
        model._step(forc, phen)                  # first step: the load
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            model._step(forc, phen)
        sync()
        dist.barrier()
        per_step = torch.tensor([(time.perf_counter() - t0) / args.steps],
                                dtype=torch.float64, device=dev)
        dist.all_reduce(per_step, op=dist.ReduceOp.MAX)
        if args.rank == 0:
            print(json.dumps({"per_step_s": float(per_step),
                              "device": str(dev)}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_ranks(n: int, args) -> dict:
    """Start ``n`` ranks of this module and return rank 0's record."""
    port = _free_port()
    cmd = [sys.executable, "-m", "elmkernels_torch.tools.weak_scaling",
           "--cols-per-dev", str(args.cols_per_dev), "--steps",
           str(args.steps), "--platform", args.platform or "",
           "--port", str(port), "--nranks", str(n)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=args.timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {n} exited {p.returncode}:\n"
                               f"{out}\n{err[-4000:]}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cols-per-dev", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="rank counts (one card a rank on cards)")
    ap.add_argument("--platform", default=None,
                    help="cpu: gloo ranks on the CPU; default NCCL ranks, "
                         "one a card")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a rank count may take")
    # a rank of one count (started by this module)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--nranks", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.platform = args.platform or None
    if args.rank is not None:
        return rank_main(args)

    counts = list(args.devices)
    if args.platform != "cpu":
        import torch
        if not torch.cuda.is_available():
            print("# no CUDA device: pass --platform cpu for gloo ranks on "
                  "the CPU", file=sys.stderr)
            return 2
        ncard = torch.cuda.device_count()
        left = [n for n in counts if n > ncard]
        counts = [n for n in counts if n <= ncard]
        if left:
            print(f"# {ncard} card(s) visible: rank counts {left} left out",
                  file=sys.stderr)
        if counts == [1] or ncard == 1:
            print("# one card: this measures one rank's rate and no scaling",
                  file=sys.stderr)
    results = []
    for n in counts:
        rec = run_ranks(n, args)
        ncol = args.cols_per_dev * n
        per_step = rec["per_step_s"]
        rate = ncol / per_step
        results.append({"devices": n, "ncol": ncol,
                        "per_step_ms": round(per_step * 1e3, 2),
                        "columns_per_s": round(rate, 1)})
        print(f"# {n} rank(s) on {rec['device']}  ncol={ncol}  "
              f"{per_step * 1e3:7.1f} ms/step  {rate:12.0f} col/s",
              file=sys.stderr)
    base = results[0]["columns_per_s"] / results[0]["devices"]
    for r in results:
        r["efficiency"] = round(r["columns_per_s"] / r["devices"] / base, 3)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
