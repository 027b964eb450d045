"""One process of a run of a windows cell over ranks, on the CPU: the
harness's own leader and ranks (``portbench/run.py`` ``lead``, ``follow``)
over a gloo group, at a few columns.  Started by
``portbench/tests/test_portbench_ranks.py`` (not a test file itself):

    python portbench/tests/rank_worker.py --workload <cell> --seed <n> \\
        --seconds 0 --trace 0 --world <ranks> --ncol <columns> \\
        --out <dir> [--fault <fault>]

The process started leads rank 0 and prints the result line as the
benchmark does; ``--world 1`` runs the cell in this one process with no
group, the run the ranks are held against.  Each rank writes the state
its compared columns ended with and the window's conservation maxima to
``<out>/rank<r>.pt``.  ``--fault`` plants a fault once the window has
begun: on rank 1 a fault of ``test_portbench_faults.FAULTS`` in the
port's step (``unchanged``, ``half_batch``, ``altered``), or the rank
raises (``raise``), is killed (``killed``) or puts a module named ``jax``
into ``sys.modules`` (``jax``); on every rank ``alone``: the collectives
left out, each rank's diagnostics its own columns'."""

import argparse
import os
import pathlib
import signal
import sys
import types

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
torch.set_num_threads(1)

from portbench.drives.windows import WindowsDrive  # noqa: E402
from portbench.tests import _util  # noqa: E402


def plant(fault: str) -> None:
    """``fault`` on this rank from the start of the measured window."""
    import elmkernels_torch.driver.step as step_mod
    import elmkernels_torch.parallel.reductions as red
    from portbench.tests.test_portbench_faults import FAULTS
    advance, measure = step_mod.advance, WindowsDrive.measure
    combine = red.combine

    def broken(*args, **kw):
        new, d = advance(*args, **kw)
        return FAULTS[fault](new, args[5], d)

    def faulty(self, seconds):
        if fault in FAULTS:
            step_mod.advance = broken
        elif fault == "alone":
            red.combine = lambda mesh, **kw: combine(None, **kw)
        elif fault == "raise":
            raise RuntimeError("a fault planted on rank 1")
        elif fault == "killed":
            os.kill(os.getpid(), signal.SIGKILL)
        elif fault == "jax":
            sys.modules["jax"] = types.ModuleType("jax")
        return measure(self, seconds)
    WindowsDrive.measure = faulty


def keep(out: pathlib.Path, rank: int) -> None:
    """Write what the drive kept before its state goes."""
    release = WindowsDrive.release

    def kept(self):
        torch.save(dict(cols=torch.as_tensor(self.cols),
                        state=self.snaps[max(self.snaps)],
                        conservation={k: torch.as_tensor(v) for k, v in
                                      self.conservation().items()}),
                   out / f"rank{rank}.pt")
        release(self)
    WindowsDrive.release = kept


def main() -> int:
    argv = sys.argv[1:]
    ap = argparse.ArgumentParser()
    for name in ("--workload", "--out", "--fault"):
        ap.add_argument(name)
    for name in ("--seed", "--trace", "--world", "--ncol", "--rank",
                 "--port"):
        ap.add_argument(name, type=int)
    ap.add_argument("--seconds", type=float)
    args = ap.parse_args(argv)
    run = _util.run_module()
    cell = _util.small_cell(args.workload, call_steps=8, window=4)
    cell.chips = args.world
    rank = args.rank or 0
    keep(pathlib.Path(args.out), rank)
    if args.fault and (rank == 1 or args.fault == "alone"):
        plant(args.fault)
    cpu = torch.device("cpu")
    sizes = dict(ncol=args.ncol, compare_columns=args.ncol)
    if args.world == 1:
        run.emit(run.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), cpu, **sizes))
        return 0
    if args.rank is not None:
        return run.follow(cell, args, cpu, **sizes)
    return run.lead(cell, args, argv, __file__, lambda r: cpu, **sizes)


if __name__ == "__main__":
    sys.exit(main())
