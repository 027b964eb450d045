"""One rank of the port's sharded runs on the CPU, over a gloo group.

Started by ``tests/test_torch_parallel.py`` (not a test file itself):

    python tests/torch_parallel_worker.py PORT NRANKS RANK SPEC.json OUT

``SPEC.json`` names the scenario and its inputs (written by the test);
the rank builds only its own block of columns (``parallel.column_mesh``,
``Model(ncol=mesh.ncol, col0=mesh.col0, sharding=mesh)``), starts from
the unsharded initial state cut by ``shard_state``, runs, and writes what
the test compares to ``OUT/rank<r>.pt``.  With ``NRANKS`` 0 it runs the
same scenario unsharded, in one process with no group, into
``OUT/unsharded.pt``: the run the ranks are held against.  It imports
neither JAX nor the JAX package.
"""

import json
import os
import pathlib
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
torch.set_num_threads(1)

from elmkernels_torch import parallel  # noqa: E402
from elmkernels_torch.data import netcdf  # noqa: E402
from elmkernels_torch.data.state import ModelState  # noqa: E402
from elmkernels_torch.driver.model import Model  # noqa: E402
from elmkernels_torch.utils import checkpoint  # noqa: E402
from elmkernels_torch.utils.clock import Clock  # noqa: E402
from elmkernels_torch.utils.dates import Date  # noqa: E402
from elmkernels_torch.utils.guard import StepGuard  # noqa: E402
from elmkernels_torch.utils.metrics import MetricsLogger  # noqa: E402

FORCING_VARS = ("TBOT", "PBOT", "QBOT", "FLDS", "FSDS", "PRECTmms", "WIND")


def build(spec, mesh):
    kw = dict(pft_path=spec["pft_path"], snicar_path=spec["snicar_path"],
              device="cpu", **spec.get("flags", {}))
    if spec.get("forcing_basename"):
        kw["forcing_basename"] = spec["forcing_basename"]
    if mesh is None:
        return Model(ncol=spec["ncol"], col0=spec.get("col0", 0), **kw), True
    model = Model(ncol=mesh.ncol, col0=mesh.col0, sharding=mesh, **kw)
    own = model.state
    # every rank starts from the unsharded initial state's own columns
    model.state = parallel.shard_state(mesh, ModelState(**torch.load(
        spec["initial_state"], weights_only=True)))
    same = all(torch.equal(a, b) for a, b in zip(own, model.state))
    return model, same


def main():
    port, nranks, rank = (int(a) for a in sys.argv[1:4])
    spec = json.loads(pathlib.Path(sys.argv[4]).read_text())
    out = pathlib.Path(sys.argv[5])
    mesh = None
    if nranks:
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=nranks, rank=rank)
        mesh = parallel.column_mesh(spec["ncol"], col0=spec.get("col0", 0),
                                    device="cpu")
    reads = []
    read_var = netcdf.read_var

    def spy(path, name, start=None, count=None):
        if name in FORCING_VARS:
            reads.append((name, start, None if count is None
                          else tuple(count)))
        return read_var(path, name, start=start, count=count)
    netcdf.read_var = spy
    model, cold_start_same = build(spec, mesh)
    start = Date(*spec["start"])
    res = dict(lo=mesh.lo if mesh else 0, hi=mesh.hi if mesh else
               spec["ncol"], cold_start_same=cold_start_same)
    scenario = spec["scenario"]
    if scenario == "step":
        d = model.advance(start)
        res["diags"] = model.reduce_diags(d)
        res["errsol"] = parallel.min_max_sum(d.errsol.abs(), mesh)
        res["t_grnd"] = parallel.min_max_mean(model.state.t_grnd, mesh)
    elif scenario == "series":
        metrics = MetricsLogger(
            out / ("metrics.jsonl" if mesh else "unsharded.jsonl"), mesh)
        records = []
        res["diags"] = model.run_windows(
            start, spec["nsteps"], window=spec["window"], series=True,
            callback=lambda date, state, d: records.append(
                metrics.log_window(date, state, d)))
        metrics.close()
        res["records"] = records
        ck = out / ("ckpt" if mesh else "unsharded_ckpt")
        checkpoint.save(ck, model.state, mesh)
        back = checkpoint.restore(ck, like=model.state, mesh=mesh)
        res["checkpoint_equal"] = all(
            torch.equal(a, b) for a, b in zip(model.state, back))
        try:  # the rank's file read as an unsharded checkpoint
            checkpoint.restore(checkpoint.shard_path(ck, mesh),
                               like=model.state)
            res["checkpoint_refused"] = ""
        except ValueError as e:
            res["checkpoint_refused"] = str(e)
    elif scenario == "clock":
        clock = Clock(mesh)
        with clock.time("section"):
            time.sleep(0.05 * (rank + 1))
        res["local"] = clock.summary()["section"]["mean_s"]
        res["min_max_mean"] = clock.min_max_mean("section")
    elif scenario == "guard":
        guard = StepGuard(ncol=mesh.ncol_global, errh2o_max=None,
                          errh2osno_max=None, mesh=mesh)
        guard.snapshot(model.state)
        d = model.run_windows(start, spec["window"],
                              window=spec["window"], series=True)
        res["first"] = guard.check(model.state, d).ok
        res["validated"] = model.state
        later = Date(*spec["start"])
        later.increment_seconds(int(model.dtime) * spec["window"])
        model.run_windows(later, spec["window"], window=spec["window"],
                          series=True)
        state = model.state
        if rank == spec["bad_rank"]:
            state = state._replace(t_grnd=state.t_grnd.clone())
            state.t_grnd[0] = float("nan")
        rep = guard.check(state, d)
        res["second"] = dict(ok=rep.ok, reasons=rep.reasons,
                             can_roll_back=rep.can_roll_back)
        res["restored"] = guard.restore_into(state)
    else:
        raise ValueError(f"unknown scenario {scenario}")
    res["state"] = model.state
    res["reads"] = reads
    torch.save(res, out / (f"rank{rank}.pt" if mesh else "unsharded.pt"))
    if mesh is not None:
        dist.barrier()
        dist.destroy_process_group()
    print(f"rank {rank if mesh else 'unsharded'}: OK", flush=True)


if __name__ == "__main__":
    main()
