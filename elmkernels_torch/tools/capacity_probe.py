"""How many columns one card holds, and the full-step rate at ~1M
heterogeneous columns.

    CAP_NCOL=1048576 python -m elmkernels_torch.tools.capacity_probe

The port's twin of the JAX package's ``tools/capacity_probe.py``.  It
builds the model through the production ``Model.from_surfdata`` on the
synthetic global surfdata grid (``synthetic.global_surfdata``), stages ONE
series window of ``CAP_STEPS`` steps on the device (pure compute: the
ingest is measured by ``ingest_bench``), runs it once from 1985-01-15 (the
heterogeneous winter regime), then runs the same staged window again,
timed, and reports

  ms/step, columns/s, errsol_max against ``errsol_bound(ncol)``, the
  closed water ledger, the allocator's peak against the card's memory,
  peak bytes a column, and the columns one card would hold by the JAX
  package's formula (the card's memory over the peak bytes a column: the
  fixed state, parameters and step scratch and the window's payload both
  scale with the columns).

The window replays the step captured as a CUDA graph, as the loops do on
a card by default (``driver/graphs.py``; ``"replayed": true`` and the
capture's seconds and graph pool bytes in ``"graph"``).  Where the columns
do not fit so, the probe runs again under ``disable_graphs()``, op by op,
and says so (``"replayed": false``, the first run's message in
``"graph_oom"``).  If the columns do not fit either way, it prints
``"fits": false`` with the allocator's message and exits 3.

  CAP_NCOL      columns (default 1048576 = 2^20)
  CAP_STEPS     steps in the window (default 48)
  CAP_PLATFORM  ``cpu``: run on the CPU (no memory figures); default the
                card
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch


def _launches() -> dict:
    from elmkernels_torch.ops import (canopy, ci_solver, pdma, snicar, snow,
                                      soil_temperature)
    return {k.__name__: k.launches for k in (
        canopy.canopy_stability, ci_solver.ci_hybrid_solve,
        pdma.pdma_solve, pdma.pdma_solve_f32, snow.snow_hydrology,
        snicar.snicar, soil_temperature.soil_temperature)}


def probe(ncol: int, nsteps: int, device=None) -> dict:
    """The capacity record of ``ncol`` columns (raises the allocator's
    ``torch.cuda.OutOfMemoryError`` where they do not fit)."""
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date
    from elmkernels_torch.utils.guard import errsol_bound

    pft, snicar = synthetic.parameter_files()
    t0 = time.perf_counter()
    surfdata = synthetic.global_surfdata(ncol)
    t_files = time.perf_counter() - t0
    if device != "cpu" and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model.from_surfdata(surfdata, ncol, pft_path=pft,
                                snicar_path=snicar, device=device)
    dev = model.device
    # mid-winter: the heterogeneous regimes (snow, the terminator,
    # southern summer), as the long run
    start = Date.from_ymd(1985, 1, 15)
    host = model._host_series(start, nsteps)
    t_init = time.perf_counter() - t0
    print(f"# init + host window: {t_init:.1f}s (surfdata file "
          f"{t_files:.1f}s) on {dev}", file=sys.stderr)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    idx1, pidx, pinned = model._pin_series(host)
    payload = model._put(pinned)
    sync()
    t_h2d = time.perf_counter() - t0
    payload_bytes = sum(t.numel() * t.element_size() for t in pinned_leaves(
        pinned))
    print(f"# staging: {t_h2d:.1f}s, payload {payload_bytes / 2**20:.1f} "
          f"MiB", file=sys.stderr)

    t0 = time.perf_counter()
    model._scan_series(idx1, pidx, payload)
    sync()
    print(f"# first window: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    # timed: the SAME staged window again, from the first run's end state
    # (the grid's regime does not change in a day)
    t0 = time.perf_counter()
    diags = model._scan_series(idx1, pidx, payload)
    sync()
    wall = time.perf_counter() - t0

    per_step = wall / nsteps
    rec = {"ncol": ncol, "nsteps": nsteps,
           "ms_per_step": round(per_step * 1e3, 2),
           "cols_per_s": round(ncol / per_step),
           "errsol_max": float(diags.errsol_max.abs().max()),
           "errsol_bound": errsol_bound(ncol),
           "errh2o_led_max": float(diags.errh2o_led_max.abs().max()),
           "init_s": round(t_init, 1), "h2d_s": round(t_h2d, 1),
           "fits": True, "device": str(dev),
           "payload_bytes_per_col": round(payload_bytes / ncol),
           "replayed": model._graphs is not None,
           "graph": (dict(captures=model._graphs.captures,
                          replays=model._graphs.replays)
                     if model._graphs is not None else None)}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        limit = torch.cuda.get_device_properties(dev).total_memory
        rec.update(hbm_peak_gib=round(peak / 2**30, 2),
                   hbm_limit_gib=round(limit / 2**30, 2),
                   peak_bytes_per_col=round(peak / ncol),
                   cols_per_card=int(limit // (peak / ncol)),
                   reserved_peak_gib=round(
                       torch.cuda.max_memory_reserved(dev) / 2**30, 2))
    return rec


def pinned_leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for v in tree:
            yield from pinned_leaves(v)


def _oom(e) -> str:
    return " ".join(str(e).split())[:800]


def main() -> int:
    import gc

    from elmkernels_torch.driver.graphs import disable_graphs
    ncol = int(os.environ.get("CAP_NCOL", str(1 << 20)))
    nsteps = int(os.environ.get("CAP_STEPS", "48"))
    device = "cpu" if os.environ.get("CAP_PLATFORM") == "cpu" else None
    graph_oom = None
    try:
        rec = probe(ncol, nsteps, device)
    except torch.cuda.OutOfMemoryError as e:
        graph_oom = _oom(e)
    if graph_oom is not None:
        # the replayed window does not fit: the eager one, which holds no
        # graph pool beside the allocator's cache
        gc.collect()
        torch.cuda.empty_cache()
        print("# the replayed window does not fit; running it under "
              "disable_graphs()", file=sys.stderr)
        try:
            with disable_graphs():
                rec = dict(probe(ncol, nsteps, device), graph_oom=graph_oom)
        except torch.cuda.OutOfMemoryError as e:
            print("# launches: " + json.dumps(_launches()), file=sys.stderr)
            print(json.dumps({"ncol": ncol, "nsteps": nsteps, "fits": False,
                              "oom": _oom(e), "graph_oom": graph_oom}))
            return 3
    print("# launches: " + json.dumps(_launches()), file=sys.stderr)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
