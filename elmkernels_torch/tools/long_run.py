"""Long integration on the heterogeneous global grid, guarded, with a
resume check.

    LR_NCOL=262144 LR_STEPS=1488 python -m elmkernels_torch.tools.long_run

The port's twin of the JAX package's ``tools/long_run.py``: the synthetic
global grid (``Model.from_surfdata`` on ``synthetic.global_surfdata``)
through the production loop, ``run_windows(series=True)``, with

- a ``StepGuard`` on every window, with the JAX run's settings: the
  reference's unclosed water and snow views off (``errh2o``,
  ``errh2osno``), the closed ledger at 1e-7, the steady snow balance at
  1e-7 and the horizon-scaled shortwave bound;
- one ``MetricsLogger`` record a window;
- history on a 64-column latitude transect every 8 windows;
- a checkpoint after window ``LR_CK_WIN`` (default: three windows before
  the end), restored after the run into a fresh model that runs the tail
  again: its final state must equal the run's bit for bit.

Knobs: ``LR_NCOL`` (262144), ``LR_STEPS`` (1488, cut to whole windows),
``LR_WINDOW`` (48), ``LR_CK_WIN``, ``LR_OUT`` (default ``build/longrun`` in
the checkout) and ``LR_PLATFORM`` (``cpu``: the CPU; default the card).
It prints one JSON summary line and writes it, with every window's
record, to ``LR_OUT/longrun.json``.  Exit 1 if the guard trips or the
resume differs.
"""

import json
import os
import pathlib
import sys
import time

import numpy as np
import torch


class _ColSlice:
    """A column subset of a state or diagnostics tuple, for history."""

    def __init__(self, obj, idx):
        self._obj, self._idx = obj, idx

    def __getattr__(self, name):
        return getattr(self._obj, name)[self._idx]


def main() -> int:
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils import checkpoint
    from elmkernels_torch.utils.dates import Date
    from elmkernels_torch.utils.guard import StepGuard, errsol_bound
    from elmkernels_torch.utils.history import HistoryWriter
    from elmkernels_torch.utils.metrics import MetricsLogger

    device = "cpu" if os.environ.get("LR_PLATFORM") == "cpu" else None
    ncol = int(os.environ.get("LR_NCOL", "262144"))
    nsteps = int(os.environ.get("LR_STEPS", "1488"))
    window = int(os.environ.get("LR_WINDOW", "48"))
    outdir = pathlib.Path(os.environ.get(
        "LR_OUT", synthetic.BUILD_DIR / "longrun"))
    nsteps -= nsteps % window
    nwin = nsteps // window
    ck_win = int(os.environ.get("LR_CK_WIN", str(max(1, nwin - 3))))
    outdir.mkdir(parents=True, exist_ok=True)

    pft, snicar = synthetic.parameter_files()
    surfdata = synthetic.global_surfdata(ncol)
    print(f"# parameter files (synthetic): {pft} {snicar} {surfdata}",
          file=sys.stderr)

    def make():
        return Model.from_surfdata(surfdata, ncol, pft_path=pft,
                                   snicar_path=snicar, device=device)

    t0 = time.time()
    model = make()
    dev = model.device
    print(f"# model init (from_surfdata, ncol={ncol}): "
          f"{time.time() - t0:.1f}s on {dev}", file=sys.stderr)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    start = Date.from_ymd(1985, 1, 1)
    # the JAX long run's guard: the unclosed water and snow views are not
    # invariants (tools/long_run.py:95-121); the closed ledger is
    guard = StepGuard(ncol=ncol, every=1, errh2o_max=None,
                      errh2osno_max=None, errh2osno_steady_max=1e-7,
                      errsol_max=errsol_bound(ncol, nsteps),
                      errh2o_led_max=1e-7)
    guard.snapshot(model.state)
    metrics = MetricsLogger(outdir / "metrics.jsonl")
    hist_idx = torch.as_tensor(np.linspace(0, ncol - 1, 64).astype(int),
                               device=dev)
    hist = HistoryWriter(str(outdir / "history.nc"),
                         fields=("t_grnd", "h2osno", "snow_depth", "t_veg"),
                         every=8)
    ck_path = outdir / "ckpt.pt"
    ck = {}
    records = []
    tripped = []

    def cb(date, state, diags):
        i = len(records) + 1
        rec = metrics.log_window(date, state, diags)
        records.append(rec)
        rep = guard.check(state, diags)
        if not rep.ok:
            tripped.append((i, rep.reasons))
            raise RuntimeError(f"guard tripped at window {i}: {rep.reasons}")
        if i % 8 == 0 or i == nwin:
            hist.record(date, _ColSlice(state, hist_idx), diags)
        if i == ck_win:
            sync()
            t = time.time()
            checkpoint.save(ck_path, state)
            ck["date"], ck["t"] = date.copy(), time.time() - t
        if i == 1:
            print(f"# first window: {time.time() - t_run:.1f}s",
                  file=sys.stderr)
        if i % 16 == 0:
            print(f"# window {i}/{nwin}  "
                  f"errh2o_led={rec['errh2o_led_max']:.2e} "
                  f"errsol={rec['errsol_max']:.2e} "
                  f"t_grnd={rec['t_grnd_mean']:.2f}", file=sys.stderr)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_run = time.time()
    try:
        model.run_windows(start, nsteps, window=window, series=True,
                          callback=cb)
    except RuntimeError as e:
        if not tripped:
            raise
        print(f"# {e}", file=sys.stderr)
        return 1
    sync()
    wall = time.time() - t_run
    hist.close()
    metrics.close()

    q = max(1, len(records) // 4)
    led_first = max(r["errh2o_led_max"] for r in records[:q])
    led_last = max(r["errh2o_led_max"] for r in records[-q:])
    sol_max = max(r["errsol_max"] for r in records)

    # resume: the checkpoint in a fresh model, the tail run again
    t = time.time()
    model2 = make()
    model2.state = checkpoint.restore(ck_path, like=model2.state)
    tail = nsteps - ck_win * window
    if tail:
        model2.run_windows(ck["date"], tail, window=window, series=True)
    sync()
    mism = [k for k in model.state._fields if not torch.equal(
        getattr(model.state, k), getattr(model2.state, k))]
    resume_s = time.time() - t

    per_step = wall / nsteps
    mem = {}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        mem = {"device_peak_gib": round(peak / 2**30, 2),
               "device_total_gib": round(torch.cuda.get_device_properties(
                   dev).total_memory / 2**30, 2),
               "device_peak_bytes_per_col": round(peak / ncol)}
    summary = {
        **mem, "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
        "ncol": ncol, "nsteps": nsteps, "window": window,
        "sim_days": nsteps * model.dtime / 86400.0,
        "wall_s": round(wall, 1), "ms_per_step": round(per_step * 1e3, 2),
        "cols_per_s": round(ncol / per_step, 0),
        "errh2o_led_max_first_quarter": led_first,
        "errh2o_led_max_last_quarter": led_last,
        "errsol_max": sol_max, "errsol_bound_used": guard.errsol_max,
        "guard_failures": len(guard.failures),
        "checkpoint_window": ck_win,
        "checkpoint_s": round(ck.get("t", 0.0), 1),
        "resume_bit_identical": not mism, "resume_fields_differing": mism,
        "resume_verify_s": round(resume_s, 1),
        "history_files": len(hist.written),
        "metrics_windows": len(records)}
    (outdir / "longrun.json").write_text(json.dumps(
        {"summary": summary, "windows": records}) + "\n")
    print(json.dumps(summary))
    if mism:
        print(f"# resume NOT bit for bit: {mism}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
