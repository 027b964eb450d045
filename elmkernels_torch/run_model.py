"""Config-driven model run: the production driver of the port.

Counterpart of ``examples/run_model.py``: the reference's
``kokkos_driver.cc`` main() plus what it lacks, file/CLI configuration,
per-step validation with PrimaryVars rollback, JSONL metrics, NetCDF
history and periodic checkpoints.

Usage:
  python -m elmkernels_torch.run_model --config run.json
  python -m elmkernels_torch.run_model --ncol 8 --nsteps 48 \\
      --pft_path clm_params.nc --snicar_path snicar_optics.nc --device cpu
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    import torch

    from elmkernels_torch.config import RunConfig
    from elmkernels_torch.utils import checkpoint as ckpt
    from elmkernels_torch.utils.clock import Clock
    from elmkernels_torch.utils.guard import StepGuard

    cfg = RunConfig.from_cli(argv)
    model = cfg.make_model()
    date = cfg.start_date()
    on_card = model.device.type == "cuda"

    # the default errsol guard (1e-5) covers the mixed-radiation default; a
    # float32 run carries float32 roundoff through every closure
    errsol_max = cfg.errsol_max
    if not cfg.f64 and errsol_max is not None and errsol_max < 1e-4:
        errsol_max = 1e-4
    guard = StepGuard(errh2o_max=cfg.errh2o_max,
                      errh2osno_max=cfg.errh2osno_max,
                      errsol_max=errsol_max)
    guard.snapshot(model.state)
    metrics = None
    if cfg.metrics_path:
        from elmkernels_torch.utils.metrics import MetricsLogger
        metrics = MetricsLogger(cfg.metrics_path)
    history = None
    if cfg.history_path:
        from elmkernels_torch.utils.history import HistoryWriter
        history = HistoryWriter(
            cfg.history_path,
            [f.strip() for f in cfg.history_fields.split(",") if f.strip()],
            every=cfg.history_every, ref_date=date.copy())

    clock = Clock()
    for istep in range(cfg.nsteps):
        with clock.time("advance"):
            diags = model.advance(date)
            if on_card:
                # the host clock then times the card's step, not its launch
                torch.cuda.synchronize(model.device)
        with clock.time("validate"):
            rep = guard.check(model.state, diags)
            if not rep.ok:
                print(f"step {istep}: VALIDATION FAILED: "
                      f"{'; '.join(rep.reasons)} — rolling back",
                      file=sys.stderr)
                model.state = guard.restore_into(model.state)
        if metrics:
            metrics.log_step(date, model.state, diags)
        if history:
            history.record(date, model.state, diags)
        if (cfg.checkpoint_dir and cfg.checkpoint_every
                and (istep + 1) % cfg.checkpoint_every == 0):
            with clock.time("checkpoint"):
                ckpt.save(f"{cfg.checkpoint_dir}/step{istep + 1:06d}.pt",
                          model.state)
        date.increment_seconds(int(cfg.dtime))

    summ = clock.summary()
    adv = summ.get("advance", {})
    print(f"done: {cfg.nsteps} steps x {cfg.ncol} cols, "
          f"{adv.get('mean_s', 0) * 1e3:.2f} ms/step, "
          f"{len(guard.failures)} validation failures")
    t = model.state.t_grnd
    print(f"t_grnd[0]={float(t[0]):.3f} K; "
          f"all finite={bool(torch.isfinite(t).all())}")
    if metrics:
        metrics.close()
    if history:
        history.close()
        print(f"history: {len(history.written)} file(s), last "
              f"{history.written[-1] if history.written else 'none'}")
    return 0 if not guard.failures else 1


if __name__ == "__main__":
    sys.exit(main())
