"""Run the coupled model for ``--steps`` steps and dump the final state
and the per-step reduced diagnostics to an ``.npz``, in the model dtype
``--dtype``.

    python -m elmkernels_torch.tools.f32_traj --ncol 4 --steps 720 \\
        --out f32.npz
    python -m elmkernels_torch.tools.f32_traj --dtype float64 --ncol 4 \\
        --steps 720 --out f64.npz

The port's twin of the JAX package's ``tools/f32_traj.py``, whose
``--x64`` switch becomes ``--dtype`` (float32 by default, as the JAX
script without ``--x64``).  The run starts on 1 January (a winter start:
with the synthetic forcing the snow layers form after ~550 steps) and goes
by ``run_windows`` in windows of ``--window`` steps.  The float32 drift
comparison (``tests/test_torch_f32_drift.py``) runs it twice.
``--platform cpu`` runs on the CPU; the default is the card.  The file's
keys are the JAX script's: ``state_<field>`` and ``diag_<field>``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ncol", type=int, default=4)
    ap.add_argument("--steps", type=int, default=720)
    ap.add_argument("--window", type=int, default=240)
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32",
                    help="the model's dtype (the JAX script's --x64 is "
                         "--dtype float64)")
    ap.add_argument("--platform", default=None,
                    help="cpu: the CPU; default the card")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date

    pft, snicar = synthetic.parameter_files()
    model = Model(ncol=args.ncol, pft_path=pft, snicar_path=snicar,
                  dtype=getattr(torch, args.dtype),
                  device="cpu" if args.platform == "cpu" else None)
    diags = model.run_windows(Date.from_ymd(1985, 1, 1), args.steps,
                              window=args.window)
    out = {f"state_{k}": v.cpu().numpy()
           for k, v in zip(model.state._fields, model.state)}
    out.update({f"diag_{k}": v.cpu().numpy()
                for k, v in zip(diags._fields, diags)})
    np.savez(args.out, **out)
    print(f"wrote {args.out}: t_grnd_mean="
          f"{out['state_t_grnd'].mean():.4f} "
          f"h2osno_max={out['state_h2osno'].max():.4f} "
          f"snl_max={out['state_snl'].max()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
