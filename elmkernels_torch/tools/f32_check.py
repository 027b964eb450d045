"""Single-precision sanity: ``--steps`` coupled steps of the all-float32
model, reporting finiteness, physical ranges and the conservation errors
against the float32 contract (float64 closes errsol and errlon to
~1e-14; float32 must stay below 1e-3 W/m2, errh2osno below 1e-4 mm).

    python -m elmkernels_torch.tools.f32_check [--ncol 64] [--steps 48]
                                               [--platform cpu]

The port's twin of the JAX package's ``tools/f32_check.py``: the model in
``dtype=torch.float32`` (the JAX package's x64-off mode), from the
synthetic parameter files, ``run_scan`` from 1 January (the snow pack in
float32).  ``--platform cpu`` runs on the CPU; the default is the card.
One JSON line; exit 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ncol", type=int, default=64)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--platform", default=None,
                    help="cpu: the CPU; default the card")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date

    pft, snicar = synthetic.parameter_files()
    model = Model(ncol=args.ncol, pft_path=pft, snicar_path=snicar,
                  dtype=torch.float32,
                  device="cpu" if args.platform == "cpu" else None)
    # a winter start puts the snow pack through float32
    diags = model.run_scan(Date.from_ymd(1985, 1, 1), args.steps)
    state = model.state

    report = {}
    ok = True
    for name, arr in zip(state._fields, state):
        a = arr.cpu().numpy()
        if a.dtype.kind == "f" and not np.all(np.isfinite(a)):
            report[f"nonfinite_{name}"] = int((~np.isfinite(a)).sum())
            ok = False
    t = state.t_soisno.cpu().numpy()
    active = t != 0.0
    if active.any() and not (t[active].min() > 150.0
                             and t[active].max() < 350.0):
        report["t_range"] = [float(t[active].min()), float(t[active].max())]
        ok = False

    errsol = float(diags.errsol_max.max())
    errlon = float(diags.errlon_max.max())
    errh2osno = float(diags.errh2osno_max.max())
    report.update(dict(errsol_max=errsol, errlon_max=errlon,
                       errh2osno_max=errh2osno,
                       t_grnd_mean=float(state.t_grnd.mean()),
                       dtype=str(state.t_grnd.dtype),
                       device=str(model.device)))
    if errsol > 1e-3 or errlon > 1e-3 or errh2osno > 1e-4:
        ok = False
    report["ok"] = ok
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
