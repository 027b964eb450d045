"""Single-column demo run, the reference's ``kokkos_driver.cc:27-91``:
start 1985-07-01 12:00, 100 x 1800 s steps, print prognostics each step.

    python -m elmkernels_torch.examples.run_single_column [--ncol N]
        [--steps N] [--device cpu]

The port's twin of the JAX package's ``examples/run_single_column.py``.
The model is built from the synthetic parameter files under ``build/``
(``elmkernels_torch/data/synthetic.py``), since the reference's are not
in the repo; it runs on the card unless ``--device cpu`` is given.
"""

import argparse

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ncol", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain PyTorch path; default the "
                         "first CUDA device")
    args = ap.parse_args(argv)

    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date

    pft, snicar = synthetic.parameter_files()
    model = Model(ncol=args.ncol, pft_path=pft, snicar_path=snicar,
                  device=args.device)
    start = Date.from_ymd(1985, 7, 1, 12 * 3600)

    def report(date, state, diags):
        i = 0  # column 0, like the reference's single-cell print
        v = torch.stack([state.t_grnd[i], state.h2osno[i], state.h2ocan[i],
                         state.snl[i].to(state.t_grnd.dtype), diags.fsa[i],
                         diags.eflx_sh_tot[i], diags.qflx_evap_tot[i],
                         diags.errh2o[i], diags.errseb[i]]).tolist()
        print(f"{date.year:04d}-{date.doy + 1:03d} {date.sec:5d}  "
              f"t_grnd={v[0]:8.3f}  h2osno={v[1]:9.4f}  h2ocan={v[2]:7.4f}  "
              f"snl={int(v[3])}  fsa={v[4]:8.2f}  eflx_sh={v[5]:8.2f}  "
              f"qflx_evap={v[6]:.3e}  errh2o={v[7]:+.2e}  "
              f"errseb={v[8]:+.2e}")

    last = model.run(start, args.steps, callback=report)
    print(f"final errsol_max={float(last.errsol.abs().max()):.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
