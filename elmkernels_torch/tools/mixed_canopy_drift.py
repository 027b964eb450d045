"""Season-scale drift of the canopy production modes: ``mixed_canopy``
(the float32 canopy-loop interior) and ``mixed_canopy+warm_start``
against the model with both off, on a heterogeneous batch (latitudes
across both hemispheres, every soil class, mixed C3/C4 PFTs), from 1
January (winter) and 1 July (summer).

    MCD_NCOL=1024 MCD_DAYS=15 python -m elmkernels_torch.tools.mixed_canopy_drift

The port's twin of the JAX package's ``tools/mixed_canopy_drift.py``, with
its knobs and output keys: per configuration and season, each field's
largest drift over the rows active in both runs, the columns whose snow
layer counts disagree, the closed water ledger, the radiation closure,
the snow balance, the sensible heat's RMSE and the wall seconds; and the
``warm_start`` rows against ``mixed_canopy`` alone.

  MCD_NCOL      columns (default 1024; a multiple of 4)
  MCD_DAYS      simulated days a run (default 15)
  MCD_WINDOW    steps a ``run_windows`` window (default 240; the steps
                are cut to whole windows)
  MCD_PLATFORM  ``cpu``: run on the CPU; default the card
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

DRIFT_FIELDS = ("t_veg", "t_grnd", "t_soisno", "h2osno", "h2ocan",
                "h2osoi_liq", "h2osoi_ice", "snow_depth")

# layered fields whose snow rows mean something only while the layer is
# active (inactive rows hold stale values; comparing them across runs
# whose packs bifurcated reports drift that is not physical)
_SNOW_LAYERED = ("t_soisno", "h2osoi_liq", "h2osoi_ice")


def field_drift(name, a, b, snl_a, snl_b) -> float:
    """Max |a - b| over rows active in BOTH runs (soil rows always are);
    columns whose layer counts disagree are counted separately."""
    from elmkernels_torch import constants as c
    d = np.abs(a - b)
    if name in _SNOW_LAYERED and a.ndim == 2:
        lay = np.arange(a.shape[1])[None, :]
        both = ((lay >= c.NLEVSNO - snl_a[:, None])
                & (lay >= c.NLEVSNO - snl_b[:, None]))
        d = np.where(both, d, 0.0)
    return float(np.max(d))


def hetero_kw(ncol: int) -> dict:
    i = np.arange(ncol)
    return dict(
        ncol=ncol,
        lat_deg=-55.0 + 125.0 * (i % (ncol // 2)) / (ncol // 2),
        lon_deg=(i * 360.0 / 64.0) % 360.0,
        soil_color=(i % 20) + 1,
        pct_sand=20.0 + (i % 7) * 8.0,
        pct_clay=10.0 + (i % 5) * 6.0,
        organic=2.0 + (i % 11) * 8.0,
        vtype=[int(v) for v in (1, 12, 14, 23)] * (ncol // 4))


def _np(nt) -> dict:
    return {k: v.cpu().numpy() for k, v in nt._asdict().items()}


def run_one(kw, start, nsteps, window, device, **mode):
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    pft, snicar = synthetic.parameter_files()
    m = Model(**kw, **mode, pft_path=pft, snicar_path=snicar, device=device)
    diags = m.run_windows(start, nsteps, window=window)
    return _np(m.state), _np(diags)


def main() -> int:
    from elmkernels_torch.utils.dates import Date
    device = "cpu" if os.environ.get("MCD_PLATFORM") == "cpu" else None
    ncol = int(os.environ.get("MCD_NCOL", "1024"))
    days = int(os.environ.get("MCD_DAYS", "15"))
    window = int(os.environ.get("MCD_WINDOW", "240"))
    nsteps = days * 48
    nsteps -= nsteps % window
    if ncol % 4 or nsteps == 0:
        print(f"# MCD_NCOL={ncol} must be a multiple of 4 and MCD_DAYS * 48"
              f" hold at least one MCD_WINDOW={window}", file=sys.stderr)
        return 2
    kw = hetero_kw(ncol)

    results = {}
    for season, (mm, dd) in (("winter", (1, 1)), ("summer", (7, 1))):
        t0 = time.time()
        # the baseline pins the canopy modes off (the Model's defaults
        # include them)
        ref, d_ref = run_one(kw, Date.from_ymd(1985, mm, dd), nsteps,
                             window, device, mixed_canopy=False,
                             warm_start=False)
        print(f"# {season} ref done in {time.time() - t0:.0f}s",
              file=sys.stderr)
        season_states = {}
        for label, mode in (
                ("mixed_canopy", dict(mixed_canopy=True, warm_start=False)),
                ("mixed_canopy+warm", dict(mixed_canopy=True,
                                           warm_start=True))):
            t0 = time.time()
            st, d = run_one(kw, Date.from_ymd(1985, mm, dd), nsteps,
                            window, device, **mode)
            season_states[label] = st
            drift = {name: field_drift(name, ref[name], st[name],
                                       ref["snl"], st["snl"])
                     for name in DRIFT_FIELDS}
            res = {
                "drift": drift,
                # layer creation flips under any last-ulp perturbation:
                # columns whose counts disagree are left out of the
                # layered rows' drift above and counted here
                "snl_mismatch_cols": int(np.sum(ref["snl"] != st["snl"])),
                "errh2o_led_max": float(np.abs(d["errh2o_led_max"]).max()),
                "errsol_max": float(np.abs(d["errsol_max"]).max()),
                "errh2osno_max": float(np.abs(d["errh2osno_max"]).max()),
                "eflx_sh_mean_rmse": float(np.sqrt(np.mean(
                    (d["eflx_sh_mean"] - d_ref["eflx_sh_mean"]) ** 2))),
                "finite": bool(np.all(np.isfinite(st["t_veg"]))),
                "wall_s": round(time.time() - t0, 1)}
            results[f"{season}/{label}"] = res
            print(f"# {season}/{label}: max t drift "
                  f"{max(drift['t_veg'], drift['t_grnd'], drift['t_soisno']):.4f} K, "
                  f"ledger {res['errh2o_led_max']:.2e}, "
                  f"errsol {res['errsol_max']:.2e}, "
                  f"sh rmse {res['eflx_sh_mean_rmse']:.3f} W/m2",
                  file=sys.stderr)
        # warm_start should be near trajectory-neutral: its drift against
        # mixed_canopy alone, measured
        a, b = (season_states["mixed_canopy"],
                season_states["mixed_canopy+warm"])
        results[f"{season}/warm_vs_mixed"] = {
            "drift": {name: field_drift(name, a[name], b[name], a["snl"],
                                        b["snl"])
                      for name in DRIFT_FIELDS},
            "snl_mismatch_cols": int(np.sum(a["snl"] != b["snl"]))}
    print(json.dumps({"ncol": ncol, "days": days, "nsteps": nsteps,
                      "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
