"""Step-by-step gaps between the port and the JAX package on the
heterogeneous grid of ``test_torch_scan.py``, on the CPU.

    python tests/torch_lockstep_gaps.py [--flags production|no-mixed-canopy|
        no-mixed-radiation|no-warm-start|exact] [--resync] [--two-stream]

Builds the 16-column mixed C3/C4 shard of ``test_torch_scan.py`` from the
port-written files, advances the JAX and the port model in lockstep for
its eight steps and prints one JSON line per step: the largest ratio of a
state or diagnostics gap to the 1e-5 criterion's bound
(``|port - jax| / (floor + 1e-5 |jax|)``, with the floors of
``test_torch_step.prod_atol``; above 1 the 1e-5 lockstep fails), its
field and column, that ratio over the columns whose canopy iteration
counts agreed in every step so far, the columns whose counts differ, and
the largest ci iteration gap.  ``--resync`` gives the port the JAX state
before every step, so each line is one step's gap from the same state.
``--two-stream`` records the JAX production step 1 op by op, and prints
the two-stream solver's largest float32 error against its float64 result
on the same inputs, for the JAX package (compiled and op by op) and the
port.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import test_torch_scan as sc  # noqa: E402
import test_torch_step as ts  # noqa: E402
import torch_parity as tp  # noqa: E402
from elmkernels_torch.data import synthetic  # noqa: E402

FLAGS = {"production": ts.PRODUCTION, "exact": ts.EXACT,
         "no-mixed-canopy": dict(ts.PRODUCTION, mixed_canopy=False),
         "no-mixed-radiation": dict(ts.PRODUCTION, mixed_radiation=False),
         "no-warm-start": dict(ts.PRODUCTION, warm_start=False)}


def write_grid(d: pathlib.Path) -> dict:
    """The input files of ``test_torch_scan.grid``."""
    pft, snicar = tp.write_files(d)
    synthetic.write_global_surfdata(d / "surfdata.nc", sc.NCELL)
    synthetic.write_phenology(d / "phen.nc", sc.NCELL)
    synthetic.write_aerosol_deposition(d / "aero.nc", sc.NCELL)
    synthetic.write_forcing_months(str(d / "forc_"), 1985, 7, 2, sc.NLAT,
                                   sc.NLON)
    return dict(surfdata=str(d / "surfdata.nc"), pft_path=pft,
                snicar_path=snicar, forcing_basename=str(d / "forc_"),
                phenology_path=str(d / "phen.nc"),
                aerosol_path=str(d / "aero.nc"))


def ratio(name, a, b, same):
    """(largest ratio, its column; the same over the ``same`` columns)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(tp.as_numpy(b), np.float64)
    r = np.abs(b - a) / (ts.prod_atol(name) + ts.PROD_RTOL * np.abs(a))
    r = np.where(np.isnan(r), 0.0, r).reshape(a.shape[0], -1).max(axis=1)
    return float(r.max()), int(r.argmax()), float(r[same].max())


def lockstep(grid, flags, resync: bool) -> None:
    jm = sc._jax_model(grid, flags)
    tm = sc.torch_model(grid, **flags)
    jd, td = sc._date(sc.JDate), sc._date(sc.TDate)
    same = np.ones(sc.NCOL, bool)
    for i in range(sc.NSTEPS):
        if resync:
            tp.carry_model(jm, tm)
        jdg, tdg = jm.advance(jd), tm.advance(td)
        jd.increment_seconds(1800)
        td.increment_seconds(1800)
        jc = np.asarray(jdg.niters_canopy)
        differ = np.nonzero(jc != tdg.niters_canopy.numpy())[0]
        same &= jc == tdg.niters_canopy.numpy()
        worst = dict(ratio=0.0, field=None, column=None, ratio_agreeing=0.0)
        for kind, j, t in (("state", jm.state, tm.state),
                           ("diags", jdg, tdg)):
            for name in j._fields:
                if name in ("niters_ci", "niters_canopy"):
                    continue
                r, col, r_same = ratio(name, getattr(j, name),
                                       getattr(t, name), same)
                if r > worst["ratio"]:
                    worst.update(ratio=r, field=f"{kind}.{name}",
                                 column=col)
                worst["ratio_agreeing"] = max(worst["ratio_agreeing"],
                                              r_same)
        gap = np.abs(tdg.niters_ci.numpy() - np.asarray(jdg.niters_ci))
        print(json.dumps(dict(step=i, **worst,
                              canopy_counts_differ=differ.tolist(),
                              ci_iters_gap=int(gap.max()))), flush=True)


def two_stream(grid) -> None:
    from elmkernels_tpu.physics import surface_albedo as jsa
    calls = sc.record_production_step(grid)
    key = ("physics.surface_albedo", "two_stream_solver")
    args, _, eager = calls[key][0]
    with jax.default_device(jax.devices("cpu")[0]):
        compiled = jax.jit(lambda *a: jsa.two_stream_solver(
            args[0], args[1], *a))(*args[2:])
        f64 = jsa.two_stream_solver(*sc.as_float64(args))
    port = sc._replay(*key, calls[key][0])
    res = {}
    for (path, e, p), (_, c, _), (_, x, _) in zip(
            sc._arrays(eager, port, "ts"), sc._arrays(compiled, compiled,
                                                      "ts"),
            sc._arrays(f64, f64, "ts")):
        x = x.astype(np.float64)
        errs = [float(np.abs(np.asarray(v, np.float64) - x).max())
                for v in (c, e, p)]
        if max(errs) > 1e-6:
            res[path.split(".")[-1]] = dict(
                jax_compiled=errs[0], jax_op_by_op=errs[1], port=errs[2],
                scale=float(np.abs(x).max()))
    print(json.dumps(dict(two_stream_float32_error=res)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flags", choices=list(FLAGS), default="production")
    ap.add_argument("--resync", action="store_true")
    ap.add_argument("--two-stream", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        grid = write_grid(pathlib.Path(d))
        if args.two_stream:
            two_stream(grid)
        else:
            lockstep(grid, FLAGS[args.flags], args.resync)
    return 0


if __name__ == "__main__":
    sys.exit(main())
