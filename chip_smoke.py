#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``elmkernels_torch``) on one card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and ``nvcc``:

1. prints the card and its power limit;
2. builds the CUDA kernels from ``elmkernels_torch/csrc`` (one ``nvcc``
   per source, all at once);
3. holds ``ci_hybrid_solve`` against its plain PyTorch version at
   2 x 262,144 leaves (float64 and float32; c4 and mixed in float64), and
   reports the float32 case, the main path's, in the kernels line;
4. holds ``pdma_solve`` against its plain version and times
   ``torch.linalg.solve`` on the same systems, [262144, 21, 5];
5. drives the main path: ``Model(ncol=262144)`` with the production flags
   through one summer day (48 steps), checks the state and the
   conservation contracts, and counts each kernel's launches;
6. drives ``Model(ncol=8192)`` through 700 January steps, long enough for
   the synthetic forcing to build snow layers (they form after ~550);
7. prints the kernels line, the card line, and ``{"ok": true, ...}`` last.

Any failed check raises and the script exits non-zero.  Synthetic
parameter files and the kernel builds go under ``build/`` in the checkout.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent

# card peaks used for the bounds (NVIDIA H100 SXM data sheet, dense, at
# the 700 W limit): HBM bytes/s and FP64/FP32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34.0e12, "float32": 67.0e12}
# flops of one ci residual evaluation (ci_func: ~40 mul/add, 7 div,
# 3 sqrt, counting each as one)
CI_FUNC_FLOPS = 70
# flops of one pentadiagonal row (forward elimination + back substitution)
PDMA_ROW_FLOPS = 19


def phase(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches after a warm-up
    call, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def errsol_bound(ncol: int, nsteps: int, base: float = 2.5e-5) -> float:
    """Shortwave-closure contract of the mixed-radiation production flags,
    scaled with the number of column-steps (the JAX package's
    ``utils/guard.py:errsol_bound``)."""
    n = ncol * nsteps / (8192.0 * 48.0)
    return base * math.sqrt(1.0 + max(0.0, math.log2(n)) / 2.0)


def check_ci(n: int, mode: str, dtype, tol: float, time_it: bool):
    """ci_hybrid_solve against hybrid_solve_plain on the same leaves."""
    import torch
    from elmkernels_torch.ops import testing
    from elmkernels_torch.ops.ci_solver import ci_hybrid_solve
    from elmkernels_torch.physics import photosynthesis as psn
    x0, env, en = testing.ci_problem_tensors(n, 2024, mode, dtype, "cuda")
    ci_k, out_k, it_k = ci_hybrid_solve(x0, env, mode, en)
    ci_p, out_p, it_p = psn.hybrid_solve_plain(x0, env, mode, en)
    torch.cuda.synchronize()
    same_nan = bool(torch.equal(torch.isnan(ci_k), torch.isnan(ci_p)))
    fin = torch.isfinite(ci_p)
    diff = (ci_k - ci_p).abs()[fin]
    rel = (diff / ci_p.abs()[fin].clamp_min(1e-30)).max().item()
    max_abs = diff.max().item()
    eq_iters = (it_k == it_p).double().mean().item()
    ok = same_nan and rel <= tol and eq_iters >= 0.999
    res = dict(mode=mode, dtype=str(dtype).replace("torch.", ""),
               max_rel_ci=rel, max_abs_ci=max_abs, equal_iters=eq_iters,
               same_nan=same_nan)
    if time_it:
        res["ms"] = cuda_ms(lambda: ci_hybrid_solve(x0, env, mode, en), 20)
        res["plain_ms"] = cuda_ms(
            lambda: psn.hybrid_solve_plain(x0, env, mode, en), 3)
        # bound: bytes (21 inputs + enabled read, 7 outputs + iters written)
        # against operations (residual evaluations this data needed: the
        # two starting ones + secant steps + the overflow re-evaluation,
        # Brent steps not counted)
        itemsize = x0.element_size()
        nbytes = n * (20 * itemsize + 1 + 7 * itemsize + 4)
        evals = (en.double() * (2 + it_k.double()
                                + (it_k > 40).double())).sum().item()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = evals * CI_FUNC_FLOPS / PEAK_FLOPS[res["dtype"]] * 1e3
        res["bound_ms"] = max(t_bytes, t_ops)
        res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    phase("K1 ci_hybrid_solve vs plain: " + json.dumps(res))
    if not ok:
        raise AssertionError(f"ci_hybrid_solve disagrees with its plain "
                             f"version: {res}")
    return res


def check_pdma(ncol: int):
    """pdma_solve against pdma_solve_plain and torch.linalg.solve."""
    import torch
    from elmkernels_torch.ops import testing
    from elmkernels_torch.ops.pdma import pdma_solve
    from elmkernels_torch.physics.soil_temperature import pdma_solve_plain
    lhs_np, rhs_np = testing.pdma_problem(ncol, 7)
    lhs = torch.tensor(lhs_np, device="cuda")
    rhs = torch.tensor(rhs_np, device="cuda")
    xk = pdma_solve(lhs, rhs)
    xp = pdma_solve_plain(lhs, rhs)
    # the same systems as dense [ncol, 21, 21] matrices for the library
    n = lhs.shape[1]
    dense = torch.zeros(ncol, n, n, dtype=lhs.dtype, device="cuda")
    rows = torch.arange(n, device="cuda")
    for band, off in enumerate((2, 1, 0, -1, -2)):
        cols = rows + off
        ok = (cols >= 0) & (cols < n)
        dense[:, rows[ok], cols[ok]] = lhs[:, rows[ok], band]
    xl = torch.linalg.solve(dense, rhs)
    torch.cuda.synchronize()
    scale = xp.abs().clamp_min(1e-300)
    rel = ((xk - xp).abs() / scale).max().item()
    rel_lib = ((xl - xp).abs() / scale.clamp_min(1.0)).max().item()
    res = dict(ncol=ncol, max_rel_x=rel, max_abs_x=(xk - xp).abs().max()
               .item(), max_rel_linalg=rel_lib)
    res["ms"] = cuda_ms(lambda: pdma_solve(lhs, rhs), 50)
    res["plain_ms"] = cuda_ms(lambda: pdma_solve_plain(lhs, rhs), 5)
    res["library_ms"] = cuda_ms(lambda: torch.linalg.solve(dense, rhs), 5)
    nbytes = ncol * (n * 5 + n + n) * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ncol * n * PDMA_ROW_FLOPS / PEAK_FLOPS["float64"] * 1e3
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    phase("K4 pdma_solve vs plain: " + json.dumps(res))
    if not rel <= 1e-10:
        raise AssertionError(f"pdma_solve disagrees with its plain version: "
                             f"{res}")
    return res


def drive(ncol: int, month: int, nsteps: int, files, label: str):
    """Run Model(ncol) with the production flags for nsteps from the first
    of ``month``; returns the run summary and the launches per kernel."""
    import torch
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.ops.ci_solver import ci_hybrid_solve
    from elmkernels_torch.ops.pdma import pdma_solve
    from elmkernels_torch.utils.dates import Date
    model = Model(ncol=ncol, pft_path=str(files[0]),
                  snicar_path=str(files[1]))
    worst = {"errh2o_led": 0.0, "errlon": 0.0, "errsol": 0.0,
             "errh2osno_steady": 0.0}
    iters, stamps = [], []

    def cb(date, state, d):
        for k in worst:
            worst[k] = max(worst[k], getattr(d, k).abs().max().item())
        iters.append(int(d.niters_canopy.max().item()))
        stamps.append(time.perf_counter())  # .item() has synchronized

    ci_hybrid_solve.launches = 0
    pdma_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.run(Date.from_ymd(1985, month, 1), nsteps, cb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ci_hybrid_solve": ci_hybrid_solve.launches,
                "pdma_solve": pdma_solve.launches}
    st = model.state
    finite = all(bool(torch.isfinite(v).all()) for v in st
                 if v.is_floating_point())
    snl_max = int(st.snl.max().item())
    # steady rate: steps after the first (which loads the kernels)
    steady = (stamps[-1] - stamps[0]) / (nsteps - 1)
    res = dict(label=label, ncol=ncol, steps=nsteps, wall_s=wall,
               first_step_ms=(stamps[0] - t0) * 1e3,
               ms_per_step=steady * 1e3, columns_per_s=ncol / steady,
               finite=finite,
               snl_max=snl_max, columns_with_snow_layers=int(
                   (st.snl > 0).sum().item()),
               max_canopy_iters=max(iters), canopy_iters_total=sum(iters),
               launches=launches, **worst,
               errsol_bound=errsol_bound(ncol, nsteps))
    phase(f"{label}: " + json.dumps(res))
    bad = []
    if not finite:
        bad.append("non-finite state")
    if not worst["errh2o_led"] < 1e-9:
        bad.append("errh2o_led")
    if not worst["errlon"] < 1e-8:
        bad.append("errlon")
    if not worst["errsol"] < res["errsol_bound"]:
        bad.append("errsol")
    if bad:
        raise AssertionError(f"{label} broke {bad}: {res}")
    return res, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "elmkernels_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.ops import build

    card = card_line()
    phase(f"device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible); card: {card}")

    t0 = time.perf_counter()
    times = build.build()
    phase(f"build: {time.perf_counter() - t0:.1f} s "
          + json.dumps({k: round(v, 1) for k, v in times.items()}))
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                phase(f"  ptxas {name}: {line.strip()}")

    # the main path's production flags run the canopy loop, and so the ci
    # solve, in float32 (mixed_canopy): its numbers go in the kernels line
    n_leaves = 2 * 262144
    check_ci(n_leaves, "c3", torch.float64, 1e-12, time_it=True)
    k1 = check_ci(n_leaves, "c3", torch.float32, 1e-5, time_it=True)
    check_ci(n_leaves, "c4", torch.float64, 1e-12, time_it=False)
    check_ci(n_leaves, "mixed", torch.float64, 1e-12, time_it=False)
    k4 = check_pdma(262144)

    files_dir = REPO / "build" / "synthetic"
    files_dir.mkdir(parents=True, exist_ok=True)
    files = (files_dir / "clm_params.nc", files_dir / "snicar_optics.nc")
    synthetic.write_clm_params(files[0])
    synthetic.write_snicar_optics(files[1])

    main_run, launches = drive(262144, 7, 48, files, "main path")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    winter, _ = drive(8192, 1, 700, files, "winter path")
    if winter["snl_max"] == 0:
        raise AssertionError("winter path made no snow layers")

    kernels = [
        dict(name="ci_hybrid_solve", route="cuda",
             source="elmkernels_torch/csrc/ci_hybrid_solve.cu",
             replaces="elmkernels_tpu/physics/photosynthesis.py:238",
             launches=launches["ci_hybrid_solve"],
             max_abs_err=k1["max_abs_ci"], ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="pdma_solve", route="cuda",
             source="elmkernels_torch/csrc/pdma_solve.cu",
             replaces="elmkernels_tpu/physics/soil_temperature.py:282",
             launches=launches["pdma_solve"], max_abs_err=k4["max_abs_x"],
             ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=k4["library_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
