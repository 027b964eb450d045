#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``elmkernels_torch``) on one card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and ``nvcc``:

1. prints the card and its power limit;
2. builds the CUDA kernels from ``elmkernels_torch/csrc`` (one ``nvcc``
   per source, all at once), prints ``ptxas``'s report (and fails if
   ``pdma_kernel`` spills) and the tile and stages K4's launch chose;
3. holds ``ci_hybrid_solve`` against its plain PyTorch version at
   2 x 262,144 leaves (float64 and float32; c4 and mixed in float64), and
   times the float32 case, the main path's type, on that test problem;
4. holds ``pdma_solve`` against its plain version bit for bit at ten
   column counts from 1 to 262,145 and on views off 16-byte alignment,
   and times both and ``torch.linalg.solve`` at [262144, 21, 5];
5. drives the main path: ``Model(ncol=262144)`` with the production flags
   through one summer day (48 steps), checks the state and the
   conservation contracts, counts each kernel's launches, and times each
   launch with CUDA events on the main path's own inputs
   (:class:`MainPathTimes`);
6. drives ``Model(ncol=8192)`` through 700 January steps, long enough for
   the synthetic forcing to build snow layers (they form after ~550);
7. prints the kernels line (``ms``, ``bound_ms`` and ``share_of_bound``
   per launch on the main path; ``test_ms`` and ``plain_ms`` on the test
   problems of 3 and 4), the card line, and ``{"ok": true, ...}`` last.

Any failed check raises and the script exits non-zero.  Synthetic
parameter files and the kernel builds go under ``build/`` in the checkout.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
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
PDMA_ROWS = 21
# K4 is held against its plain version at each of these column counts
# (odd and even, below, at and past a 32-column tile, the winter and the
# main path's widths) and on offset views at PDMA_MISALIGNED_NCOLS
PDMA_NCOLS = (1, 2, 3, 63, 64, 65, 8192, 8193, 262144, 262145)
PDMA_MISALIGNED_NCOLS = (65, 262144)
# the main-path timing holds the card this many clock cycles before each
# timed call: >= 1 ms at the H100's highest SM clock, MAX_SM_HZ
GUARD_CYCLES = 2_000_000
MAX_SM_HZ = 1.98e9


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


def ci_bound(x0, enabled, iters):
    """(bytes ms, operations ms) of one ci solve: bytes are the 20 inputs
    and ``enabled`` read, the 7 outputs and the iterations written;
    operations the residual evaluations these leaves needed (the two
    starting ones, the secant steps, the overflow re-evaluation; Brent's
    steps not counted).  The operations time stays a tensor on the card,
    so that no call waits on it."""
    from elmkernels_torch.physics.photosynthesis import SECANT_ITMAX
    n, itemsize = x0.shape[0], x0.element_size()
    nbytes = n * (20 * itemsize + 1 + 7 * itemsize + 4)
    it = iters.double()
    evals = (enabled.double() * (2 + it + (iters > SECANT_ITMAX).double())
             ).sum()
    dtype = str(x0.dtype).replace("torch.", "")
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            evals * CI_FUNC_FLOPS / PEAK_FLOPS[dtype] * 1e3)


class MainPathTimes:
    """Times every call of a kernel's entry point, ``module.attr``, while
    installed in its place (``with``): a CUDA event pair around each call,
    and the call's bound from its own inputs by ``bound(args, out)`` ->
    (bytes ms, operations ms).  The callers import the entry point at call
    time, so replacing the module's attribute reaches them.  The entry
    point counts its launches on itself by its module-level name, which
    then names this object: ``launches`` passes through to the original.

    ``prepare(args)`` lays the inputs out as the kernel takes them
    (contiguous) before the timed call, with the same values, so that the
    entry point's own layout copies fall outside the event pair.  Before
    each call the card is held by ``torch.cuda._sleep`` for GUARD_CYCLES,
    so that the host has queued the kernel before the start event is
    reached: the pair then times the card's work, not the host's Python
    between the events.  A call whose host side outlasted the guard is
    ``late`` and left out of the times."""

    def __init__(self, module, attr: str, bound, prepare=lambda args: args):
        self.module, self.attr = module, attr
        self.bound, self.prepare = bound, prepare
        self.orig = getattr(module, attr)
        self.calls = []

    @property
    def launches(self) -> int:
        return self.orig.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.orig.launches = n

    def __call__(self, *args):
        import torch
        args = self.prepare(args)
        h0 = time.perf_counter()
        torch.cuda._sleep(GUARD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.orig(*args)
        stop.record()
        host_s = time.perf_counter() - h0
        self.calls.append((start, stop, host_s, self.bound(args, out)))
        return out

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)

    def summary(self) -> dict:
        """Device ms per launch, bound per launch and its share, over the
        calls that were not late."""
        import torch
        torch.cuda.synchronize()
        guard_s = GUARD_CYCLES / MAX_SM_HZ
        on_time = [c for c in self.calls if c[2] <= guard_s]
        if not on_time:
            raise AssertionError(f"{self.attr}: every timed call outlasted "
                                 f"the {guard_s * 1e3:.2f} ms guard")
        n = len(on_time)
        ms = sum(a.elapsed_time(b) for a, b, _, _ in on_time) / n
        t_bytes = [float(b) for *_, (b, _) in on_time]
        t_ops = [float(o) for *_, (_, o) in on_time]
        bound = sum(map(max, t_bytes, t_ops)) / n
        host_ms = sorted(c[2] * 1e3 for c in self.calls)
        return dict(calls=len(self.calls), late=len(self.calls) - n,
                    host_ms_median=host_ms[len(host_ms) // 2],
                    host_ms_max=host_ms[-1], ms=ms, bound_ms=bound,
                    share_of_bound=bound / ms,
                    bound_by="bytes" if sum(t_bytes) >= sum(t_ops)
                    else "operations")


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
        res["test_ms"] = cuda_ms(lambda: ci_hybrid_solve(x0, env, mode, en),
                                 20)
        res["plain_ms"] = cuda_ms(
            lambda: psn.hybrid_solve_plain(x0, env, mode, en), 3)
        t_bytes, t_ops = ci_bound(x0, en, it_k)
        t_ops = t_ops.item()
        res["test_bound_ms"] = max(t_bytes, t_ops)
        res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        res["test_share_of_bound"] = res["test_bound_ms"] / res["test_ms"]
    phase("K1 ci_hybrid_solve vs plain: " + json.dumps(res))
    if not ok:
        raise AssertionError(f"ci_hybrid_solve disagrees with its plain "
                             f"version: {res}")
    return res


def pdma_bound(ncol: int):
    """(bytes ms, operations ms) of one pentadiagonal solve of ``ncol``
    columns: 105 + 21 doubles read and 21 written per column, against
    19 flops per row."""
    return (ncol * (PDMA_ROWS * 7) * 8 / HBM_BYTES_PER_S * 1e3,
            ncol * PDMA_ROWS * PDMA_ROW_FLOPS / PEAK_FLOPS["float64"] * 1e3)


def check_pdma(ncol: int):
    """pdma_solve against pdma_solve_plain, bit for bit, at every column
    count of PDMA_NCOLS and on views one column past a 16-byte boundary;
    then times both and torch.linalg.solve at ``ncol`` columns."""
    import torch
    from elmkernels_torch.ops import testing
    from elmkernels_torch.ops.pdma import pdma_solve
    from elmkernels_torch.physics.soil_temperature import pdma_solve_plain
    n_all = max(PDMA_NCOLS) + 1
    lhs_np, rhs_np = testing.pdma_problem(n_all, 7)
    lhs_all = torch.tensor(lhs_np, device="cuda")
    rhs_all = torch.tensor(rhs_np, device="cuda")
    cases = [(f"ncol={n}", lhs_all[:n], rhs_all[:n]) for n in PDMA_NCOLS]
    # views at a storage offset of one column (840 B and 168 B)
    for n in PDMA_MISALIGNED_NCOLS:
        lv, rv = lhs_all[1:n + 1], rhs_all[1:n + 1]
        if lv.data_ptr() % 16 == 0 or rv.data_ptr() % 16 == 0:
            raise AssertionError("the offset views came out 16-B aligned")
        cases.append((f"ncol={n}, one-column offset view", lv, rv))
    worst = 0.0
    for label, lhs, rhs in cases:
        xk = pdma_solve(lhs, rhs)
        xp = pdma_solve_plain(lhs, rhs)
        torch.cuda.synchronize()
        max_abs = (xk - xp).abs().max().item()
        phase(f"K4 pdma_solve vs plain, {label}: max_abs_x {max_abs}")
        if not (torch.equal(xk, xp) and max_abs == 0.0):
            raise AssertionError(f"pdma_solve differs from its plain "
                                 f"version at {label}: {max_abs}")
        worst = max(worst, max_abs)

    lhs, rhs = lhs_all[:ncol], rhs_all[:ncol]
    # the same systems as dense [ncol, 21, 21] matrices for the library
    n = PDMA_ROWS
    dense = torch.zeros(ncol, n, n, dtype=lhs.dtype, device="cuda")
    rows = torch.arange(n, device="cuda")
    for band, off in enumerate((2, 1, 0, -1, -2)):
        cols = rows + off
        ok = (cols >= 0) & (cols < n)
        dense[:, rows[ok], cols[ok]] = lhs[:, rows[ok], band]
    xp = pdma_solve_plain(lhs, rhs)
    xl = torch.linalg.solve(dense, rhs)
    rel_lib = ((xl - xp).abs() / xp.abs().clamp_min(1.0)).max().item()
    res = dict(ncol=ncol, max_abs_x=worst, max_rel_linalg=rel_lib)
    res["test_ms"] = cuda_ms(lambda: pdma_solve(lhs, rhs), 50)
    res["plain_ms"] = cuda_ms(lambda: pdma_solve_plain(lhs, rhs), 5)
    res["library_ms"] = cuda_ms(lambda: torch.linalg.solve(dense, rhs), 5)
    t_bytes, t_ops = pdma_bound(ncol)
    res["test_bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    res["test_share_of_bound"] = res["test_bound_ms"] / res["test_ms"]
    phase("K4 pdma_solve timing: " + json.dumps(res))
    return res


def drive(ncol: int, month: int, nsteps: int, files, label: str,
          kernels: dict):
    """Run Model(ncol) with the production flags for nsteps from the first
    of ``month``; returns the run summary and the launches of each kernel
    wrapper in ``kernels`` ({name: wrapper}), counted from 0 over the
    run."""
    import torch
    from elmkernels_torch.driver.model import Model
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

    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.run(Date.from_ymd(1985, month, 1), nsteps, cb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
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
    from elmkernels_torch.ops import build, ci_solver, pdma

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
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        build.ptxas_report("pdma_solve"))
    if not spills or any(n != "0" for pair in spills for n in pair):
        raise AssertionError(f"pdma_kernel spills: {spills}")
    phase("K4 pdma_kernel launch layout: " + json.dumps(pdma.layout()))

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

    wrappers = {"ci_hybrid_solve": ci_solver.ci_hybrid_solve,
                "pdma_solve": pdma.pdma_solve}
    # the canopy loop hands the ci solve four constant CiEnv fields as
    # expanded scalars, which its wrapper would copy inside the event pair
    def ci_layout(args):
        x0, env, mode, enabled = args
        return (x0.contiguous(), type(env)(*(t.contiguous() for t in env)),
                mode, enabled.contiguous())

    with MainPathTimes(ci_solver, "ci_hybrid_solve",
                       lambda a, out: ci_bound(a[0], a[3], out[2]),
                       ci_layout) as t1, \
            MainPathTimes(pdma, "pdma_solve",
                          lambda a, out: pdma_bound(a[0].shape[0])) as t4:
        main_run, launches = drive(262144, 7, 48, files, "main path",
                                   wrappers)
    on_path = {"ci_hybrid_solve": t1.summary(), "pdma_solve": t4.summary()}
    phase("kernels on the main path: " + json.dumps(on_path))
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
        if count != on_path[name]["calls"]:
            raise AssertionError(f"{name}: {count} launches but "
                                 f"{on_path[name]['calls']} timed calls")
    winter, _ = drive(8192, 1, 700, files, "winter path", wrappers)
    if winter["snl_max"] == 0:
        raise AssertionError("winter path made no snow layers")

    def on_main_path(name, test):
        m = on_path[name]
        return dict(launches=launches[name], ms=m["ms"],
                    bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                    share_of_bound=m["share_of_bound"],
                    plain_ms=test["plain_ms"], test_ms=test["test_ms"],
                    test_bound_ms=test["test_bound_ms"],
                    test_share_of_bound=test["test_share_of_bound"])

    kernels = [
        dict(name="ci_hybrid_solve", route="cuda",
             source="elmkernels_torch/csrc/ci_hybrid_solve.cu",
             replaces="elmkernels_tpu/physics/photosynthesis.py:238",
             max_abs_err=k1["max_abs_ci"], library_ms=None,
             **on_main_path("ci_hybrid_solve", k1)),
        dict(name="pdma_solve", route="cuda",
             source="elmkernels_torch/csrc/pdma_solve.cu",
             replaces="elmkernels_tpu/physics/soil_temperature.py:282",
             max_abs_err=k4["max_abs_x"], library_ms=k4["library_ms"],
             **on_main_path("pdma_solve", k4)),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
