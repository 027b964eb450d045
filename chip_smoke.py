#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``elmkernels_torch``) on one card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and ``nvcc``:

1. prints the card and its power limit;
2. builds the CUDA kernels from ``elmkernels_torch/csrc`` (one ``nvcc``
   per source, all at once), prints ``ptxas``'s report (and fails if
   ``pdma_kernel`` spills) and the tile and stages K4's launch chose;
3. holds ``ci_hybrid_solve`` against its plain PyTorch version at
   2 x 262,144 leaves (c3 and mixed in float64 and float32, c4 in
   float64; mixed with traits that differ per leaf), and times the c3
   float32 case, the main path's mode and type, on that test problem;
4. holds ``pdma_solve`` against its plain version bit for bit at ten
   column counts from 1 to 262,145 and on views off 16-byte alignment,
   and times both and ``torch.linalg.solve`` at [262144, 21, 5];
5. drives the main path: ``Model(ncol=262144)`` with the production flags
   through one summer day (48 steps) with no timer installed, for ms/step,
   columns/s, the conservation contracts and each kernel's launches; then
   12 steps around noon again with each launch timed by CUDA events on the
   main path's own inputs (:class:`MainPathTimes`);
6. drives ``Model(ncol=8192)`` through 700 January steps, long enough for
   the synthetic forcing to build snow layers (they form after ~550), then
   48 steps further twice from that state: as before (the reference's
   pinned grain radius) and in a ``Model(elm_correct_snow_aging=True)``
   given a copy of the state, whose layered columns' radii must age
   within [SNW_RDS_MIN, SNW_RDS_MAX];
7. loops, bit for bit: the heterogeneous global grid at 8,192 columns
   (``Model.from_surfdata`` with month-per-file NetCDF forcing, phenology
   and aerosol deposition, all written by ``elmkernels_torch.data.
   synthetic``), 48 steps from one cold start by ``run``, ``run_scan``,
   ``run_scan_series`` and ``run_windows(series=True, window=24)``: every
   state field equal at atol 0, each loop's per-step diagnostics equal to
   the reductions of ``run``'s, and the ci solve run only in "mixed" mode;
8. the production loop at full width: ``Model.from_surfdata`` on the
   262,144-cell global grid with the synthetic forcing, ``run_windows(
   nsteps=96, window=48, series=True)`` with no timer installed (ms/step,
   columns/s, contracts, launches), the same 96 steps by ``run`` from a
   fresh model (the same state bit for bit, and its ms/step in the same
   call), then one 12-step window around noon under
   :class:`MainPathTimes`, whose first 16 ci solves (float32, "mixed",
   per-leaf traits) and first pentadiagonal solves are then held against
   their plain versions on the same inputs (K4's also on the main path's
   timed steps);
9. landunits: the production loop's grid and flags with per-column land
   types (``synthetic.landunit_map``: ~84 % soil, 10 % crop, 5 % wetland,
   the 1 % highest-latitude columns ice sheet, half of them with
   elevation classes; ice and wetland unvegetated) and live snow aging on
   synthetic ``snicar_drdt`` tables, ``run_windows(series=True,
   window=48)``, 96 steps from 1985-01-01 (ms/step, columns/s, contracts,
   columns and mean ``t_grnd`` per class, snow layers and aged radii,
   launches), then one timed 12-step window whose kept K1 and K4 calls
   are held against their plain versions;
10. prints the kernels line (``ms``, ``bound_ms`` and ``share_of_bound``
   per launch on the main path, ``prod_*`` the same on the production
   loop, ``land_*`` on the landunits phase, ``test_ms`` and ``plain_ms``
   on the test problems of 3 and 4), the card line, and
   ``{"ok": true, ...}`` last.

Any failed check raises and the script exits non-zero.  Synthetic
input files and the kernel builds go under ``build/`` in the checkout.
"""

from __future__ import annotations

import json
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
    ``late`` and left out of the times.  The inputs and results of the
    first ``keep`` calls are kept (copies), for holding the kernel against
    its plain version on the path's own inputs afterwards."""

    def __init__(self, module, attr: str, bound, prepare=lambda args: args,
                 keep: int = 0):
        self.module, self.attr = module, attr
        self.bound, self.prepare = bound, prepare
        self.orig = getattr(module, attr)
        self.calls = []
        self.keep, self.kept = keep, []

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
        if len(self.kept) < self.keep:
            self.kept.append((clone(args), clone(out)))
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


def clone(tree):
    """A copy of every tensor of a (nested) tuple; other leaves pass."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        vals = [clone(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def check_ci_on_path(kept, tol: float, label: str) -> dict:
    """ci_hybrid_solve's results on a path's own inputs (the calls a
    MainPathTimes kept) against hybrid_solve_plain on the same inputs."""
    import torch
    from elmkernels_torch.physics import photosynthesis as psn
    worst, worst_abs, eq, n, modes = 0.0, 0.0, 1.0, 0, {}
    same_nan = True
    for (x0, env, mode, en), (ci_k, out_k, it_k) in kept:
        ci_p, out_p, it_p = psn.hybrid_solve_plain(x0, env, mode, en)
        key = f"{mode} {str(x0.dtype).replace('torch.', '')}"
        modes[key] = modes.get(key, 0) + 1
        for a, b in zip((ci_k, *out_k), (ci_p, *out_p)):
            same_nan &= bool(torch.equal(torch.isnan(a), torch.isnan(b)))
            fin = torch.isfinite(b)
            diff = (a - b).abs()[fin]
            if diff.numel():
                worst_abs = max(worst_abs, diff.max().item())
                worst = max(worst, (diff / b.abs()[fin].clamp_min(1e-30))
                            .max().item())
        eq = min(eq, (it_k == it_p).double().mean().item())
        n += en.shape[0]
    # the trait fields (CiEnv's last four) that differ between leaves
    env = kept[0][0][1] if kept else None
    varying = [k for k in (env._fields[-4:] if env else ())
               if bool((getattr(env, k) != getattr(env, k)[0]).any())]
    res = dict(label=label, calls=len(kept), leaves=n, modes=modes,
               traits_varying_per_leaf=varying, max_rel=worst,
               max_abs=worst_abs, equal_iters=eq, same_nan=same_nan)
    phase("K1 ci_hybrid_solve vs plain on the path's inputs: "
          + json.dumps(res))
    if not (varying and same_nan and worst <= tol and eq >= 0.999):
        raise AssertionError(f"ci_hybrid_solve disagrees with its plain "
                             f"version on the {label}: {res}")
    return res


def check_pdma_on_path(kept, label: str) -> dict:
    """pdma_solve's results on a path's own inputs (the calls a
    MainPathTimes kept) against pdma_solve_plain on the same inputs, bit
    for bit."""
    import torch
    from elmkernels_torch.physics.soil_temperature import pdma_solve_plain
    worst, n, equal = 0.0, 0, True
    for (lhs, rhs), x in kept:
        xp = pdma_solve_plain(lhs, rhs)
        equal &= bool(torch.equal(x, xp))
        worst = max(worst, (x - xp).abs().max().item())
        n += lhs.shape[0]
    res = dict(label=label, calls=len(kept), columns=n, max_abs_x=worst,
               equal=equal)
    phase("K4 pdma_solve vs plain on the path's inputs: " + json.dumps(res))
    if not (kept and equal):
        raise AssertionError(f"pdma_solve differs from its plain version "
                             f"on the {label}: {res}")
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


class ModeSpy:
    """Counts the photosynthesis modes ``ci_hybrid_solve`` is called with
    while installed in its module's place (``with``); ``launches`` passes
    through to the wrapper."""

    def __init__(self, module):
        self.module = module
        self.orig = module.ci_hybrid_solve
        self.modes = {}

    @property
    def launches(self) -> int:
        return self.orig.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.orig.launches = n

    def __call__(self, x0, env, mode, enabled):
        self.modes[mode] = self.modes.get(mode, 0) + 1
        return self.orig(x0, env, mode, enabled)

    def __enter__(self):
        self.module.ci_hybrid_solve = self
        return self

    def __exit__(self, *exc):
        self.module.ci_hybrid_solve = self.orig


def reset(kernels: dict) -> None:
    for fn in kernels.values():
        fn.launches = 0


def counts(kernels: dict, label: str) -> dict:
    """Each kernel's launches since ``reset``; fails if one of them was
    not launched."""
    launches = {name: fn.launches for name, fn in kernels.items()}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{label}")
    return launches


def check_contracts(label: str, res: dict, led_bound: float = 1e-9) -> None:
    bad = [k for k, lim in (("errh2o_led", led_bound), ("errlon", 1e-8),
                            ("errsol", res["errsol_bound"]))
           if not res[k] < lim]
    if not res["finite"]:
        bad.append("non-finite state")
    if bad:
        raise AssertionError(f"{label} broke {bad}: {res}")


def finite(state) -> bool:
    import torch
    return all(bool(torch.isfinite(v).all()) for v in state
               if v.is_floating_point())


def drive(ncol: int, month: int, nsteps: int, files, label: str,
          kernels: dict, start_step: int = 0):
    """Run Model(ncol) with the production flags for nsteps from step
    ``start_step`` of the first of ``month``; returns the run summary, the
    launches of each kernel wrapper in ``kernels`` ({name: wrapper}),
    counted from 0 over the run, and the model."""
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date
    model = Model(ncol=ncol, pft_path=str(files[0]),
                  snicar_path=str(files[1]))
    start = Date.from_ymd(1985, month, 1)
    start.increment_seconds(start_step * int(model.dtime))
    res, launches = run_checked(model, start, nsteps, label, kernels)
    return res, launches, model


def run_checked(model, start, nsteps: int, label: str, kernels: dict,
                require_launches: bool = True):
    """``model.run(start, nsteps)``: ms/step, columns/s, the contracts of
    every step and the kernels' launches over the run (each must have been
    launched when ``require_launches``)."""
    import torch
    from elmkernels_torch.utils.guard import errsol_bound
    ncol = model.ncol
    worst = {"errh2o_led": 0.0, "errlon": 0.0, "errsol": 0.0,
             "errh2osno_steady": 0.0}
    iters, stamps = [], []

    def cb(date, state, d):
        for k in worst:
            worst[k] = max(worst[k], getattr(d, k).abs().max().item())
        iters.append(int(d.niters_canopy.max().item()))
        stamps.append(time.perf_counter())  # .item() has synchronized

    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.run(start, nsteps, cb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (counts(kernels, label) if require_launches else
                {name: fn.launches for name, fn in kernels.items()})
    st = model.state
    snl_max = int(st.snl.max().item())
    # steady rate: steps after the first (which loads the kernels)
    steady = (stamps[-1] - stamps[0]) / (nsteps - 1)
    res = dict(label=label, ncol=ncol, steps=nsteps, wall_s=wall,
               first_step_ms=(stamps[0] - t0) * 1e3,
               ms_per_step=steady * 1e3, columns_per_s=ncol / steady,
               finite=finite(st),
               snl_max=snl_max, columns_with_snow_layers=int(
                   (st.snl > 0).sum().item()),
               max_canopy_iters=max(iters), canopy_iters_total=sum(iters),
               launches=launches, **worst,
               errsol_bound=errsol_bound(ncol, nsteps))
    phase(f"{label}: " + json.dumps(res))
    check_contracts(label, res)
    return res, launches


def timed_summaries(t1, t4, launches: dict, label: str) -> dict:
    """Per-launch times of a timed run; every launch must have been
    timed."""
    on_path = {"ci_hybrid_solve": t1.summary(), "pdma_solve": t4.summary()}
    phase(f"kernels on the {label}: " + json.dumps(on_path))
    for name, count in launches.items():
        if count != on_path[name]["calls"]:
            raise AssertionError(f"{name}: {count} launches but "
                                 f"{on_path[name]['calls']} timed calls")
    return on_path


def timers(keep: int = 0, keep_pdma: int = 0):
    """MainPathTimes of K1 and K4, for ``with``; they keep the inputs and
    results of their first ``keep`` and ``keep_pdma`` calls."""
    from elmkernels_torch.ops import ci_solver, pdma

    # the canopy loop may hand the ci solve constant CiEnv fields as
    # expanded scalars, which its wrapper would copy inside the event pair
    def ci_layout(args):
        x0, env, mode, enabled = args
        return (x0.contiguous(), type(env)(*(t.contiguous() for t in env)),
                mode, enabled.contiguous())

    return (MainPathTimes(ci_solver, "ci_hybrid_solve",
                          lambda a, out: ci_bound(a[0], a[3], out[2]),
                          ci_layout, keep=keep),
            MainPathTimes(pdma, "pdma_solve",
                          lambda a, out: pdma_bound(a[0].shape[0]),
                          keep=keep_pdma))


LOOPS_NCOL = 8192
LOOPS_GRID = (64, 128)       # the NetCDF forcing's (lat, lon) grid
LOOPS_STEPS, LOOPS_WINDOW = 48, 24
# the closed water ledger on the global grid: f64 rounding of the rain
# terms reaches ~8e-9 mm on rainy columns, in the JAX package's step as
# in the port's (tests/test_torch_scan.py::test_water_ledger_residual_is_
# the_jax_packages).  These phases read 7.58e-9 (loops) and 7.32e-9
# (production loop) in every run on the card, deterministic on their
# inputs; the bound leaves 2.6 times the larger
GLOBAL_LEDGER_BOUND = 2e-8
PROD_NCOL = 262144
PROD_STEPS, PROD_WINDOW = 96, 48
# K1 is held against its plain version on the production loop's own
# inputs of this many calls (the first step's canopy iterations), K4 of
# this many (a step's each)
PROD_CI_KEPT = 16
PDMA_KEPT = 2
# the winter path runs this many steps further, pinned and aging
WINTER_STEPS, WINTER_MORE = 700, 48
# the landunits phase: the landunit map's seed, and the production loop's
# steps and window from 1985-01-01
LAND_SEED = 0
LAND_STEPS, LAND_WINDOW = 96, 48


def check_loops(files, kernels: dict) -> dict:
    """Phase 7: the four time loops on the heterogeneous grid, bit for
    bit, from one cold start."""
    import torch
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model, reduce_diags
    from elmkernels_torch.ops import ci_solver
    from elmkernels_torch.utils.dates import Date
    from elmkernels_torch.utils.guard import errsol_bound
    t0 = time.perf_counter()
    inputs = synthetic.write_global_inputs(
        REPO / "build" / "global", LOOPS_NCOL, forcing_grid=LOOPS_GRID)
    write_s = time.perf_counter() - t0
    surfdata = inputs.pop("surfdata")

    def model():
        return Model.from_surfdata(surfdata, LOOPS_NCOL,
                                   pft_path=str(files[0]),
                                   snicar_path=str(files[1]), **inputs)

    start = Date.from_ymd(1985, 7, 1)
    loops = {
        "run_scan": lambda m: m.run_scan(start, LOOPS_STEPS),
        "run_scan_series": lambda m: m.run_scan_series(start, LOOPS_STEPS),
        f"run_windows(series=True, window={LOOPS_WINDOW})":
            lambda m: m.run_windows(start, LOOPS_STEPS, window=LOOPS_WINDOW,
                                    series=True)}
    res = dict(ncol=LOOPS_NCOL, steps=LOOPS_STEPS,
               forcing_grid=list(LOOPS_GRID), write_inputs_s=write_s,
               loops={})
    with ModeSpy(ci_solver) as spy:
        m = model()
        res["psn_mode"] = m.psn_mode
        per_step = []
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run(start, LOOPS_STEPS,
              lambda date, state, d: per_step.append(reduce_diags(d)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ref_state = m.state
        ref = type(per_step[0])(*(torch.cat(v) for v in zip(*per_step)))
        res["loops"]["run"] = dict(ms_per_step=wall / LOOPS_STEPS * 1e3,
                                   launches=counts(kernels, "loops, run"))
        for name, fn in loops.items():
            m = model()
            reset(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = fn(m)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            state_diff = [k for k in ref_state._fields if not torch.equal(
                getattr(ref_state, k), getattr(m.state, k))]
            diag_diff = [k for k in ref._fields if not torch.equal(
                getattr(ref, k), getattr(d, k))]
            res["loops"][name] = dict(
                ms_per_step=wall / LOOPS_STEPS * 1e3,
                launches=counts(kernels, f"loops, {name}"),
                state_fields_differing=state_diff,
                diagnostics_differing=diag_diff)
            if state_diff or diag_diff:
                raise AssertionError(f"{name} differs from run: state "
                                     f"{state_diff}, diagnostics "
                                     f"{diag_diff}")
    res.update(ci_modes=spy.modes, finite=finite(ref_state),
               errh2o_led=ref.errh2o_led_max.max().item(),
               errlon=ref.errlon_max.max().item(),
               errsol=ref.errsol_max.max().item(),
               errsol_bound=errsol_bound(LOOPS_NCOL, LOOPS_STEPS))
    phase("loops, bit for bit: " + json.dumps(res))
    if res["psn_mode"] != "mixed" or set(spy.modes) != {"mixed"}:
        raise AssertionError(f"the ci solve ran in modes {spy.modes}, "
                             f"not only 'mixed'")
    check_contracts("loops", res, led_bound=GLOBAL_LEDGER_BOUND)
    return res


def production_loop(files, inputs: dict, kernels: dict):
    """Phase 8: ``run_windows`` over the 262,144-column global grid, with
    no timer installed, then one 12-step window under the timers.
    ``inputs`` are :func:`global_inputs`."""
    import torch
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date
    from elmkernels_torch.utils.guard import errsol_bound
    inputs = dict(inputs)
    write_s = inputs.pop("write_s")
    surfdata = inputs.pop("surfdata")

    def model():
        return Model.from_surfdata(surfdata, PROD_NCOL,
                                   pft_path=str(files[0]),
                                   snicar_path=str(files[1]), **inputs)

    t0 = time.perf_counter()
    m = model()
    build_s = time.perf_counter() - t0
    stamps = []

    def window_done(date, state, d):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = m.run_windows(Date.from_ymd(1985, 7, 1), PROD_STEPS,
                      window=PROD_WINDOW, series=True, callback=window_done)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernels, "production loop")
    steady = (stamps[1] - stamps[0]) / PROD_WINDOW
    res = dict(label="production loop", ncol=PROD_NCOL, steps=PROD_STEPS,
               window=PROD_WINDOW, loop="run_windows(series=True)",
               psn_mode=m.psn_mode, write_inputs_s=write_s,
               model_build_s=build_s, wall_s=wall,
               ms_per_step=wall / PROD_STEPS * 1e3,
               columns_per_s=PROD_NCOL * PROD_STEPS / wall,
               second_window_ms_per_step=steady * 1e3,
               second_window_columns_per_s=PROD_NCOL / steady,
               finite=finite(m.state), launches=launches,
               errh2o_led=d.errh2o_led_max.max().item(),
               errlon=d.errlon_max.max().item(),
               errsol=d.errsol_max.max().item(),
               errsol_bound=errsol_bound(PROD_NCOL, PROD_STEPS),
               max_canopy_iters=int(d.niters_canopy_max.max().item()),
               canopy_iters_total=int(d.niters_canopy_max.sum().item()))
    phase("production loop: " + json.dumps(res))
    check_contracts("production loop", res, led_bound=GLOBAL_LEDGER_BOUND)
    if m.psn_mode != "mixed":
        raise AssertionError(f"production grid ran {m.psn_mode!r}")

    # the same 96 steps by run, the per-step loop, from a fresh model: the
    # same state bit for bit at full width, and its ms/step in this call
    m_run = model()
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_run.run(Date.from_ymd(1985, 7, 1), PROD_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_run = dict(label="production grid by run", ncol=PROD_NCOL,
                  steps=PROD_STEPS, wall_s=wall,
                  ms_per_step=wall / PROD_STEPS * 1e3,
                  columns_per_s=PROD_NCOL * PROD_STEPS / wall,
                  launches=counts(kernels, "production grid by run"),
                  state_fields_differing=[
                      k for k in m.state._fields if not torch.equal(
                          getattr(m.state, k), getattr(m_run.state, k))])
    phase("production grid by run: " + json.dumps(by_run))
    if by_run["state_fields_differing"]:
        raise AssertionError("run and run_windows differ at full width: "
                             f"{by_run['state_fields_differing']}")
    del m_run

    # one 12-step window around noon of the third day, each launch timed
    noon = Date.from_ymd(1985, 7, 3)
    noon.increment_seconds(18 * int(m.dtime))
    t1, t4 = timers(keep=PROD_CI_KEPT, keep_pdma=PDMA_KEPT)
    with t1, t4:
        reset(kernels)
        m.run_windows(noon, 12, window=12, series=True)
        timed = counts(kernels, "production loop, timed")
    on_prod = timed_summaries(t1, t4, timed, "production loop")
    check_ci_on_path(t1.kept, 1e-5, "production loop")
    check_pdma_on_path(t4.kept, "production loop")
    return res, launches, on_prod


def global_inputs() -> dict:
    """The 262,144-cell global grid's surfdata, phenology and deposition
    files, written once for the production and landunits phases: their
    ``Model.from_surfdata`` keywords, ``surfdata`` and ``write_s``."""
    from elmkernels_torch.data import synthetic
    t0 = time.perf_counter()
    inputs = synthetic.write_global_inputs(REPO / "build" / "global",
                                           PROD_NCOL)
    inputs["write_s"] = time.perf_counter() - t0
    return inputs


def winter_aging(model, files, kernels: dict) -> dict:
    """The winter path's model 48 steps further as it is (the reference's
    pinned radius), and a copy of its state as far in a model with live
    snow aging: contracts in both; on the aging run's layered columns the
    radii lie in [SNW_RDS_MIN, SNW_RDS_MAX] and differ from the pinned
    run's."""
    import torch
    from elmkernels_torch import constants as c
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date
    aged = Model(ncol=model.ncol, pft_path=str(files[0]),
                 snicar_path=str(files[1]), elm_correct_snow_aging=True,
                 snow_aging_path=str(files[2]))
    aged.state = clone(model.state)
    start = Date.from_ymd(1985, 1, 1)
    start.increment_seconds(WINTER_STEPS * int(model.dtime))
    pinned, _ = run_checked(model, start.copy(), WINTER_MORE,
                            "winter path, pinned radius", kernels,
                            require_launches=False)
    live, _ = run_checked(aged, start.copy(), WINTER_MORE,
                          "winter path, snow aging", kernels,
                          require_launches=False)
    snl = aged.state.snl
    lev = torch.arange(c.NLEVSNO, device=snl.device)[None, :]
    active = (lev >= c.NLEVSNO - snl[:, None]) & (snl[:, None] > 0)
    rds = aged.state.snw_rds[active]
    differs = ((aged.state.snw_rds != model.state.snw_rds) & active).any(1)
    layered = snl > 0
    res = dict(layered_columns=int(layered.sum().item()),
               layered_columns_aged=int((differs & layered).sum().item()),
               active_layers=int(active.sum().item()),
               snw_rds_min=rds.min().item(), snw_rds_max=rds.max().item(),
               snw_rds_mean=rds.mean().item(),
               pinned_ms_per_step=pinned["ms_per_step"],
               aging_ms_per_step=live["ms_per_step"])
    phase("winter path, aging against pinned: " + json.dumps(res))
    share = res["layered_columns_aged"] / max(res["layered_columns"], 1)
    if not (res["layered_columns"] and share >= 0.9
            and c.SNW_RDS_MIN <= res["snw_rds_min"]
            and res["snw_rds_max"] <= c.SNW_RDS_MAX
            and res["snw_rds_max"] > c.SNW_RDS_MIN):
        raise AssertionError(f"the snow grains did not age as they "
                             f"should: {res}")
    return res


class ColumnLedger:
    """Each column's largest |errh2o_led| over a run, kept on the card by
    wrapping ``model._step`` while installed (``with``): two launches a
    step and no host wait.  The device loops reduce their diagnostics
    over the columns; this keeps them apart by land class."""

    def __init__(self, model):
        import torch
        self.model, self.orig = model, model._step
        self.worst = torch.zeros(model.ncol, dtype=model.dtype,
                                 device=model.device)

    def __call__(self, forc, phen):
        import torch
        d = self.orig(forc, phen)
        torch.maximum(self.worst, d.errh2o_led.abs(), out=self.worst)
        return d

    def __enter__(self):
        self.model._step = self
        return self

    def __exit__(self, *exc):
        del self.model._step


def landunits(files, inputs: dict, kernels: dict, prod_ms: float):
    """Phase 9: the production loop's grid with per-column land types and
    live snow aging, 96 steps from 1985-01-01 with no timer installed,
    then one 12-step window under the timers, whose kept K1 and K4 calls
    are held against their plain versions."""
    import torch
    from elmkernels_torch import constants as c
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.data.surfdata import read_surfdata
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date
    from elmkernels_torch.utils.guard import errsol_bound
    inputs = dict(inputs)
    inputs.pop("write_s")
    surfdata = inputs.pop("surfdata")
    sd = read_surfdata(surfdata, PROD_NCOL)
    ltype = synthetic.landunit_map(sd.lat_deg, LAND_SEED)
    vtype = synthetic.landunit_vtypes(sd.vtype, ltype)
    t0 = time.perf_counter()
    m = Model.from_surfdata(surfdata, PROD_NCOL, pft_path=str(files[0]),
                            snicar_path=str(files[1]), ltype=ltype,
                            vtype=vtype.tolist(), elm_correct_snow_aging=True,
                            snow_aging_path=str(files[2]), **inputs)
    build_s = time.perf_counter() - t0
    stamps = []

    def window_done(date, state, d):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ColumnLedger(m) as ledger:
        d = m.run_windows(Date.from_ymd(1985, 1, 1), LAND_STEPS,
                          window=LAND_WINDOW, series=True,
                          callback=window_done)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernels, "landunits")
    st = m.state
    lt = m.params.ltype
    classes = {}
    for name, code in (("soil", c.ISTSOIL), ("crop", c.ISTCROP),
                       ("ice", c.ISTICE), ("ice_mec", c.ISTICE_MEC),
                       ("wetland", c.ISTWET)):
        sel = lt == code
        classes[name] = dict(columns=int(sel.sum().item()),
                             t_grnd_mean=st.t_grnd[sel].mean().item(),
                             errh2o_led=ledger.worst[sel].max().item())
    # the reference deletes the snow that falls on a wetland whose ground
    # is above freezing (canopy_hydrology.snow_init), a sink the closed
    # ledger does not carry: wetland columns read the deleted snowfall, as
    # in the JAX package (tests/test_torch_landunits.py), and the ledger
    # contract holds on the other classes
    wet = lt == c.ISTWET
    lev = torch.arange(c.NLEVSNO, device=lt.device)[None, :]
    active = (lev >= c.NLEVSNO - st.snl[:, None]) & (st.snl[:, None] > 0)
    steady = (stamps[1] - stamps[0]) / LAND_WINDOW
    res = dict(label="landunits", ncol=PROD_NCOL, steps=LAND_STEPS,
               window=LAND_WINDOW, loop="run_windows(series=True)",
               psn_mode=m.psn_mode, model_build_s=build_s, wall_s=wall,
               ms_per_step=wall / LAND_STEPS * 1e3,
               columns_per_s=PROD_NCOL * LAND_STEPS / wall,
               second_window_ms_per_step=steady * 1e3,
               second_window_columns_per_s=PROD_NCOL / steady,
               ms_per_step_over_production_loop=wall / LAND_STEPS * 1e3
               / prod_ms,
               classes=classes,
               columns_with_snow_layers=int((st.snl > 0).sum().item()),
               columns_with_aged_radius=int(
                   ((st.snw_rds > c.SNW_RDS_MIN) & active).any(1).sum()
                   .item()),
               finite=finite(st), launches=launches,
               errh2o_led=ledger.worst[~wet].max().item(),
               errh2o_led_wetland=ledger.worst[wet].max().item(),
               errh2o_led_all_columns=d.errh2o_led_max.max().item(),
               errlon=d.errlon_max.max().item(),
               errsol=d.errsol_max.max().item(),
               errsol_bound=errsol_bound(PROD_NCOL, LAND_STEPS),
               max_canopy_iters=int(d.niters_canopy_max.max().item()),
               canopy_iters_total=int(d.niters_canopy_max.sum().item()))
    phase("landunits: " + json.dumps(res))
    check_contracts("landunits", res, led_bound=GLOBAL_LEDGER_BOUND)
    if not all(v["columns"] for v in classes.values()):
        raise AssertionError(f"a land class has no column: {classes}")
    if not classes["ice"]["t_grnd_mean"] < classes["soil"]["t_grnd_mean"]:
        raise AssertionError(f"ice columns not colder than soil: {classes}")

    # one 12-step window around noon of the third day, each launch timed
    noon = Date.from_ymd(1985, 1, 3)
    noon.increment_seconds(18 * int(m.dtime))
    t1, t4 = timers(keep=PROD_CI_KEPT, keep_pdma=PDMA_KEPT)
    with t1, t4:
        reset(kernels)
        m.run_windows(noon, 12, window=12, series=True)
        timed = counts(kernels, "landunits, timed")
    on_land = timed_summaries(t1, t4, timed, "landunits")
    check_ci_on_path(t1.kept, 1e-5, "landunits")
    check_pdma_on_path(t4.kept, "landunits")
    return res, launches, on_land


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

    t_script = time.perf_counter()
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
    # the production loop's type and mode: float32, "mixed", per-leaf traits
    check_ci(n_leaves, "mixed", torch.float32, 1e-5, time_it=False)
    k4 = check_pdma(262144)

    files_dir = REPO / "build" / "synthetic"
    files_dir.mkdir(parents=True, exist_ok=True)
    files = (files_dir / "clm_params.nc", files_dir / "snicar_optics.nc",
             files_dir / "snicar_drdt.nc")
    synthetic.write_clm_params(files[0])
    synthetic.write_snicar_optics(files[1])
    synthetic.write_snow_aging_tables(files[2])

    wrappers = {"ci_hybrid_solve": ci_solver.ci_hybrid_solve,
                "pdma_solve": pdma.pdma_solve}
    # end-to-end numbers from a run with no timer installed; the kernels'
    # times per launch from 12 steps around noon under the timers
    main_run, launches, _ = drive(262144, 7, 48, files, "main path",
                                  wrappers)
    t1, t4 = timers(keep_pdma=PDMA_KEPT)
    with t1, t4:
        _, timed, _ = drive(262144, 7, 12, files, "main path, timed",
                            wrappers, start_step=18)
    on_path = timed_summaries(t1, t4, timed, "main path")
    k4_path = check_pdma_on_path(t4.kept, "main path")
    del t1, t4
    winter, _, winter_model = drive(8192, 1, WINTER_STEPS, files,
                                    "winter path", wrappers)
    if winter["snl_max"] == 0:
        raise AssertionError("winter path made no snow layers")
    winter_aging(winter_model, files, wrappers)
    del winter_model
    check_loops(files, wrappers)
    inputs = global_inputs()
    prod, prod_launches, on_prod = production_loop(files, inputs, wrappers)
    _, land_launches, on_land = landunits(files, inputs, wrappers,
                                          prod["ms_per_step"])

    def numbers(name, test):
        m, p, g = on_path[name], on_prod[name], on_land[name]
        return dict(launches=launches[name], ms=m["ms"],
                    bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                    share_of_bound=m["share_of_bound"],
                    plain_ms=test["plain_ms"], test_ms=test["test_ms"],
                    test_bound_ms=test["test_bound_ms"],
                    test_share_of_bound=test["test_share_of_bound"],
                    prod_launches=prod_launches[name], prod_ms=p["ms"],
                    prod_bound_ms=p["bound_ms"],
                    prod_share_of_bound=p["share_of_bound"],
                    land_launches=land_launches[name], land_ms=g["ms"],
                    land_bound_ms=g["bound_ms"],
                    land_share_of_bound=g["share_of_bound"])

    kernels = [
        dict(name="ci_hybrid_solve", route="cuda",
             source="elmkernels_torch/csrc/ci_hybrid_solve.cu",
             replaces="elmkernels_tpu/physics/photosynthesis.py:238",
             max_abs_err=k1["max_abs_ci"], library_ms=None,
             **numbers("ci_hybrid_solve", k1)),
        dict(name="pdma_solve", route="cuda",
             source="elmkernels_torch/csrc/pdma_solve.cu",
             replaces="elmkernels_tpu/physics/soil_temperature.py:282",
             max_abs_err=max(k4["max_abs_x"], k4_path["max_abs_x"]),
             library_ms=k4["library_ms"],
             **numbers("pdma_solve", k4)),
    ]
    phase(f"script: {time.perf_counter() - t_script:.1f} s after start")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
