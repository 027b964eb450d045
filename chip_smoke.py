#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``elmkernels_torch``) on one card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and ``nvcc``:

1. prints the card and its power limit;
2. builds the CUDA kernels from ``elmkernels_torch/csrc`` (one ``nvcc``
   per source, all at once), prints ``ptxas``'s report (and fails if
   ``pdma_kernel`` spills) and the tile and stages K4's launch chose;
   then, while this process holds no device memory, runs the capacity
   probe's twin (``python -m elmkernels_torch.tools.capacity_probe``) at
   2^20 columns of the global grid, a 24-step window from 1985-01-15:
   ms/step, columns/s, errsol against its bound, the allocator's peak,
   peak bytes a column and columns a card; where 2^20 does not fit, the
   allocator's message, and the width halved until one fits;
3. holds ``ci_hybrid_solve`` against its plain PyTorch version at
   2 x 262,144 leaves (c3 and mixed in float64 and float32, c4 in
   float64; mixed with traits that differ per leaf), and times the c3
   float32 case, the main path's mode and type, on that test problem;
   holds ``ci_hybrid_solve_jvp`` (K1-T) bit for bit against
   ``torch.func.jvp`` of the plain solve on 2 x 262,144 "mixed" leaves at
   dry shares 0.25 and 1.0 and profiles it there (:func:`k1t_profile`:
   ms, bound, evaluations a leaf by kind, warp efficiency, the f64 pipe's
   floor; registers, spills and resident blocks from a probe build);
4. holds ``pdma_solve`` (float64) and ``pdma_solve_f32`` (float32)
   against their plain versions bit for bit at ten column counts from 1
   to 262,145 and on views off 16-byte alignment, and times each, its
   plain version and ``torch.linalg.solve`` at [262144, 21, 5];
5. drives the main path: ``Model(ncol=262144)`` with the production flags
   through half a summer day (24 steps) with no timer installed, for ms/step,
   columns/s, the conservation contracts and each kernel's launches; then
   12 steps around noon again with each launch timed by CUDA events on the
   main path's own inputs (:class:`MainPathTimes`); then the same model
   in float32 (``dtype=torch.float32``) 12 steps at noon, each
   ``pdma_solve_f32`` launch timed and its first calls held against the
   plain version bit for bit (errsol and errlon under 1e-3, as
   ``tests/test_f32_drift.py``);
6. drives ``Model(ncol=8192)`` through 700 January steps, long enough for
   the synthetic forcing to build snow layers (they form after ~550), then
   48 steps further twice from that state: as before (the reference's
   pinned grain radius) and in a ``Model(elm_correct_snow_aging=True)``
   given a copy of the state, whose layered columns' radii must age
   within [SNW_RDS_MIN, SNW_RDS_MAX];
7. reference formats: the main path's model built from the synthetic
   optics written as the reference's SnowOptics text fixture
   (``ops.testing.write_snow_optics_text``) and from the same tables as
   NetCDF, 12 steps of each from 1985-07-01 12:00 by ``run_windows(
   series=True)``: tables, state and diagnostics equal bit for bit, the
   main path's contracts, K1's and K4's launches; then 4 steps of the
   text-optics model under :class:`MainPathTimes`, K1 and K4 held against
   their plain versions on the calls kept; then ``snicar_ad_rt`` with
   each flag against its half of ``snicar_ad_rt_both``, bit for bit, at
   262,144 columns of seeded snow (0-5 layers) and of the winter path's
   state tiled, each sweep timed;
8. loops, bit for bit: the heterogeneous global grid at 8,192 columns
   (``Model.from_surfdata`` with month-per-file NetCDF forcing, phenology
   and aerosol deposition, all written by ``elmkernels_torch.data.
   synthetic``), 12 steps from one cold start by ``run``, ``run_scan``,
   ``run_scan_series`` and ``run_windows(series=True, window=6)``: every
   state field equal at atol 0, each loop's per-step diagnostics equal to
   the reductions of ``run``'s, and the ci solve run only in "mixed" mode;
   then the same ``run_windows`` split over ranks, each a subprocess of
   this script (``--shard-rank``): two ranks sharing the card on a gloo
   group, their state carry packed, then one rank on an NCCL group; every
   rank's block must equal
   the unsharded final state bit for bit on every field and its global
   diagnostics the unsharded reductions (maxima exactly, means to rtol
   1e-12), with K1 and K4 launched (and timed) on every rank and their
   first calls held against their plain versions; each of the three
   device loops again with the packed carry (``Model(packed_carry=True)``),
   equal to ``run`` bit for bit (state and diagnostics), its ms/step beside
   the unpacked loop's and the bytes its carry copied a step; and one
   packed carry update at 262,144 columns timed by CUDA events;
9. the production loop at full width: ``Model.from_surfdata`` on the
   262,144-cell global grid with the synthetic forcing, ``run_windows(
   nsteps=48, window=24, series=True)`` with no timer installed (ms/step,
   columns/s, contracts, launches), the same 48 steps by ``run`` from a
   fresh model (the same state bit for bit, and its ms/step in the same
   call), then one 12-step window around noon under
   :class:`MainPathTimes`, whose first 16 ci solves (float32, "mixed",
   per-leaf traits) and first pentadiagonal solves are then held against
   their plain versions on the same inputs (K4's also on the main path's
   timed steps);
10. landunits: the production loop's grid and flags with per-column land
   types (``synthetic.landunit_map``: ~84 % soil, 10 % crop, 5 % wetland,
   the 1 % highest-latitude columns ice sheet, half of them with
   elevation classes; ice and wetland unvegetated) and live snow aging on
   synthetic ``snicar_drdt`` tables, ``run_windows(series=True,
   window=24)``, 48 steps from 1985-01-01 (ms/step, columns/s, contracts,
   columns and mean ``t_grnd`` per class, snow layers and aged radii,
   launches), then one timed 12-step window whose kept K1 and K4 calls
   are held against their plain versions;
11. operations, on the production loop's grid: a ``RunConfig`` builds
   the model, ``run_windows(series=True, window=24)`` runs 48 steps with a
   ``StepGuard`` checking each window, ``MetricsLogger`` lines and a
   ``HistoryWriter``; a checkpoint written after window 1 restores into a
   fresh model that runs window 2 to the same state bit for bit; a strict
   guard (``errh2o_led_max=0``) trips and rolls back to window 1 bit for
   bit; ``MinimalInterface`` runs 8 host-forced steps at 262,144 columns
   against a twin on its own providers (rtol 1e-9, atol 1e-12), then the
   NaN-forcing recovery round trip, equal to a twin bit for bit; and
   ``python -m elmkernels_torch.run_model`` runs a small JSON config;
12. sensitivity: the global grid under the exact flags, ``run_jvp`` for 2
   steps from 1985-07-01 06:00 seeded by ``tbot`` (untimed: its ms/step
   against the primal's, the launches of K1, K1-T and K4) and by
   ``watsat`` (under the timers); tangents finite; the primal unchanged by
   seeding; the ``tbot`` tangents of four fluxes against central
   differences (h = 1e-3 K, rtol 2e-3, atol 1e-4) on the columns where
   the perturbed runs take the same solver iterations and are smooth; the
   first kept K1-T and K4 tangent calls against their plain versions
   (K1-T bit for bit) and K1-T's profile on its kept calls; then one
   ``run_jvp`` step from 12:00 UTC, where K1-T's leaves need the solve
   (:func:`sens_noon`: every launch timed, the first calls profiled and
   held bit for bit);
13. the bench twin as a user runs it, one run at a time, alone on the
   card: ``python -m elmkernels_torch.bench`` at its defaults, with
   ``BENCH_PACKED=1``, with ``BENCH_HETERO=1`` and with ``BENCH_F32=1
   BENCH_DAYS=1`` (each JSON line printed beside the card line; the
   global-grid bench times one day);
14. then, started together as subprocesses (they share the card and the
   host): ``elmkernels_torch.tools.long_run`` at 8,192 columns for 48
   steps (resume bit for bit, no guard trip),
   ``elmkernels_torch.examples.run_single_column``, and the twins of the
   JAX package's last tools at the smallest depth that runs each through:
   ``f32_check`` (64 columns, 12 steps, the float32 contracts),
   ``mixed_canopy_drift`` (1,024 columns, one day, both seasons) and
   ``weak_scaling`` (one rank: it says that it measures no scaling on one
   card);
15. the native reader (``elmkernels_torch/io/native.py``, built with g++
   from ``elmkernels_torch/csrc/elmio.cc``): July and August month files
   at the full width (262,144 cells on 512 x 512, 3-hourly, 1.82 GB each,
   written once under ``build/ingest``) read by it and by scipy, every
   variable in a 48-step window's slabs, equal at atol 0; a prefetched
   open equal to a cold one; one window's reads timed by each reader;
16. ingest: ``ingest_bench``'s files mode at 262,144 columns, in-process:
   ``run_windows(series=True)`` from those files through the native
   reader with next-month prefetch, in 12-step windows from 31 July 12:00
   (the second timed window loads August on the host thread), against the
   pre-staged
   ``run_scan_series`` windows, bit for bit (pre-staged and overlapped
   ms/step, their ratio, host assembly cold and warm; K1's and K4's
   launches counted from 0 over it);
17. prints each phase's seconds, the kernels line (``ms``, ``bound_ms`` and ``share_of_bound``
   per launch on the main path, ``prod_*`` the same on the production
   loop, ``land_*`` on the landunits phase, ``sens_*`` on the sensitivity
   path, ``test_ms`` and ``plain_ms`` on the test problems of 3 and 4;
   K1-T's entry, ``ci_hybrid_solve_jvp``, from the sensitivity path,
   ``sens_noon_*`` from its noon step;
   ``refformats_*`` on the reference formats phase's text-optics model;
   ``shard_*`` per rank of the sharded runs; ``ingest_launches`` and
   ``capacity_launches`` on the ingest path and the capacity run;
   ``pdma_solve_f32``'s entry from the float32 path), the card line, and
   ``{"ok": true, ...}`` last.

``python3 chip_smoke.py --k1t-profile`` runs K1-T's profile alone
(:func:`k1t_profile_main`).

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


def guarded_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after a warm-up,
    each held between CUDA events that the card reaches only after a
    GUARD_CYCLES sleep, so that the host's time to launch ``fn`` (its
    wrapper's checks and allocations) falls outside the pair, as in
    :class:`MainPathTimes`."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(GUARD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def ci_evals(x0, env, mode, enabled):
    """The residual evaluations these leaves' solves need: the starting
    ones, the secant steps, the overflow re-evaluation and Brent's steps
    that each leaf commits, counted by the plain solve's masks
    (``testing.ci_eval_counts``; it waits on the card)."""
    from elmkernels_torch.ops import testing
    counts = testing.ci_eval_counts(x0, env, mode, enabled)
    return float(sum(c.double().sum() for c in counts.values()))


def ci_bound(x0, env, mode, enabled):
    """(bytes ms, operations ms) of one ci solve: bytes are the 20 inputs
    and ``enabled`` read, the 7 outputs and the iterations written;
    operations the residual evaluations these leaves need
    (:func:`ci_evals`, Brent's steps included)."""
    n, itemsize = x0.shape[0], x0.element_size()
    nbytes = n * (20 * itemsize + 1 + 7 * itemsize + 4)
    dtype = str(x0.dtype).replace("torch.", "")
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            ci_evals(x0, env, mode, enabled) * CI_FUNC_FLOPS
            / PEAK_FLOPS[dtype] * 1e3)


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
                    bytes_ms=sum(t_bytes) / n, operations_ms=sum(t_ops) / n,
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
        t_bytes, t_ops = ci_bound(x0, env, mode, en)
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


def check_ci_on_path(kept, tol: float, label: str,
                     per_leaf_traits: bool = True) -> dict:
    """ci_hybrid_solve's results on a path's own inputs (the calls a
    MainPathTimes kept) against hybrid_solve_plain on the same inputs;
    with ``per_leaf_traits`` (a heterogeneous grid's path) the traits must
    differ between leaves."""
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
    if not (kept and (varying or not per_leaf_traits) and same_nan
            and worst <= tol and eq >= 0.999):
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


def pdma_bound(ncol: int, dtype: str = "float64"):
    """(bytes ms, operations ms) of one pentadiagonal solve of ``ncol``
    columns in ``dtype``: 105 + 21 elements read and 21 written per
    column, against 19 flops per row."""
    itemsize = {"float64": 8, "float32": 4}[dtype]
    return (ncol * (PDMA_ROWS * 7) * itemsize / HBM_BYTES_PER_S * 1e3,
            ncol * PDMA_ROWS * PDMA_ROW_FLOPS / PEAK_FLOPS[dtype] * 1e3)


def check_pdma(ncol: int, dtype=None):
    """K4 in ``dtype`` (float64 by default; float32 through
    ``pdma_solve_f32``) against pdma_solve_plain in that type, bit for
    bit, at every column count of PDMA_NCOLS and on views one column past
    a 16-byte boundary; then times both and torch.linalg.solve at
    ``ncol`` columns."""
    import torch
    from elmkernels_torch.ops import pdma, testing
    from elmkernels_torch.physics.soil_temperature import pdma_solve_plain
    dtype = dtype or torch.float64
    name = "float64" if dtype == torch.float64 else "float32"
    pdma_solve = pdma.pdma_solve if name == "float64" else pdma.pdma_solve_f32
    n_all = max(PDMA_NCOLS) + 1
    lhs_np, rhs_np = testing.pdma_problem(n_all, 7)
    lhs_all = torch.tensor(lhs_np, device="cuda", dtype=dtype)
    rhs_all = torch.tensor(rhs_np, device="cuda", dtype=dtype)
    cases = [(f"ncol={n}", lhs_all[:n], rhs_all[:n]) for n in PDMA_NCOLS]
    # views at a storage offset of one column (840 B and 168 B in
    # float64, 420 B and 84 B in float32)
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
        phase(f"K4 {pdma_solve.__name__} vs plain, {label}: max_abs_x "
              f"{max_abs}")
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
    res = dict(kernel=pdma_solve.__name__, dtype=name, ncol=ncol,
               max_abs_x=worst, max_rel_linalg=rel_lib)
    res["test_ms"] = cuda_ms(lambda: pdma_solve(lhs, rhs), 50)
    res["plain_ms"] = cuda_ms(lambda: pdma_solve_plain(lhs, rhs), 5)
    res["library_ms"] = cuda_ms(lambda: torch.linalg.solve(dense, rhs), 5)
    t_bytes, t_ops = pdma_bound(ncol, name)
    res["test_bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    res["test_share_of_bound"] = res["test_bound_ms"] / res["test_ms"]
    phase(f"K4 {pdma_solve.__name__} timing: " + json.dumps(res))
    return res


def entry_overhead(reps: int = 200) -> dict:
    """Host microseconds a call of each kernel's entry point through its
    autograd Function (what the step calls) against its wrapper alone, on
    small inputs where the launch itself is short."""
    import torch
    from elmkernels_torch.ops import ci_solver, pdma, testing
    x0, env, en = testing.ci_problem_tensors(1024, 3, "c3", torch.float32,
                                             "cuda")
    lhs, rhs = (torch.tensor(a, device="cuda")
                for a in testing.pdma_problem(1024, 3))
    calls = {"ci_hybrid_solve": lambda: ci_solver.ci_hybrid_solve(
                 x0, env, "c3", en),
             "CiSolve": lambda: ci_solver.solve(x0, env, "c3", en),
             "pdma_solve": lambda: pdma.pdma_solve(lhs, rhs),
             "PdmaSolve": lambda: pdma.solve(lhs, rhs)}
    res = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t0) / reps * 1e6
    phase("entry points, host us a call: " + json.dumps(res))
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
                          lambda a, out: ci_bound(*a),
                          ci_layout, keep=keep),
            MainPathTimes(pdma, "pdma_solve",
                          lambda a, out: pdma_bound(a[0].shape[0]),
                          keep=keep_pdma))


# the sharded phase: the loops phase's run_windows, its oracle saved here;
# the runs (backend, ranks) and each subprocess's time limit
SHARD_DIR = REPO / "build" / "sharded"
# (backend, ranks, packed carry): the gloo ranks carry their state packed,
# and their blocks must still equal the unpacked run's bit for bit
SHARD_RUNS = (("gloo", 2, True), ("nccl", 1, False))
SHARD_TIMEOUT_S = 600
# the float32 path: the main path's model in float32, 12 steps at noon
F32_NCOL, F32_STEPS = 262144, 12
# the all-float32 model's contract (tests/test_f32_drift.py's bounds)
F32_ERR_BOUND = 1e-3
# the entry-point twins, each a subprocess with its time limit: the bench
# at its defaults, on the global grid, and in float32 for a day; the long
# run at the loops phase's width for two windows; the single-column demo
# (BENCH_HETERO=1 timed one day, cut from two, and the long run 48 steps in
# 24-step windows, cut from 96 in 48, to keep the script near 600 s)
BENCH_RUNS = ({}, {"BENCH_PACKED": "1"}, {"BENCH_HETERO": "1",
                                          "BENCH_DAYS": "1"},
              {"BENCH_F32": "1", "BENCH_DAYS": "1"})
LONG_RUN_ENV = {"LR_NCOL": "8192", "LR_STEPS": "48", "LR_WINDOW": "24"}
TWIN_TIMEOUT_S = 600
# the main path's steps from 1985-07-01 00:00 (cut from 48 to keep the
# script near 600 s)
MAIN_STEPS = 24
LOOPS_NCOL = 8192
LOOPS_GRID = (64, 128)       # the NetCDF forcing's (lat, lon) grid
# 12 steps in 6-step windows (cut from 48, then 24, to keep the script near
# 600 s)
LOOPS_STEPS, LOOPS_WINDOW = 12, 6
# the closed water ledger on the global grid: f64 rounding of the rain
# terms reaches ~8e-9 mm on rainy columns, in the JAX package's step as
# in the port's (tests/test_torch_scan.py::test_water_ledger_residual_is_
# the_jax_packages).  These phases read 7.58e-9 (loops) and 7.32e-9
# (production loop) in every run on the card, deterministic on their
# inputs; the bound leaves 2.6 times the larger
GLOBAL_LEDGER_BOUND = 2e-8
PROD_NCOL = 262144
# 48 steps in 24-step windows (cut from 96 in 48 to keep the script near
# 600 s)
PROD_STEPS, PROD_WINDOW = 48, 24
# K1 is held against its plain version on the production loop's own
# inputs of this many calls (the first step's canopy iterations), K4 of
# this many (a step's each)
PROD_CI_KEPT = 16
PDMA_KEPT = 2
# the winter path runs this many steps further, pinned and aging
WINTER_STEPS, WINTER_MORE = 700, 48
# the reference formats phase: the main path's model on the SnowOptics
# text optics and on the same tables as NetCDF, REFFORMATS_STEPS steps from
# 1985-07-01 12:00 by run_windows(series=True), then REFFORMATS_TIMED
# steps of the text-optics model under the timers (K1 held on the first
# REFFORMATS_CI_KEPT calls); the single-flag SNICAR sweeps at the same
# width, on seeded snow of 0-5 layers and on the winter path's state tiled
REFFORMATS_NCOL = 262144
REFFORMATS_STEPS, REFFORMATS_TIMED, REFFORMATS_CI_KEPT = 12, 4, 4
# the landunits phase: the landunit map's seed, and the production loop's
# steps and window from 1985-01-01
LAND_SEED = 0
LAND_STEPS, LAND_WINDOW = 48, 24        # (cut from 96 in 48, as above)
# the operations phase: the interface's steps against its twin (the JAX
# package's tests/test_interface.py), and run_model's small JSON config
IFACE_STEPS = 8
RUN_MODEL_CONFIG = dict(ncol=4096, nsteps=4, start_doy=181, start_sec=43200)
# the sensitivity phase: steps, start (1985-07-01 06:00, the JAX package's
# tests/test_sensitivity.py), the finite-difference step in K and the
# tolerances of that test; K1-T and K4 calls held against their plain
# versions; at most this share of columns may be left out of the
# finite-difference check (iteration counts or one-sided slopes that
# differ between the perturbed runs)
SENS_STEPS, SENS_START_S = 2, 6 * 3600
SENS_H, SENS_RTOL, SENS_ATOL = 1e-3, 2e-3, 1e-4
SENS_FIELDS = ("eflx_sh_tot", "eflx_lh_tot", "t_ref2m", "eflx_lwrad_out")
SENS_CI_KEPT, SENS_PDMA_KEPT = 4, 2
# K1-T where leaves need the solve: one run_jvp step from 12:00 UTC, the
# synthetic forcing's noon (its sun is down everywhere at 06:00-07:00)
SENS_NOON_START_S, SENS_NOON_STEPS = 12 * 3600, 1
SENS_MAX_LEFT_OUT = 0.01
# the native reader and ingest phases: month files of the full width,
# 262,144 cells on a 512 x 512 grid, 3-hourly, July and August 1985 (1.82
# GB each), read by the port's reader and by scipy; ingest_bench's files
# mode at that width, in windows of INGEST_WINDOW steps, INGEST_NWIN timed
# windows a loop (the JAX script's 48 and 4, cut to keep the script near
# 600 s)
INGEST_NCOL, INGEST_NLON = 262144, 512
INGEST_WINDOW, INGEST_NWIN = 12, 2
# from 31 July 12:00: the second timed window is 1 August's, whose month
# load (the file prefetched while July was read) runs on run_windows' host
# thread while the first one computes
INGEST_START = (1985, 7, 31, 12 * 3600)
# a window of 48 steps spans 9 samples of 3-hourly forcing
WINDOW_SAMPLES = 9
# the packed carry's update, timed at the main path's width
PACKED_NCOL, PACKED_REPS = 262144, 20
# the capacity probe: the JAX probe's width, 2^20 columns, halved until it
# fits; its window of CAP_STEPS steps (the JAX probe's 48, cut)
CAP_NCOL, CAP_MIN_NCOL, CAP_STEPS = 1 << 20, 1 << 16, 24
CAP_TIMEOUT_S = 900
# the twins of the JAX package's tools, at the smallest depth that runs
# each through: (module, arguments, environment)
TOOL_RUNS = (
    ("f32_check", ("--steps", "12"), {}),
    ("mixed_canopy_drift", (), {"MCD_NCOL": "1024", "MCD_DAYS": "1",
                                "MCD_WINDOW": "48"}),
    ("weak_scaling", ("--devices", "1"), {}))
# flops of one ci residual evaluation on (value, tangent) pairs: the 70 of
# the value, and for the tangent 3 more per multiply or divide (~30), 1 per
# add or subtract (~30), 2 per square root (3) and 3 per max/min (~6)
CI_FUNC_JVP_FLOPS = 214


def check_loops(files, kernels: dict) -> dict:
    """Phase 8: the four time loops on the heterogeneous grid, bit for
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
    def windows(m):
        return m.run_windows(start, LOOPS_STEPS, window=LOOPS_WINDOW,
                             series=True)

    # name: (the loop, the model's packed_carry)
    loops = {
        "run_scan": (lambda m: m.run_scan(start, LOOPS_STEPS), False),
        "run_scan_series": (lambda m: m.run_scan_series(start, LOOPS_STEPS),
                            False),
        f"run_windows(series=True, window={LOOPS_WINDOW})": (windows, False)}
    loops.update({f"{name}, packed carry": (fn, True)
                  for name, (fn, _) in list(loops.items())})
    res = dict(ncol=LOOPS_NCOL, steps=LOOPS_STEPS,
               forcing_grid=list(LOOPS_GRID), write_inputs_s=write_s,
               loops={})
    with ModeSpy(ci_solver) as spy:
        m = model()
        res["psn_mode"] = m.psn_mode
        SHARD_DIR.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in m.state._asdict().items()},
                   SHARD_DIR / "initial.pt")
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
        for name, (fn, packed) in loops.items():
            m = model()
            m.packed_carry = packed
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
            if packed:
                carry = m._carry
                res["loops"][name].update(
                    carry_buffers=[[str(b.dtype), list(b.shape)]
                                   for b in carry.buffers],
                    carry_updates=carry.updates,
                    carry_bytes_per_step=carry.bytes_copied / carry.updates,
                    state_views_of_carry=all(
                        t.untyped_storage().data_ptr() in {
                            b.untyped_storage().data_ptr()
                            for b in carry.buffers} for t in m.state))
                if not res["loops"][name]["state_views_of_carry"]:
                    raise AssertionError("the packed state is not views "
                                         "into its carry")
            if state_diff or diag_diff:
                raise AssertionError(f"{name} differs from run: state "
                                     f"{state_diff}, diagnostics "
                                     f"{diag_diff}")
            if name.startswith("run_windows") and not packed:
                # the sharded phase's oracle: this loop's state and diags
                torch.save(dict(
                    state={k: v.cpu() for k, v in m.state._asdict().items()},
                    diags={k: v.cpu() for k, v in d._asdict().items()}),
                    SHARD_DIR / "oracle.pt")
    res.update(ci_modes=spy.modes, finite=finite(ref_state),
               errh2o_led=ref.errh2o_led_max.max().item(),
               errlon=ref.errlon_max.max().item(),
               errsol=ref.errsol_max.max().item(),
               errsol_bound=errsol_bound(LOOPS_NCOL, LOOPS_STEPS))
    res["surfdata"], res["inputs"] = surfdata, inputs
    phase("loops, bit for bit: " + json.dumps(res))
    if res["psn_mode"] != "mixed" or set(spy.modes) != {"mixed"}:
        raise AssertionError(f"the ci solve ran in modes {spy.modes}, "
                             f"not only 'mixed'")
    check_contracts("loops", res, led_bound=GLOBAL_LEDGER_BOUND)
    return res


def production_loop(files, inputs: dict, kernels: dict):
    """Phase 9: ``run_windows`` over the 262,144-column global grid, with
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

    # the same PROD_STEPS by run, the per-step loop, from a fresh model: the
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


def snicar_inputs_of(state, ncol: int, seed: int) -> dict:
    """A model state's snow as SNICAR's inputs, tiled to ``ncol`` columns,
    with a seeded sun height (about a tenth below the horizon) and soil
    albedo, keyed by ``snicar_ad_rt``'s argument names."""
    import torch
    from elmkernels_torch import constants as c
    from elmkernels_torch.physics import surface_albedo as sa
    reps = -(-ncol // state.snl.shape[0])

    def tile(t):
        return t.repeat((reps,) + (1,) * (t.dim() - 1))[:ncol].contiguous()
    cnc = [tile(getattr(state, f"cnc_{k}")) for k in
           ("bcphi", "bcpho", "dst1", "dst2", "dst3", "dst4")]
    land = c.LandType(ltype=c.ISTSOIL, ctype=1, vtype=12)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = state.h2osno.dtype

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen,
                                           device="cuda", dtype=dt)
    return dict(coszen=u(-0.1, 1.0, ncol), h2osno=tile(state.h2osno),
                snl=tile(state.snl), h2osoi_liq=tile(state.h2osoi_liq),
                h2osoi_ice=tile(state.h2osoi_ice),
                snw_rds=tile(state.snw_rds), albsoi=u(0.05, 0.4, ncol, 2),
                mss_cnc_aer=sa.init_timestep(
                    land, torch.zeros_like(cnc[0][:, 0]),
                    *cnc).mss_cnc_aer_in_fdb)


def reference_formats(files, snowy_state, kernels: dict) -> dict:
    """The reference formats phase: the main path's model built from the
    synthetic optics written as the reference's SnowOptics text fixture
    and from the same tables as NetCDF, REFFORMATS_STEPS steps of each by
    ``run_windows(series=True)``, held equal bit for bit (tables, state,
    diagnostics) under the main path's contracts, with the kernels'
    launches counted from 0 over the text-optics run; then
    REFFORMATS_TIMED steps of it under the timers, K1 and K4 held against
    their plain versions on the calls kept; then ``snicar_ad_rt`` with
    each flag against its half of ``snicar_ad_rt_both``, bit for bit, at
    the same width on seeded snow of 0-5 layers and on ``snowy_state``
    (the winter path's) tiled.  Returns the phase's numbers and the timed
    steps' per-launch summaries."""
    import torch
    from elmkernels_torch import constants as c
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.ops import testing
    from elmkernels_torch.physics import snow_snicar as sn
    from elmkernels_torch.utils.dates import Date
    from elmkernels_torch.utils.guard import errsol_bound
    text = files[1].with_name("SnowOptics_synthetic.txt")
    testing.write_snow_optics_text(text)
    start = Date.from_ymd(1985, 7, 1)
    start.increment_seconds(24 * 1800)
    res = dict(label="reference formats", ncol=REFFORMATS_NCOL,
               steps=REFFORMATS_STEPS, loop="run_windows(series=True)",
               card=card_line())
    models = {}
    for optics, path in (("text", text), ("netcdf", files[1])):
        t0 = time.perf_counter()
        m = Model(ncol=REFFORMATS_NCOL, pft_path=str(files[0]),
                  snicar_path=str(path))
        build_s = time.perf_counter() - t0
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = m.run_windows(start.copy(), REFFORMATS_STEPS,
                          window=REFFORMATS_STEPS, series=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        models[optics] = (m, d)
        res[optics] = dict(
            snicar_path=path.name, model_build_s=build_s, wall_s=wall,
            ms_per_step=wall / REFFORMATS_STEPS * 1e3,
            columns_per_s=REFFORMATS_NCOL * REFFORMATS_STEPS / wall,
            launches=counts(kernels, f"reference formats, {optics} optics"))
    (mt, dt), (mn, dn) = models["text"], models["netcdf"]
    res.update(
        tables_differing=[k for k in mt.snicar._fields if not torch.equal(
            getattr(mt.snicar, k), getattr(mn.snicar, k))],
        state_fields_differing=[k for k in mt.state._fields if not
                                torch.equal(getattr(mt.state, k),
                                            getattr(mn.state, k))],
        diagnostics_differing=[k for k in dt._fields if not torch.equal(
            getattr(dt, k), getattr(dn, k))],
        finite=finite(mt.state), errh2o_led=dt.errh2o_led_max.max().item(),
        errlon=dt.errlon_max.max().item(), errsol=dt.errsol_max.max().item(),
        errsol_bound=errsol_bound(REFFORMATS_NCOL, REFFORMATS_STEPS),
        max_canopy_iters=int(dt.niters_canopy_max.max().item()))
    del mn, dn, models
    if (res["tables_differing"] or res["state_fields_differing"]
            or res["diagnostics_differing"]):
        raise AssertionError(f"the text-optics run differs from the "
                             f"NetCDF-optics run: {res}")
    check_contracts("reference formats", res)

    later = start.copy()
    later.increment_seconds(REFFORMATS_STEPS * int(mt.dtime))
    t1, t4 = timers(keep=REFFORMATS_CI_KEPT, keep_pdma=PDMA_KEPT)
    with t1, t4:
        reset(kernels)
        mt.run_windows(later, REFFORMATS_TIMED, window=REFFORMATS_TIMED,
                       series=True)
        timed = counts(kernels, "reference formats, timed")
    on_path = timed_summaries(t1, t4, timed, "reference formats")
    res["k1"] = check_ci_on_path(t1.kept, 1e-5, "reference formats",
                                 per_leaf_traits=False)
    res["k4"] = check_pdma_on_path(t4.kept, "reference formats")
    del t1, t4

    # the single-flag sweeps against the stacked one, on the text optics
    seeded = testing.snicar_problem(REFFORMATS_NCOL, 11)
    inputs = {"seeded snow, 0-5 layers": {
                  k: torch.as_tensor(v, device="cuda")
                  for k, v in seeded.items()},
              "winter path, tiled": snicar_inputs_of(
                  snowy_state, REFFORMATS_NCOL, 12)}
    land = c.LandType(ltype=c.ISTSOIL, ctype=1, vtype=12)
    res["snicar_ad_rt"] = {}
    for label, a in inputs.items():
        args = [a[k] for k in ("coszen", "h2osno", "snl", "h2osoi_liq",
                               "h2osoi_ice", "snw_rds", "albsoi",
                               "mss_cnc_aer")]
        both = sn.snicar_ad_rt_both(land, *args, mt.snicar)
        out = dict(snow_layers={int(n): int((a["snl"] == n).sum().item())
                                for n in range(c.NLEVSNO + 1)},
                   active_columns=int(((a["coszen"] > 0.0)
                                       & (a["h2osno"] > sn.MIN_SNW))
                                      .sum().item()))
        for flag, half in zip((1, 2), both):
            one = sn.snicar_ad_rt(land, flag, *args, mt.snicar)
            out[f"flag{flag}_equal"] = all(
                torch.equal(getattr(one, k), getattr(half, k))
                for k in one._fields)
            out[f"flag{flag}_max_abs"] = max(
                (getattr(one, k) - getattr(half, k)).abs().max().item()
                for k in one._fields)
        out["both_ms"] = cuda_ms(
            lambda: sn.snicar_ad_rt_both(land, *args, mt.snicar), 3)
        out["single_flags_ms"] = cuda_ms(
            lambda: [sn.snicar_ad_rt(land, f, *args, mt.snicar)
                     for f in (1, 2)], 3)
        res["snicar_ad_rt"][label] = out
        if not (out["flag1_equal"] and out["flag2_equal"]
                and any(out["snow_layers"][n]
                        for n in range(1, c.NLEVSNO + 1))):
            raise AssertionError(f"snicar_ad_rt differs from its half of "
                                 f"snicar_ad_rt_both on {label}: {out}")
    if not all(res["snicar_ad_rt"]["seeded snow, 0-5 layers"]["snow_layers"]
               [n] for n in range(c.NLEVSNO + 1)):
        raise AssertionError("the seeded snow lacks a layer count")
    phase("reference formats: " + json.dumps(res))
    return res, on_path


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
    """Phase 10: the production loop's grid with per-column land types and
    live snow aging, LAND_STEPS from 1985-01-01 with no timer installed,
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


def _host_inputs(iface, date):
    """The interface model's own providers interpolated on the host: what
    an ATS host model would hand in."""
    import numpy as np
    from elmkernels_torch.driver.interface import HostForcing, HostPhenology
    m = iface.model
    w = m.forcing.window(date, m.dtime)
    p = m.phenology.window(date)

    def mix(pair, wt1, wt2):
        return wt1 * np.asarray(pair[0]) + wt2 * np.asarray(pair[1])
    return (HostForcing(atm_tbot=mix(w.tbot, w.wt1, w.wt2),
                        atm_pbot=mix(w.pbot, w.wt1, w.wt2),
                        atm_qbot=mix(w.qbot, w.wt1, w.wt2),
                        atm_flds=mix(w.flds, w.wt1, w.wt2),
                        atm_fsds=w.fsds, atm_prec=w.prec,
                        atm_wind=mix(w.wind, w.wt1, w.wt2)),
            HostPhenology(lai=mix(p.mlai, p.wt1, p.wt2),
                          sai=mix(p.msai, p.wt1, p.wt2),
                          htop=mix(p.mhtop, p.wt1, p.wt2),
                          hbot=mix(p.mhbot, p.wt1, p.wt2)))


def max_rel(a, b) -> float:
    """Largest |a - b| / |b| over the finite entries of b (0 if none)."""
    import torch
    fin = torch.isfinite(b)
    d = (a - b).abs()[fin]
    return (d / b.abs()[fin].clamp_min(1e-300)).max().item() if d.numel() \
        else 0.0


def state_diff(a, b) -> list:
    """The fields in which two ModelStates differ at all."""
    import torch
    return [k for k in a._fields if not torch.equal(getattr(a, k),
                                                    getattr(b, k))]


def operations(files, inputs: dict, kernels: dict) -> dict:
    """Phase 11: the operations layer at full width.  A RunConfig builds the
    production loop's global-grid model; run_windows runs PROD_STEPS with a
    StepGuard checking each window, MetricsLogger lines and a
    HistoryWriter; a checkpoint after window 1 restores into a fresh model
    that runs window 2 to the same state bit for bit; a strict guard trips
    and rolls back to window 1; MinimalInterface runs host-forced steps
    against a twin, then the NaN recovery round trip; and
    ``python -m elmkernels_torch.run_model`` runs a small JSON config."""
    import os
    import shutil
    import types
    import numpy as np
    import torch
    from elmkernels_torch.config import RunConfig
    from elmkernels_torch.driver.interface import MinimalInterface
    from elmkernels_torch.utils import checkpoint as ckpt
    from elmkernels_torch.utils.dates import Date
    from elmkernels_torch.utils.guard import StepGuard, errsol_bound
    from elmkernels_torch.utils.history import HistoryWriter
    from elmkernels_torch.utils.metrics import MetricsLogger
    out_dir = REPO / "build" / "operations"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    # the config has the JAX package's fields: no aerosol file, so the
    # static deposition rates (the production loop reads the file)
    cfg = RunConfig(ncol=PROD_NCOL, surfdata_path=inputs["surfdata"],
                    phenology_path=inputs["phenology_path"],
                    pft_path=str(files[0]), snicar_path=str(files[1]),
                    start_doy=181, start_sec=0)
    t0 = time.perf_counter()
    m = cfg.make_model()
    build_s = time.perf_counter() - t0
    # the guard of the JAX package's long run (tools/long_run.py): the
    # closed ledger, the steady snow balance and the horizon-scaled
    # shortwave bound; the reference's unclosed water and snow views are
    # not invariants (errh2o reads 0.12 mm in the first window here)
    checks = dict(ncol=PROD_NCOL, errh2o_max=None, errh2osno_max=None,
                  errh2osno_steady_max=1e-7,
                  errsol_max=errsol_bound(PROD_NCOL, PROD_STEPS))
    guard = StepGuard(errh2o_led_max=GLOBAL_LEDGER_BOUND, **checks)
    strict = StepGuard(errh2o_led_max=0.0, **checks)
    guard.snapshot(m.state)
    metrics = MetricsLogger(out_dir / "metrics.jsonl")
    history = HistoryWriter(str(out_dir / "history.nc"), ("t_grnd", "h2osno"),
                            every=PROD_STEPS // PROD_WINDOW)
    ck_path = out_dir / "window1.pt"
    reports, records, windows, io = [], [], [], {}

    def window_done(date, state, d):
        reports.append(guard.check(state, d))
        records.append(metrics.log_window(date, state, d))
        history.record(date, state, d)
        windows.append(d)
        if len(windows) == 1:
            strict.snapshot(state)      # validated by `guard` just above
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(ck_path, state)
            io["save_s"] = time.perf_counter() - t0

    start = cfg.start_date()
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run_windows(start, PROD_STEPS, window=PROD_WINDOW, series=True,
                  callback=window_done)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernels, "operations, run_windows")
    metrics.close()
    history.close()
    lines = (out_dir / "metrics.jsonl").read_text().splitlines()

    # resume: a fresh model restored from the window-1 checkpoint runs
    # window 2 to the same state
    m2 = cfg.make_model()
    t0 = time.perf_counter()
    m2.state = ckpt.restore(ck_path, like=m2.state)
    torch.cuda.synchronize()
    io["restore_s"] = time.perf_counter() - t0
    later = start.copy()
    later.increment_seconds(PROD_WINDOW * int(m.dtime))
    m2.run_windows(later, PROD_WINDOW, window=PROD_WINDOW, series=True)
    resume_diff = state_diff(m.state, m2.state)
    window1 = ckpt.restore(ck_path, like=m2.state)
    del m2

    # a strict guard trips on window 2 and rolls back to window 1
    rep = strict.check(m.state, windows[1])
    back = strict.restore_into(m.state)
    rollback_diff = [k for k in ckpt.PRIMARY_VARS if not torch.equal(
        getattr(back, k), getattr(window1, k))]
    res = dict(label="operations", ncol=PROD_NCOL, steps=PROD_STEPS,
               window=PROD_WINDOW, model_build_s=build_s, wall_s=wall,
               ms_per_step=wall / PROD_STEPS * 1e3, launches=launches,
               guard_reports=[(r.ok, r.reasons) for r in reports],
               metrics_lines=len(lines), metrics_last=records[-1],
               history_files=[pathlib.Path(p).name for p in history.written],
               checkpoint_bytes=os.path.getsize(ck_path),
               checkpoint_save_s=io["save_s"],
               checkpoint_restore_s=io["restore_s"],
               resume_fields_differing=resume_diff,
               strict_guard=dict(ok=rep.ok, reasons=rep.reasons,
                                 can_roll_back=rep.can_roll_back),
               rollback_fields_differing=rollback_diff,
               finite=finite(m.state), errsol_bound=guard.errsol_max)
    del m, back, window1
    phase("operations, run_windows with guard, metrics, history, "
          "checkpoint: " + json.dumps(res))
    if not (all(r.ok for r in reports) and len(lines) == 2
            and len(history.written) == 1 and res["finite"]):
        raise AssertionError(f"the guarded production run failed: {res}")
    if resume_diff:
        raise AssertionError(f"resume from the checkpoint differs: "
                             f"{resume_diff}")
    if rep.ok or not rep.can_roll_back or rollback_diff or not any(
            "errh2o_led" in r for r in rep.reasons):
        raise AssertionError(f"the strict guard's trip and rollback: {res}")

    # the coupling interface at full width: host-forced steps against a
    # twin on its own providers, then the NaN recovery round trip
    kw = dict(pft_path=str(files[0]), snicar_path=str(files[1]))
    a = MinimalInterface(ncol=PROD_NCOL, model_kw=kw).setup()
    b = MinimalInterface(ncol=PROD_NCOL, model_kw=kw).setup()
    date = Date.from_ymd(1985, 7, 1, 6 * 3600)
    reset(kernels)
    t0 = time.perf_counter()
    for _ in range(IFACE_STEPS):
        fa = a.advance(date, 1800.0)
        atm, phen = _host_inputs(b, date)
        fb = b.advance_with_forcing(date, 1800.0, atm, phen)
        date.increment_seconds(1800)
    wall = time.perf_counter() - t0
    iface_launches = counts(kernels, "interface")
    flux_ok = np.allclose(fb.eflx_sh_tot, fa.eflx_sh_tot, rtol=1e-9,
                          atol=1e-9)
    worst, bad = 0.0, []
    for k in a.model.state._fields:
        x, y = getattr(b.model.state, k), getattr(a.model.state, k)
        if not x.is_floating_point():
            if not torch.equal(x, y):
                bad.append(k)
            continue
        gap = ((x - y).abs() / (1e-12 + 1e-9 * y.abs())).max().item()
        worst = max(worst, gap)
        if not gap <= 1.0:
            bad.append(k)
    del a
    snap = b.snapshot()
    twin = MinimalInterface(ncol=PROD_NCOL, model_kw=kw).setup()
    twin.restore(snap)
    atm, phen = _host_inputs(b, date)
    b.advance_with_forcing(date, 1800.0, atm._replace(
        atm_tbot=np.asarray(atm.atm_tbot) * np.nan), phen)
    clean = types.SimpleNamespace(**{k: torch.zeros(1) for k in (
        "errh2o", "errh2o_led", "errh2osno", "errsol", "errseb")})
    nan_rep = StepGuard(ncol=PROD_NCOL).check(b.model.state, clean)
    b.restore(snap)
    b.advance_with_forcing(date, 1800.0, atm, phen)
    twin.advance_with_forcing(date, 1800.0, atm, phen)
    recovery_diff = state_diff(twin.model.state, b.model.state)
    del b, twin, snap
    iface = dict(label="interface", ncol=PROD_NCOL, steps=IFACE_STEPS,
                 ms_per_step_pair=wall / IFACE_STEPS * 1e3,
                 launches=iface_launches, eflx_sh_tot_close=bool(flux_ok),
                 state_worst_gap_over_tolerance=worst,
                 state_fields_outside=bad, nan_guard=nan_rep.reasons,
                 recovery_fields_differing=recovery_diff)
    phase("operations, MinimalInterface against its twin: "
          + json.dumps(iface))
    if not flux_ok or bad or recovery_diff or not any(
            "non-finite" in r for r in nan_rep.reasons):
        raise AssertionError(f"the coupling interface failed: {iface}")

    # the driver, as a user runs it, from a JSON config
    cfg_path = out_dir / "run.json"
    rm_dir = out_dir / "run_model"
    cfg_path.write_text(json.dumps(dict(
        RUN_MODEL_CONFIG, pft_path=str(files[0]), snicar_path=str(files[1]),
        metrics_path=str(rm_dir / "metrics.jsonl"),
        history_path=str(rm_dir / "history.nc"), history_every=2,
        checkpoint_dir=str(rm_dir / "ck"), checkpoint_every=2)))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "elmkernels_torch.run_model", "--config",
         str(cfg_path)], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    driver = dict(label="run_model", returncode=proc.returncode,
                  wall_s=time.perf_counter() - t0,
                  stdout=proc.stdout.strip().splitlines()[-3:],
                  stderr=proc.stderr.strip().splitlines()[-3:])
    phase("operations, python -m elmkernels_torch.run_model: "
          + json.dumps(driver))
    if proc.returncode != 0 or "0 validation failures" not in proc.stdout:
        raise AssertionError(f"run_model failed: {driver}")
    return dict(run=res, interface=iface, run_model=driver)


class JvpSpy:
    """Keeps the plain inputs and result of the first ``keep`` calls of an
    autograd Function's ``jvp`` while installed (``with``)."""

    def __init__(self, cls, keep: int):
        self.cls, self.keep, self.kept = cls, keep, []
        self.orig = cls.__dict__["jvp"]

    def __enter__(self):
        from elmkernels_torch.ops import tangents
        orig, kept, keep = self.orig.__func__, self.kept, self.keep

        def jvp(ctx, *tans):
            out = orig(ctx, *tans)
            if len(kept) < keep:
                with tangents.plain_dispatch():
                    saved = [tangents.primal(t).clone()
                             for t in ctx.saved_tensors]
                    kept.append((saved, [None if t is None else
                                         tangents.primal(t).clone()
                                         for t in tans],
                                 tangents.primal(out).clone()))
            return out
        self.cls.jvp = staticmethod(jvp)
        return self

    def __exit__(self, *exc):
        self.cls.jvp = self.orig


def ci_jvp_bound(x0, env, mode, enabled, evals=None):
    """(bytes ms, operations ms) of one K1-T launch: the 20 inputs and
    their tangents and ``enabled`` read, the 7 outputs, their tangents and
    the iterations written; operations the dual residual evaluations these
    leaves need (``evals``, or :func:`ci_evals`: Brent's steps
    included)."""
    n = x0.shape[0]
    nbytes = n * (2 * 20 * 8 + 1 + 2 * 7 * 8 + 4)
    if evals is None:
        evals = ci_evals(x0, env, mode, enabled)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            evals * CI_FUNC_JVP_FLOPS / PEAK_FLOPS["float64"] * 1e3)


# K1-T's profile: what holds it back.  The probe compiles the kernel
# source again, with the library's flags, beside two small additions:
# cudaOccupancyMaxActiveBlocksPerMultiprocessor for K1-T's "mixed" kernel,
# and a kernel that runs one dual residual evaluation (ci_func on
# Dual<double>, "mixed"), whose SASS counts the f64 instructions an
# evaluation issues
PROBE_SRC = r"""
#include "{source}"
#define PROBE_KERNEL ci_jvp_kernel<kMixed>
extern "C" int k1t_probe_occupancy(int threads, int smem, int* blocks) {{
  if (smem > 48 * 1024) {{
    const cudaError_t err = cudaFuncSetAttribute(
        PROBE_KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }}
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, PROBE_KERNEL,
                                                       threads, smem);
}}
__global__ void k1t_probe_eval(const double* in, double* out) {{
  using D = Dual<double>;
  const Env<D> e = {{{init}}};
  Out<D> o;
  o.gs = D(in[40], in[41]);
  const D f = ci_func<D, kMixed>(D(in[38], in[39]), o, e);
  const D r[7] = {{f, o.gs, o.ac, o.aj, o.ap, o.ag, o.an}};
  for (int k = 0; k < 7; ++k) {{
    out[2 * k] = r[k].v;
    out[2 * k + 1] = r[k].d;
  }}
}}
"""
# the f64 pipe's instructions, and the MUFU ones that start a division
# and a square root in double precision
F64_OPS = ("DADD", "DMUL", "DFMA")
MUFU64 = ("MUFU.RCP64H", "MUFU.RSQ64H")
# H100: FP64 lanes a clock on each SM (4 SM sub-partitions x 16)
F64_LANES_PER_SM = 64


def ptxas_entries(report: str) -> dict:
    """{kernel's mangled name: (registers, spill store bytes, spill load
    bytes)} from a ``ptxas -v`` report."""
    out = {}
    for chunk in report.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        out[name] = (int(regs.group(1)) if regs else None,
                     *(int(g) for g in (spill.groups() if spill else
                                        (-1, -1))))
    return out


def sass_opcodes(sass: str, name_part: str) -> dict:
    """Opcode counts of the functions whose name holds ``name_part`` in
    ``cuobjdump -sass`` output (static counts: every branch once)."""
    counts, keep = {}, False
    for line in sass.splitlines():
        if "Function : " in line:
            keep = name_part in line
            continue
        m = keep and re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                               r"([A-Z][A-Z0-9_.]*)", line)
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def k1t_probe(threads: int, smem: int) -> dict:
    """Registers and spills of the K1-T kernels (the three modes) as
    ``ptxas`` reports them, the resident blocks a SM of the "mixed" one at
    ``threads`` threads and ``smem`` B of dynamic shared memory a block,
    and the f64 instructions of one dual evaluation, from the probe (its
    SASS is left in ``build/probe/probe.sass``)."""
    import ctypes
    from torch.utils.cpp_extension import CUDA_HOME
    from elmkernels_torch.ops import build
    fields = ("gb_mol je cair oair lmr_z par_z rh_can vcmax_z forc_pbot cp "
              "kc ko tpu_z kp_z bbb qe theta_cj mbbopt c3frac").split()
    init = ", ".join(f"D(in[{2 * k}], in[{2 * k + 1}])"
                     for k in range(len(fields)))
    d = REPO / "build" / "probe"
    d.mkdir(parents=True, exist_ok=True)
    (d / "probe.cu").write_text(PROBE_SRC.format(
        source=build.CSRC / build.SOURCES["ci_hybrid_solve"], init=init))
    lib = d / "libk1t_probe.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(d / "probe.cu")], capture_output=True,
                          text=True, timeout=900)
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"the K1-T probe did not build:\n{report}")
    stem = "ci_jvp_kernel"
    kernels = {name: dict(registers=r, spill_store_bytes=ss,
                          spill_load_bytes=sl)
               for name, (r, ss, sl) in ptxas_entries(report).items()
               if stem in name}
    probe = ctypes.CDLL(str(lib))
    probe.k1t_probe_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    blocks = ctypes.c_int(0)
    err = probe.k1t_probe_occupancy(threads, smem, ctypes.byref(blocks))
    if err != 0:
        raise AssertionError(f"occupancy query of {stem} failed: {err}")
    sass = subprocess.run(
        [str(pathlib.Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass",
         str(lib)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    (d / "probe.sass").write_text(sass)
    ops = sass_opcodes(sass, "k1t_probe_eval")
    f64 = {k: ops.get(k, 0) for k in F64_OPS + MUFU64}
    f64["other_D"] = sum(v for k, v in ops.items()
                         if k.startswith("D") and k not in F64_OPS)
    mixed = [k for k in kernels if f"{len(stem)}{stem}ILi2E" in k]
    return dict(threads=threads, smem_bytes=smem,
                blocks_per_sm=blocks.value,
                warps_per_sm=blocks.value * threads // 32,
                kernels=kernels,
                mixed_kernel_sass_f64={
                    k: v for k, v in sass_opcodes(sass, mixed[0]).items()
                    if k in F64_OPS + MUFU64} if mixed else {},
                eval_sass=f64, eval_f64_pipe=sum(f64[k] for k in F64_OPS))


def sm_clock_mhz(fn, seconds: float = 1.5) -> dict:
    """The SM clock ``nvidia-smi`` reads (MHz, every 200 ms) while ``fn``
    runs back to back, and the card's highest."""
    import torch
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    rows = [[float(v) for v in line.split(",")]
            for line in out.splitlines() if line.strip()]
    loaded = sorted(r[0] for r in rows[2:]) or [r[0] for r in rows]
    return dict(samples=len(rows), median=loaded[len(loaded) // 2],
                max=rows[0][1] if rows else None)


def k1t_profile(label: str, args, probe: dict | None = None,
                reps: int = 20, sms: int = 132,
                clock_mhz: float | None = None) -> dict:
    """K1-T on one set of inputs ``args`` = (x0, dx0, env, denv, mode,
    enabled): ms a launch, its bound; values, tangents and iterations
    against torch.func.jvp of the plain solve; the residual evaluations
    each leaf commits, by kind (from the plain solve's masks); the warp
    efficiency of one thread a leaf (lanes that evaluate both starting
    points, in the leaves' order) and of the kernel's schedule (its warps'
    steps, from the launch's counters); the f64 pipe's floor (``probe``'s f64
    instructions an evaluation x evaluations over SMs x 64 lanes x the SM
    clock); and the critical path, K1-T on the leaf with the most
    evaluations alone (no schedule ends before that leaf's chain of
    dependent evaluations)."""
    import torch
    from elmkernels_torch.ops import ci_solver, testing
    from elmkernels_torch.physics import photosynthesis as psn
    x0, dx0, env, denv, mode, en = args
    counts = testing.ci_eval_counts(x0, env, mode, en)
    committed = sum(counts.values())
    one_thread = committed + (2 - counts["start"])
    n = x0.shape[0]
    sched = torch.zeros(2, dtype=torch.int64, device=x0.device)
    got = ci_solver.ci_hybrid_solve_jvp(*args, sched=sched)
    steps = int(sched[1])
    want = psn.hybrid_solve_jvp_plain(*args)
    same = all(bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
               for a, b in zip(
        (got[0], *got[1], got[3], *got[4]),
        (want[0], *want[1], want[3], *want[4])))
    ms = guarded_ms(lambda: ci_solver.ci_hybrid_solve_jvp(*args), reps)
    total = float(committed.double().sum())
    t_bytes, t_ops = ci_jvp_bound(x0, env, mode, en, total)
    res = dict(label=label, leaves=n, mode=mode, ms=ms,
               bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes,
               operations_ms=t_ops, share_of_bound=max(t_bytes, t_ops) / ms,
               bit_for_bit=same,
               equal_iters=bool(torch.equal(got[2], want[2])),
               enabled_share=float(en.double().mean()),
               evals_per_leaf={k: float(v.double().mean())
                               for k, v in counts.items()},
               committed_evals_per_leaf=total / n,
               one_thread_evals_per_leaf=float(one_thread.double().mean()),
               max_evals=int(one_thread.max()),
               warp_efficiency_one_thread=testing.warp_efficiency(
                   one_thread),
               warp_steps=steps,
               # None where no leaf needs an evaluation (no step is taken)
               warp_efficiency_schedule=(total / (32 * steps) if steps
                                         else None))
    if total:
        # the critical path: the leaf with the most evaluations, alone
        slow = one_thread.argmax().reshape(1)
        alone = (x0[slow], dx0[slow], type(env)(*(v[slow] for v in env)),
                 type(denv)(*(v[slow] for v in denv)), mode, en[slow])
        res["slowest_leaf_evals"] = int(committed[slow])
        res["slowest_leaf_alone_ms"] = guarded_ms(
            lambda: ci_solver.ci_hybrid_solve_jvp(*alone), reps)
    if probe and clock_mhz:
        rate = sms * F64_LANES_PER_SM * clock_mhz * 1e6
        res["f64_pipe_floor_ms"] = total * probe["eval_f64_pipe"] / rate * 1e3
        res["f64_pipe_floor_one_thread_ms"] = (
            float(one_thread.double().sum()) * probe["eval_f64_pipe"]
            / res["warp_efficiency_one_thread"] / rate * 1e3)
    return res


def k1t_test_args(dry_share: float, n: int = 2 * 262144, mode="mixed",
                  seed: int = 2024, device="cuda"):
    """A K1-T test problem on the card: float64 leaves of
    ``testing.ci_problem_tensors`` and seeded tangents."""
    import torch
    from elmkernels_torch.ops import testing
    x0, env, en = testing.ci_problem_tensors(n, seed, mode, torch.float64,
                                             device, dry_share=dry_share)
    dx0, denv = testing.ci_tangents(x0, env, seed + 1)
    return (x0, dx0, env, denv, mode, en)


K1T_DRY_SHARES = (0.25, 1.0)


def k1t_test_phase() -> dict:
    """K1-T on its test problems (2 x 262,144 "mixed" leaves, float64, at
    each of K1T_DRY_SHARES): the probe at the launch's own layout, the SM
    clock under load, and
    :func:`k1t_profile` of each problem, which must be bit for bit with
    equal iterations.  Returns them with the plain jvp's ms and the
    profile context for later calls."""
    import torch
    from elmkernels_torch.ops import ci_solver
    from elmkernels_torch.physics import photosynthesis as psn
    res = dict(layout=ci_solver.jvp_layout())
    res["probe"] = k1t_probe(res["layout"]["threads"],
                             res["layout"]["smem_bytes_per_block"])
    phase("K1-T probe: " + json.dumps(res))
    tests = [(ds, k1t_test_args(ds)) for ds in K1T_DRY_SHARES]
    res["clock_mhz"] = sm_clock_mhz(
        lambda: ci_solver.ci_hybrid_solve_jvp(*tests[0][1]))
    res["ctx"] = dict(probe=res["probe"],
                      sms=torch.cuda.get_device_properties(0)
                      .multi_processor_count,
                      clock_mhz=res["clock_mhz"]["median"])
    res["profiles"] = []
    for ds, args in tests:
        prof = dict(k1t_profile(f"test problem, dry share {ds}", args,
                                **res["ctx"]), dry_share=ds)
        phase("K1-T profile: " + json.dumps(prof))
        res["profiles"].append(prof)
    res["plain_ms"] = cuda_ms(
        lambda: psn.hybrid_solve_jvp_plain(*tests[0][1]), 2)
    bad = [p["label"] for p in res["profiles"]
           if not (p["bit_for_bit"] and p["equal_iters"])]
    if bad:
        raise AssertionError(f"K1-T disagrees with torch.func.jvp of the "
                             f"plain solve on {bad}")
    return res


def sens_model(files, inputs: dict):
    """The sensitivity phase's model (the global grid under the exact
    flags), its start and its stacked forcing and phenology."""
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date
    inputs = dict(inputs)
    inputs.pop("write_s")
    surfdata = inputs.pop("surfdata")
    m = Model.from_surfdata(surfdata, PROD_NCOL, pft_path=str(files[0]),
                            snicar_path=str(files[1]), mixed_radiation=False,
                            **inputs)
    start = Date.from_ymd(1985, 7, 1, SENS_START_S)
    forc, phen = m.stack_windows(start, SENS_STEPS)
    return m, start, forc, phen


def ci_jvp_layout(args):
    """K1-T's inputs laid out as the kernel takes them (contiguous)."""
    x0, dx0, env, denv, mode, enabled = args
    return (x0.contiguous(), dx0.contiguous(),
            type(env)(*(t.contiguous() for t in env)),
            type(denv)(*(t.contiguous() for t in denv)), mode,
            enabled.contiguous())


def k1t_timer(keep: int):
    """MainPathTimes of K1-T, keeping its first ``keep`` calls."""
    from elmkernels_torch.ops import ci_solver
    return MainPathTimes(ci_solver, "ci_hybrid_solve_jvp",
                         lambda a, out: ci_jvp_bound(a[0], a[2], a[4], a[5]),
                         ci_jvp_layout, keep=keep)


def sensitivity(files, inputs: dict, k1t_ctx: dict) -> dict:
    """Phase 12: the tangent-linear model on the 262,144-column global
    grid under the exact flags, 2 steps from 1985-07-01 06:00: run_jvp
    seeded by tbot (untimed: ms/step against the primal, launches) and by
    watsat (under the timers: K1-T and K4 per launch, kept calls); the
    tbot tangents against central finite differences; the primal against
    the plain trajectory; K1-T and K4's tangent rule against their plain
    versions on the path's own inputs."""
    import torch
    from elmkernels_torch.driver import sensitivity as sens
    from elmkernels_torch.ops import ci_solver, pdma
    from elmkernels_torch.physics import photosynthesis as psn
    from elmkernels_torch.physics.soil_temperature import pdma_solve_plain
    m, start, forc, phen = sens_model(files, inputs)
    kernels = {"ci_hybrid_solve": ci_solver.ci_hybrid_solve,
               "ci_hybrid_solve_jvp": ci_solver.ci_hybrid_solve_jvp,
               "pdma_solve": pdma.pdma_solve}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / SENS_STEPS * 1e3

    (_, base), primal_ms = timed(lambda: sens.trajectory(m, forc, phen))
    reset(kernels)
    res_t, jvp_ms = timed(lambda: sens.run_jvp(
        m, start, SENS_STEPS, seed_forcing=sens.seed_field("tbot"),
        forc_stack=forc, phen_stack=phen))
    launches = {k: fn.launches for k, fn in kernels.items()}
    if not (launches["ci_hybrid_solve_jvp"] and launches["pdma_solve"]):
        raise AssertionError(f"K1-T or K4 was not launched on the "
                             f"sensitivity path: {launches}")

    t1t = k1t_timer(SENS_CI_KEPT)
    t4 = MainPathTimes(pdma, "pdma_solve",
                       lambda a, out: pdma_bound(a[0].shape[0]))
    with t1t, t4, JvpSpy(pdma.PdmaSolve, SENS_PDMA_KEPT) as spy:
        # timed again: the second run, with ~1 ms of timer guard a launch
        res_w, jvp_ms_again = timed(lambda: sens.run_jvp(
            m, start, SENS_STEPS, seed_params=sens.seed_field("watsat"),
            forc_stack=forc, phen_stack=phen))
    on_path = {"ci_hybrid_solve_jvp": t1t.summary(),
               "pdma_solve": t4.summary()}
    phase("kernels on the sensitivity path: " + json.dumps(on_path))

    # tangents finite
    nonfinite = [f"{kind}.{k}" for res in (res_t, res_w)
                 for kind in ("d_state", "d_diags")
                 for k, v in getattr(res, kind)._asdict().items()
                 if v.is_floating_point() and not bool(
                     torch.isfinite(v).all())]
    # the primal: the same with either seed and as the plain trajectory
    primal_diff = [k for k in base._fields if not (
        torch.equal(getattr(res_t.diags, k), getattr(base, k))
        and torch.equal(getattr(res_w.diags, k), getattr(base, k)))]

    # central differences of the tbot tangents
    _, hi = sens.trajectory(m, forc._replace(tbot=forc.tbot + SENS_H), phen)
    _, lo = sens.trajectory(m, forc._replace(tbot=forc.tbot - SENS_H), phen)
    same_iters = ((hi.niters_canopy == lo.niters_canopy).all(0)
                  & (hi.niters_ci == lo.niters_ci).all(0)
                  & (hi.niters_canopy == base.niters_canopy).all(0)
                  & (hi.niters_ci == base.niters_ci).all(0))
    # differentiable within +-h: the one-sided slopes agree
    smooth = torch.ones_like(same_iters)
    for k in SENS_FIELDS:
        up = (getattr(hi, k) - getattr(base, k)) / SENS_H
        down = (getattr(base, k) - getattr(lo, k)) / SENS_H
        smooth &= ((up - down).abs() <= SENS_ATOL + SENS_RTOL
                   * (0.5 * (up + down)).abs()).all(0)
    kept = same_iters & smooth
    fd = {}
    for k in SENS_FIELDS:
        got = getattr(res_t.d_diags, k)[:, kept]
        want = ((getattr(hi, k) - getattr(lo, k)) / (2 * SENS_H))[:, kept]
        outside = ~((got - want).abs() <= SENS_ATOL + SENS_RTOL
                    * want.abs())
        fd[k] = dict(columns_outside=int(outside.any(0).sum().item()),
                     max_abs_gap=(got - want).abs().max().item(),
                     max_rel_gap=max_rel(got, want))
    t_ref2m_warms = bool((res_t.d_diags.t_ref2m[:, kept] > 0).all())

    # K1-T and K4's tangent rule on the path's own inputs; K1-T bit for
    # bit (NaN where the plain version has NaN)
    worst_v = worst_t = worst_abs = 0.0
    eq, leaves, same = 1.0, 0, True
    for (x0, dx0, env, denv, mode, en), (ci, out, it, dci, dout) in t1t.kept:
        cp, op, ip, dcp, dop = psn.hybrid_solve_jvp_plain(x0, dx0, env,
                                                          denv, mode, en)
        for a, b in zip((ci, *out), (cp, *op)):
            worst_v = max(worst_v, max_rel(a, b))
            worst_abs = max(worst_abs, (a - b).abs().nan_to_num().max()
                            .item())
        for a, b in zip((dci, *dout), (dcp, *dop)):
            worst_t = max(worst_t, max_rel(a, b))
            worst_abs = max(worst_abs, (a - b).abs().nan_to_num().max()
                            .item())
        for a, b in zip((ci, *out, dci, *dout), (cp, *op, dcp, *dop)):
            same &= bool(((a == b) | (torch.isnan(a) & torch.isnan(b)))
                         .all())
        eq = min(eq, (it == ip).double().mean().item())
        leaves += x0.shape[0]
    profiles = [k1t_profile(f"sensitivity path, call {i}", args, **k1t_ctx)
                for i, (args, _) in enumerate(t1t.kept)]
    for prof in profiles:
        phase("K1-T profile: " + json.dumps(prof))
    noon = sens_noon(m, kernels, k1t_ctx)
    (x0, dx0, env, denv, mode, en), _ = t1t.kept[0]
    plain_ms = cuda_ms(lambda: psn.hybrid_solve_jvp_plain(
        x0, dx0, env, denv, mode, en), 2)
    # K4's tangent rule solves A dx = db - dA x where the plain version
    # differentiates the elimination: equal to rounding, held at rtol 1e-9
    k4_rel, k4_abs, k4_close, k4_cols = 0.0, 0.0, True, 0
    for (lhs, rhs, _), (dlhs, drhs), dx in spy.kept:
        _, dxp = torch.func.jvp(pdma_solve_plain, (lhs, rhs), (dlhs, drhs))
        k4_rel = max(k4_rel, max_rel(dx, dxp))
        k4_abs = max(k4_abs, (dx - dxp).abs().max().item())
        k4_close &= bool(torch.allclose(dx, dxp, rtol=1e-9, atol=1e-12))
        k4_cols += lhs.shape[0]
    res = dict(label="sensitivity", ncol=PROD_NCOL, steps=SENS_STEPS,
               psn_mode=m.psn_mode, primal_ms_per_step=primal_ms,
               jvp_ms_per_step=jvp_ms, jvp_over_primal=jvp_ms / primal_ms,
               jvp_ms_per_step_second_run_timed=jvp_ms_again,
               launches=launches, nonfinite_tangents=nonfinite,
               primal_fields_differing=primal_diff,
               fd_columns_kept=int(kept.sum().item()),
               fd_left_out_iterations=int((~same_iters).sum().item()),
               fd_left_out_not_smooth=int((same_iters & ~smooth).sum()
                                          .item()),
               fd=fd, t_ref2m_tangent_positive=t_ref2m_warms,
               k1t=dict(calls=len(t1t.kept), leaves=leaves,
                        bit_for_bit=same, max_rel_value=worst_v,
                        max_rel_tangent=worst_t, max_abs=worst_abs,
                        equal_iters=eq, plain_ms=plain_ms),
               k4_tangent=dict(calls=len(spy.kept), columns=k4_cols,
                               max_rel_tangent=k4_rel, max_abs_tangent=k4_abs,
                               close_at_1e_9=k4_close),
               noon=noon["res"])
    phase("sensitivity: " + json.dumps(res))
    left_out = 1.0 - res["fd_columns_kept"] / PROD_NCOL
    if nonfinite or primal_diff:
        raise AssertionError(f"sensitivity: non-finite tangents or a primal "
                             f"changed by seeding: {res}")
    if left_out > SENS_MAX_LEFT_OUT or not t_ref2m_warms or any(
            v["columns_outside"] for v in fd.values()):
        raise AssertionError(f"tangents disagree with finite differences: "
                             f"{res}")
    if not (same and eq == 1.0 and spy.kept and k4_close):
        raise AssertionError(f"K1-T or K4's tangent rule disagrees with its "
                             f"plain version: {res}")
    return dict(res=res, on_path=on_path, launches=launches,
                profiles=profiles, noon=noon)


def sens_noon(m, kernels: dict, k1t_ctx: dict) -> dict:
    """K1-T on the sensitivity model where its leaves need the solve:
    ``run_jvp`` seeded by tbot for SENS_NOON_STEPS from 12:00 UTC, each
    K1-T launch timed, its first SENS_CI_KEPT calls profiled and held bit
    for bit, with equal iterations, against torch.func.jvp of the plain
    solve; the primal finite.  Columns whose tangents are not finite are
    counted, not refused: the JAX package's jvp of ``hybrid_solve`` gives
    NaN ci tangents on the same leaves."""
    import torch
    from elmkernels_torch.driver import sensitivity as sens
    from elmkernels_torch.ops import ci_solver
    from elmkernels_torch.utils.dates import Date
    start = Date.from_ymd(1985, 7, 1, SENS_NOON_START_S)
    forc, phen = m.stack_windows(start, SENS_NOON_STEPS)
    t1t = k1t_timer(SENS_CI_KEPT)
    reset(kernels)
    with t1t:
        res_n = sens.run_jvp(m, start, SENS_NOON_STEPS,
                             seed_forcing=sens.seed_field("tbot"),
                             forc_stack=forc, phen_stack=phen)
    launches = ci_solver.ci_hybrid_solve_jvp.launches
    on_path = t1t.summary()
    profiles = [k1t_profile(f"sensitivity path at noon, call {i}", args,
                            **k1t_ctx)
                for i, (args, _) in enumerate(t1t.kept)]
    for prof in profiles:
        phase("K1-T profile: " + json.dumps(prof))
    primal_finite = all(bool(torch.isfinite(v).all())
                        for v in res_n.diags._asdict().values()
                        if v.is_floating_point())
    bad = torch.zeros(m.ncol, dtype=torch.bool, device=m.device)
    for v in res_n.d_diags._asdict().values():
        if v.is_floating_point():
            b = (~torch.isfinite(v)).any(0)
            bad |= b.reshape(m.ncol, -1).any(1)
    res = dict(start_s=SENS_NOON_START_S, steps=SENS_NOON_STEPS,
               launches=launches, on_path=on_path,
               enabled_share=[p["enabled_share"] for p in profiles],
               evals_per_leaf=[p["committed_evals_per_leaf"]
                               for p in profiles],
               warp_efficiency=[p["warp_efficiency_schedule"]
                                for p in profiles],
               bit_for_bit=all(p["bit_for_bit"] and p["equal_iters"]
                               for p in profiles),
               primal_finite=primal_finite,
               columns_nonfinite_tangent=int(bad.sum()))
    phase("K1-T on the sensitivity path at noon: " + json.dumps(res))
    if not (launches and profiles and res["bit_for_bit"] and primal_finite
            and max(res["enabled_share"]) > 0):
        raise AssertionError(f"K1-T at noon: not launched, no enabled leaf, "
                             f"or disagrees with its plain version: {res}")
    return dict(res=res, on_path=on_path, launches=launches,
                profiles=profiles)


def float32_path(files) -> dict:
    """The main path's model in float32 (the JAX package's all-float32
    mode), 12 steps around noon with each K4 launch timed
    (``pdma_solve_f32``) and its first calls held against the plain
    version in float32 bit for bit; the contracts of test_f32_drift.py."""
    import torch
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.ops import ci_solver, pdma
    from elmkernels_torch.utils.dates import Date
    m = Model(ncol=F32_NCOL, pft_path=str(files[0]),
              snicar_path=str(files[1]), dtype=torch.float32)
    start = Date.from_ymd(1985, 7, 1)
    start.increment_seconds(18 * int(m.dtime))
    kernels = {"ci_hybrid_solve": ci_solver.ci_hybrid_solve,
               "pdma_solve_f32": pdma.pdma_solve_f32}
    t4 = MainPathTimes(pdma, "pdma_solve_f32",
                       lambda a, out: pdma_bound(a[0].shape[0], "float32"),
                       keep=PDMA_KEPT)
    worst = {"errsol": 0.0, "errlon": 0.0}

    def cb(date, state, d):
        for k in worst:
            worst[k] = max(worst[k], getattr(d, k).abs().max().item())

    with t4:
        reset(kernels)
        pdma.pdma_solve.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run(start, F32_STEPS, cb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(kernels, "float32 path")
    on_path = t4.summary()
    k4 = check_pdma_on_path(t4.kept, "float32 path")
    res = dict(label="float32 path", ncol=F32_NCOL, steps=F32_STEPS,
               dtype=str(m.state.t_grnd.dtype), wall_s=wall,
               ms_per_step_under_timers=wall / F32_STEPS * 1e3,
               launches=launches, float64_k4_launches=pdma.pdma_solve.launches,
               finite=finite(m.state), on_path=on_path, **worst)
    phase("float32 path: " + json.dumps(res))
    if not (res["finite"] and res["dtype"] == "torch.float32"
            and launches["pdma_solve_f32"] == F32_STEPS
            and pdma.pdma_solve.launches == 0
            and max(worst.values()) < F32_ERR_BOUND):
        raise AssertionError(f"the float32 path failed: {res}")
    return dict(res=res, on_path=on_path, k4=k4, launches=launches)


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def wait_all(procs, timeout_s: float, label: str) -> list:
    """Each process's output; a timeout or a non-zero exit fails, and no
    process is left running."""
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout_s)[0])
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{label}: a process outlasted "
                                     f"{timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{label} exited {p.returncode}:\n"
                                 f"{out[-4000:]}")
    return outs


def shard_rank(rank: int, nranks: int, port: int, backend: str,
               packed: bool) -> int:
    """One rank of the sharded phase (``chip_smoke.py --shard-rank``): its
    block of the loops phase's grid on this rank's card, from the
    unsharded initial state cut by ``shard_state``, the loops phase's
    ``run_windows(series=True)`` with each K1 and K4 launch timed and the
    first ones kept; writes its block, the global diagnostics, launches,
    times and its kernels' checks to SHARD_DIR."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    from elmkernels_torch import parallel
    from elmkernels_torch.data.state import ModelState
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.ops import ci_solver, pdma
    from elmkernels_torch.utils.dates import Date
    spec = json.loads((SHARD_DIR / "spec.json").read_text())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=nranks, rank=rank)
    mesh = parallel.column_mesh(spec["ncol"])
    label = f"{backend} rank {rank} of {nranks}"
    model = Model.from_surfdata(spec["surfdata"], mesh.ncol, col0=mesh.col0,
                                sharding=mesh, packed_carry=packed,
                                **spec["kw"])
    initial = torch.load(SHARD_DIR / "initial.pt", weights_only=True)
    model.state = parallel.shard_state(mesh, ModelState(**initial))
    kernels = {"ci_hybrid_solve": ci_solver.ci_hybrid_solve,
               "pdma_solve": pdma.pdma_solve}
    t1, t4 = timers(keep=1, keep_pdma=1)
    with t1, t4:
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = model.run_windows(Date.from_ymd(1985, 7, 1), LOOPS_STEPS,
                              window=LOOPS_WINDOW, series=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(kernels, label)
    on_path = timed_summaries(t1, t4, launches, label)
    k1 = check_ci_on_path(t1.kept, 1e-5, label)
    k4 = check_pdma_on_path(t4.kept, label)
    torch.save(dict(
        lo=mesh.lo, hi=mesh.hi, device=str(mesh.device), wall_s=wall,
        state={k: v.cpu() for k, v in model.state._asdict().items()},
        diags={k: v.cpu() for k, v in d._asdict().items()},
        launches=launches, on_path=on_path, k1=k1, k4=k4),
        SHARD_DIR / f"{backend}_rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_loops(files, loops: dict) -> dict:
    """The loops phase's run_windows(series=True) split over ranks: two
    ranks sharing the card on a gloo group, then one rank on an NCCL group
    (NCCL refuses two ranks on one card), each a subprocess.  Every rank's
    block must equal the unsharded run's final state bit for bit on every
    field, its global diagnostics the unsharded reductions (maxima
    exactly, means to rtol 1e-12), and K1 and K4 must have launched on it
    and agree with their plain versions on its first calls."""
    import torch
    (SHARD_DIR / "spec.json").write_text(json.dumps(dict(
        ncol=LOOPS_NCOL, surfdata=loops["surfdata"],
        kw=dict(pft_path=str(files[0]), snicar_path=str(files[1]),
                **loops["inputs"]))))
    oracle = torch.load(SHARD_DIR / "oracle.pt", weights_only=True)
    out = {}
    for backend, nranks, packed in SHARD_RUNS:
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--shard-rank", str(r), str(nranks), str(port), backend,
             str(int(packed))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(__import__("os").environ, LOCAL_RANK=str(r)))
            for r in range(nranks)]
        wait_all(procs, SHARD_TIMEOUT_S, f"sharded {backend} ranks")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(nranks):
            got = torch.load(SHARD_DIR / f"{backend}_rank{r}.pt",
                             weights_only=False)
            lo, hi = got["lo"], got["hi"]
            state_diff = [k for k, v in oracle["state"].items()
                          if not torch.equal(got["state"][k], v[lo:hi])]
            diag_diff = []
            for k, v in oracle["diags"].items():
                g = got["diags"][k]
                if k.endswith("_mean"):
                    ok = torch.allclose(g, v, rtol=1e-12, atol=0)
                else:
                    ok = torch.equal(g, v)
                if not ok or g.dtype != v.dtype:
                    diag_diff.append(k)
            ranks.append(dict(
                rank=r, block=[lo, hi], device=got["device"],
                wall_s=got["wall_s"], launches=got["launches"],
                on_path=got["on_path"],
                k1_max_rel=got["k1"]["max_rel"],
                k1_equal_iters=got["k1"]["equal_iters"],
                k4_equal=got["k4"]["equal"],
                state_fields_differing=state_diff,
                diagnostics_differing=diag_diff))
        res = dict(backend=backend, ranks=nranks, packed_carry=packed,
                   ncol=LOOPS_NCOL, steps=LOOPS_STEPS, window=LOOPS_WINDOW,
                   wall_s_with_start=wall, per_rank=ranks)
        phase(f"sharded loops, {backend}: " + json.dumps(res))
        covered = sum(r["block"][1] - r["block"][0] for r in ranks)
        if covered != LOOPS_NCOL or any(
                r["state_fields_differing"] or r["diagnostics_differing"]
                or not all(r["launches"].values()) for r in ranks):
            raise AssertionError(f"sharded {backend} run differs from the "
                                 f"unsharded one: {res}")
        out[backend] = res
    return out


def entry_twins(card: str) -> dict:
    """The bench twin, ``python -m elmkernels_torch.bench`` (BENCH_RUNS), as
    a user runs it, one run at a time, alone on the card.  Each bench line
    is printed beside the card line; the float32 bench's K4 launches are
    ``pdma_solve_f32``'s."""
    import os
    res = {"bench": []}
    for knobs in BENCH_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "elmkernels_torch.bench"], cwd=REPO,
            env=dict(os.environ, **knobs), capture_output=True, text=True,
            timeout=TWIN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        notes = [ln for ln in proc.stderr.splitlines() if ln.startswith("#")]
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"bench {knobs} exited {proc.returncode}:\n"
                                 f"{proc.stdout}\n{proc.stderr[-4000:]}")
        launches = json.loads(next(
            ln for ln in notes if ln.startswith("# launches: "))[12:])
        rec = dict(knobs=knobs, wall_s_with_start=wall, line=lines[0],
                   launches=launches, notes=notes)
        phase(f"bench twin {json.dumps(knobs)}: {lines[0]}  card: {card}")
        phase(f"  bench twin {json.dumps(knobs)}, stderr: "
              + json.dumps(notes))
        res["bench"].append(rec)
    f32 = res["bench"][-1]["launches"]
    if not (f32["pdma_solve_f32"] and not f32["pdma_solve"]):
        raise AssertionError(f"the float32 bench did not run K4 in float32: "
                             f"{f32}")
    return res


def packed_update_cost() -> dict:
    """The packed carry's cost a step at the main path's width: the bytes
    one :meth:`PackedCarry.update` copies (every field of a step's new
    state) and its device ms, by CUDA events over ``PACKED_REPS``
    updates."""
    import torch
    from elmkernels_torch.data.state import cold_start
    from elmkernels_torch.utils.packing import PackedCarry
    carry = PackedCarry(cold_start(PACKED_NCOL, device="cuda"))
    new = type(carry.state)(*(t + 0 for t in carry.state))
    nbytes = carry.nbytes_per_step(new)
    carry.update(new)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(PACKED_REPS):
        carry.update(new)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / PACKED_REPS
    res = dict(ncol=PACKED_NCOL, fields=len(carry.template),
               buffers=[[str(t.dtype), list(t.shape)] for t in carry.buffers],
               bytes_per_update=nbytes, ms_per_update=ms,
               bound_ms=2 * nbytes / HBM_BYTES_PER_S * 1e3,
               equal=all(torch.equal(x, y) for x, y in zip(carry.state,
                                                           new)))
    phase("packed carry, one update at full width: " + json.dumps(res))
    if not res["equal"]:
        raise AssertionError("the packed carry's update lost a field")
    return res


def native_reader() -> dict:
    """The native reader at full width: the July and August month files
    (262,144 cells on 512 x 512, 3-hourly, written once) read by the
    port's reader and by scipy, every variable window slab by window slab
    (``WINDOW_SAMPLES`` samples, a 48-step window's), equal at atol 0; a
    prefetched open equal to a cold one on each variable's first and last
    slabs; and one window's reads timed by each reader."""
    import numpy as np
    from scipy.io import netcdf_file
    from elmkernels_torch.data import netcdf
    from elmkernels_torch.io import native
    from elmkernels_torch.tools import ingest_bench
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    base, nlat = ingest_bench.forcing_files(INGEST_NCOL, INGEST_NLON)
    res = dict(library=str(lib.relative_to(REPO)), build_s=build_s,
               write_or_find_files_s=time.perf_counter() - t0,
               grid=[nlat, INGEST_NLON], months={})
    paths = [f"{base}1985-{m:02d}.nc" for m in (7, 8)]
    names = ("DTIME",) + ingest_bench.FORCING_VARS
    for path in paths:
        t0 = time.perf_counter()
        nf, sf = netcdf.open_native(path), netcdf_file(path, mmap=True)
        try:
            slabs, unequal = 0, []
            for v in names:
                shape = nf.shape(v)
                for t in range(0, shape[0], WINDOW_SAMPLES - 1):
                    start = (t,) + (0,) * (len(shape) - 1)
                    count = (min(WINDOW_SAMPLES, shape[0] - t),) + shape[1:]
                    a = netcdf.read_var(nf, v, start=start, count=count)
                    b = netcdf.read_var(sf, v, start=start, count=count)
                    slabs += 1
                    if not (a.dtype == b.dtype and np.array_equal(a, b)):
                        unequal.append((v, t))
        finally:
            nf.close()
            sf.close()
        res["months"][pathlib.Path(path).name] = dict(
            bytes=pathlib.Path(path).stat().st_size, slabs=slabs,
            unequal=unequal, s=time.perf_counter() - t0)
    # a prefetched open against a cold one: every variable's first and
    # last window slabs
    t0 = time.perf_counter()
    netcdf.prefetch(paths[0])
    prefetch_unequal = []
    with netcdf.open_native(paths[0]) as warm, \
            netcdf.open_native(paths[0]) as cold:
        for v in names:
            shape = warm.shape(v)
            for t in (0, shape[0] - WINDOW_SAMPLES):
                start = (t,) + (0,) * (len(shape) - 1)
                count = (WINDOW_SAMPLES,) + shape[1:]
                if not np.array_equal(warm.read(v, start, count),
                                      cold.read(v, start, count)):
                    prefetch_unequal.append((v, t))
    res.update(prefetch_unequal=prefetch_unequal,
               prefetch_check_s=time.perf_counter() - t0,
               window=ingest_bench.window_reads(paths[0], INGEST_NCOL,
                                                WINDOW_SAMPLES))
    phase("native reader at full width: " + json.dumps(res))
    bad = [m for m, r in res["months"].items() if r["unequal"]]
    if bad or prefetch_unequal or not res["window"]["reads_equal"]:
        raise AssertionError(f"the native reader differs from scipy: "
                             f"{bad} {prefetch_unequal} {res['window']}")
    return res


def ingest(kernels: dict) -> dict:
    """ingest_bench's files mode at full width (262,144 columns from the
    native reader phase's month files): ``run_windows(series=True)`` from
    the files, prefetching the next month, against the pre-staged
    ``run_scan_series`` windows, bit for bit; this slice's full-width
    path, its K1 and K4 launches counted from 0 over it."""
    from elmkernels_torch.tools import ingest_bench
    reset(kernels)
    rec = ingest_bench.bench_files(INGEST_NCOL, INGEST_WINDOW, INGEST_NWIN,
                                   nlon=INGEST_NLON, start=INGEST_START)
    launches = counts(kernels, "ingest path")
    res = dict(rec, launches=launches,
               overlapped_over_prestaged=(rec["overlapped_files_ms"]
                                          / rec["prestaged_ms"]))
    phase("ingest, month files at full width: " + json.dumps(res))
    if not (rec["bit_identical"] and rec["window_reads_equal"]):
        raise AssertionError(f"ingest from files differs: {rec}")
    return res


def _launch_note(stderr: str) -> dict:
    line = next((ln for ln in stderr.splitlines()
                 if ln.startswith("# launches: ")), None)
    return json.loads(line[12:]) if line else {}


def capacity() -> dict:
    """The capacity probe's twin as a user runs it, at 2^20 columns; where
    they do not fit, the allocator's message is kept and the width halved
    until one fits."""
    import os
    runs = []
    ncol = CAP_NCOL
    while True:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "elmkernels_torch.tools.capacity_probe"],
            cwd=REPO, capture_output=True, text=True, timeout=CAP_TIMEOUT_S,
            env=dict(os.environ, CAP_NCOL=str(ncol), CAP_STEPS=str(CAP_STEPS)))
        lines = proc.stdout.strip().splitlines()
        if proc.returncode not in (0, 3) or not lines:
            raise AssertionError(f"capacity probe at {ncol} exited "
                                 f"{proc.returncode}:\n{proc.stdout}\n"
                                 f"{proc.stderr[-4000:]}")
        rec = dict(json.loads(lines[-1]), wall_s_with_start=(
            time.perf_counter() - t0), launches=_launch_note(proc.stderr),
            notes=[ln for ln in proc.stderr.splitlines()
                   if ln.startswith("#")])
        runs.append(rec)
        phase(f"capacity probe at {ncol} columns: " + json.dumps(rec))
        if rec["fits"]:
            break
        if ncol // 2 < CAP_MIN_NCOL:
            raise AssertionError(f"no width from {CAP_NCOL} down to "
                                 f"{CAP_MIN_NCOL} fits: {runs}")
        ncol //= 2
    last = runs[-1]
    if not (last["errsol_max"] <= last["errsol_bound"]
            and last["errh2o_led_max"] < GLOBAL_LEDGER_BOUND
            and all(last["launches"].get(k) for k in ("ci_hybrid_solve",
                                                      "pdma_solve"))):
        raise AssertionError(f"capacity run broke a contract: {last}")
    return dict(runs=runs, fits_ncol=last["ncol"])


def concurrent_twins() -> dict:
    """The long-run and single-column twins and the twins of the JAX
    package's last tools (``TOOL_RUNS``), each a subprocess as a user runs
    it, all started together: they share the card and the host, so the
    times they print are not each one's alone (the benches run alone
    before them).  The long run must resume bit for bit with no guard
    trip, the demo print its 100 steps, ``f32_check`` pass, the drift runs
    stay finite with a closed ledger and ``weak_scaling`` say that one
    card measures no scaling; any failure fails the run."""
    import os
    out_dir = REPO / "build" / "twins"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"long_run": (["elmkernels_torch.tools.long_run"], dict(
                LR_OUT=str(REPO / "build" / "longrun"), **LONG_RUN_ENV)),
            "single_column": (["elmkernels_torch.examples.run_single_column"],
                              {})}
    for name, args, env in TOOL_RUNS:
        jobs[name] = ([f"elmkernels_torch.tools.{name}", *args], env)
    procs, done = {}, {}
    t0 = time.perf_counter()
    try:
        for name, (args, env) in jobs.items():
            with open(out_dir / f"{name}.out", "w") as fo, \
                    open(out_dir / f"{name}.err", "w") as fe:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", *args], cwd=REPO, stdout=fo,
                    stderr=fe, env=dict(os.environ, **env))
        for name, proc in procs.items():
            left = TWIN_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                proc.wait(timeout=max(1.0, left))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name} outlasted {TWIN_TIMEOUT_S} s")
            done[name] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    res = {}
    for name, proc in procs.items():
        out = (out_dir / f"{name}.out").read_text()
        err = (out_dir / f"{name}.err").read_text()
        if proc.returncode != 0:
            raise AssertionError(f"{name} exited {proc.returncode}:\n"
                                 f"{out[-4000:]}\n{err[-4000:]}")
        res[name] = dict(stdout=out, notes=[ln for ln in err.splitlines()
                                            if ln.startswith("#")],
                         done_after_s=done[name])

    summary = json.loads(res["long_run"]["stdout"].strip().splitlines()[-1])
    res["long_run"] = dict(summary, done_after_s=done["long_run"])
    phase("long-run twin: " + json.dumps(res["long_run"]))
    lines = res["single_column"]["stdout"].strip().splitlines()
    res["single_column"] = dict(lines=len(lines), first=lines[:1],
                                last=lines[-1:],
                                done_after_s=done["single_column"])
    phase("single-column twin: " + json.dumps(res["single_column"]))
    for name, _, _ in TOOL_RUNS:
        out = res[name].pop("stdout")
        res[name]["out"] = json.loads(
            out if name == "mixed_canopy_drift"
            else out.strip().splitlines()[-1])
        phase(f"tool twin {name}: " + json.dumps(res[name]))
    rows = res["mixed_canopy_drift"]["out"]["results"]
    checks = dict(
        long_run=(summary["resume_bit_identical"]
                  and summary["guard_failures"] == 0),
        single_column=(len(lines) == 101
                       and lines[-1].startswith("final errsol_max=")),
        f32_check=res["f32_check"]["out"]["ok"],
        mixed_canopy_drift=all(
            r["finite"] and r["errh2o_led_max"] < GLOBAL_LEDGER_BOUND
            for r in rows.values() if "finite" in r),
        weak_scaling=(len(res["weak_scaling"]["out"]) == 1
                      and any("no scaling" in n for n in
                              res["weak_scaling"]["notes"])))
    phase(f"concurrent twins: {time.perf_counter() - t0:.1f} s, "
          + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"a twin failed its checks: {checks}")
    return res


def synthetic_files():
    """The synthetic parameter, optics and aging files, written under
    ``build/synthetic``."""
    from elmkernels_torch.data import synthetic
    files_dir = REPO / "build" / "synthetic"
    files_dir.mkdir(parents=True, exist_ok=True)
    files = (files_dir / "clm_params.nc", files_dir / "snicar_optics.nc",
             files_dir / "snicar_drdt.nc")
    synthetic.write_clm_params(files[0])
    synthetic.write_snicar_optics(files[1])
    synthetic.write_snow_aging_tables(files[2])
    return files


def k1t_profile_main() -> int:
    """``python3 chip_smoke.py --k1t-profile``: K1-T alone, for finding
    what holds it back.  Builds the kernels and the probe, then profiles
    K1-T (:func:`k1t_profile`) on its test problems (2 x 262,144 "mixed"
    leaves at dry shares 0.25 and 1.0) and on the sensitivity model at
    noon (:func:`sens_noon`).  Prints one JSON line per measurement."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from elmkernels_torch.ops import build, ci_solver
    t0 = time.perf_counter()
    phase(f"card: {card_line()}")
    build.build()
    test = k1t_test_phase()
    m, _, _, _ = sens_model(synthetic_files(), global_inputs())
    sens_noon(m, {"ci_hybrid_solve_jvp": ci_solver.ci_hybrid_solve_jvp},
              test["ctx"])
    phase(f"profile: {time.perf_counter() - t0:.1f} s")
    return 0


def k1t_numbers(test: dict) -> dict:
    """K1-T's test-problem and build numbers for the kernels line."""
    probe = test["probe"]
    mixed = [v for k, v in probe["kernels"].items() if "ILi2E" in k]
    out = dict(registers=mixed[0]["registers"] if mixed else None,
               spill_bytes=(mixed[0]["spill_store_bytes"]
                            + mixed[0]["spill_load_bytes"]) if mixed
               else None,
               blocks_per_sm=probe["blocks_per_sm"],
               warps_per_sm=probe["warps_per_sm"],
               f64_pipe_instructions_per_eval=probe["eval_f64_pipe"],
               sm_clock_mhz=test["ctx"]["clock_mhz"],
               test_plain_ms=test["plain_ms"])
    for prof in test["profiles"]:
        key = ("test" if prof["dry_share"] == K1T_DRY_SHARES[0]
               else "test_all_dry")
        out.update({f"{key}_{k}": prof.get(k) for k in (
            "ms", "bound_ms", "share_of_bound", "committed_evals_per_leaf",
            "warp_efficiency_schedule", "warp_efficiency_one_thread",
            "f64_pipe_floor_ms")})
    return out


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
    from elmkernels_torch.ops import build, ci_solver, pdma

    t_script = time.perf_counter()
    laps, t_lap = {}, [t_script]

    def lap(label: str) -> None:
        """Seconds since the last lap, printed with the others at the end."""
        now = time.perf_counter()
        laps[label] = round(now - t_lap[0], 1)
        t_lap[0] = now

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
    phase("K4 pdma_kernel<float> launch layout: "
          + json.dumps(pdma.layout(torch.float32)))
    lap("build")
    # first, while this process holds no device memory but its context
    cap = capacity()
    lap("capacity")

    # the main path's production flags run the canopy loop, and so the ci
    # solve, in float32 (mixed_canopy): its numbers go in the kernels line
    n_leaves = 2 * 262144
    check_ci(n_leaves, "c3", torch.float64, 1e-12, time_it=True)
    k1 = check_ci(n_leaves, "c3", torch.float32, 1e-5, time_it=True)
    check_ci(n_leaves, "c4", torch.float64, 1e-12, time_it=False)
    check_ci(n_leaves, "mixed", torch.float64, 1e-12, time_it=False)
    # the production loop's type and mode: float32, "mixed", per-leaf traits
    check_ci(n_leaves, "mixed", torch.float32, 1e-5, time_it=False)
    k1t_test = k1t_test_phase()
    k4 = check_pdma(262144)
    k4f = check_pdma(262144, torch.float32)
    entry_overhead()
    lap("kernel checks")

    files = synthetic_files()

    wrappers = {"ci_hybrid_solve": ci_solver.ci_hybrid_solve,
                "pdma_solve": pdma.pdma_solve}
    # end-to-end numbers from a run with no timer installed; the kernels'
    # times per launch from 12 steps around noon under the timers
    main_run, launches, _ = drive(262144, 7, MAIN_STEPS, files, "main path",
                                  wrappers)
    lap("main path")
    t1, t4 = timers(keep_pdma=PDMA_KEPT)
    with t1, t4:
        _, timed, _ = drive(262144, 7, 12, files, "main path, timed",
                            wrappers, start_step=18)
    on_path = timed_summaries(t1, t4, timed, "main path")
    k4_path = check_pdma_on_path(t4.kept, "main path")
    del t1, t4
    lap("main path, timed")
    f32 = float32_path(files)
    lap("float32 path")
    winter, _, winter_model = drive(8192, 1, WINTER_STEPS, files,
                                    "winter path", wrappers)
    if winter["snl_max"] == 0:
        raise AssertionError("winter path made no snow layers")
    lap("winter path")
    winter_aging(winter_model, files, wrappers)
    snowy = clone(winter_model.state)
    del winter_model
    lap("winter aging")
    refformats, on_ref = reference_formats(files, snowy, wrappers)
    del snowy
    lap("reference formats")
    loops = check_loops(files, wrappers)
    lap("loops")
    packed_update_cost()
    lap("packed carry")
    shard = sharded_loops(files, loops)
    lap("sharded loops")
    inputs = global_inputs()
    prod, prod_launches, on_prod = production_loop(files, inputs, wrappers)
    lap("production loop")
    _, land_launches, on_land = landunits(files, inputs, wrappers,
                                          prod["ms_per_step"])
    lap("landunits")
    operations(files, inputs, wrappers)
    lap("operations")
    sens = sensitivity(files, inputs, k1t_test["ctx"])
    on_sens, sens_launches = sens["on_path"], sens["launches"]
    lap("sensitivity")
    twins = entry_twins(card)
    lap("bench twins")
    concurrent_twins()
    lap("concurrent twins")
    native_reader()
    lap("native reader")
    ing = ingest(wrappers)
    lap("ingest")

    def numbers(name, test):
        m, p, g = on_path[name], on_prod[name], on_land[name]
        ranks = [r for run in shard.values() for r in run["per_rank"]]
        return dict(launches=launches[name], ms=m["ms"],
                    shard_launches=[r["launches"][name] for r in ranks],
                    shard_ms=[r["on_path"][name]["ms"] for r in ranks],
                    shard_share_of_bound=[
                        r["on_path"][name]["share_of_bound"] for r in ranks],
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
                    land_share_of_bound=g["share_of_bound"],
                    refformats_launches=refformats["text"]["launches"][name],
                    refformats_ms=on_ref[name]["ms"],
                    refformats_bound_ms=on_ref[name]["bound_ms"],
                    refformats_share_of_bound=on_ref[name][
                        "share_of_bound"])

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
             sens_launches=sens_launches["pdma_solve"],
             sens_ms=on_sens["pdma_solve"]["ms"],
             sens_bound_ms=on_sens["pdma_solve"]["bound_ms"],
             sens_share_of_bound=on_sens["pdma_solve"]["share_of_bound"],
             sens_tangent_max_rel=sens["res"]["k4_tangent"][
                 "max_rel_tangent"],
             **numbers("pdma_solve", k4)),
    ]
    # this slice's full-width path (ingest from month files) and the
    # capacity probe's run also launch K1 and K4
    for k in kernels:
        k.update(ingest_launches=ing["launches"][k["name"]],
                 capacity_ncol=cap["fits_ncol"],
                 capacity_launches=cap["runs"][-1]["launches"][k["name"]])
    # K4 in float32 runs on the float32 path (and the float32 bench): its
    # launches and per-launch times are that path's
    t = f32["on_path"]
    kernels.append(dict(
        name="pdma_solve_f32", route="cuda",
        source="elmkernels_torch/csrc/pdma_solve.cu",
        replaces="elmkernels_tpu/physics/soil_temperature.py:282",
        launches=f32["launches"]["pdma_solve_f32"],
        max_abs_err=max(k4f["max_abs_x"], f32["k4"]["max_abs_x"]),
        ms=t["ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        share_of_bound=t["share_of_bound"], plain_ms=k4f["plain_ms"],
        library_ms=k4f["library_ms"], test_ms=k4f["test_ms"],
        test_bound_ms=k4f["test_bound_ms"],
        test_share_of_bound=k4f["test_share_of_bound"],
        bench_launches=twins["bench"][-1]["launches"]["pdma_solve_f32"]))
    # K1-T runs only on the sensitivity path: its launches and times are
    # that path's
    k1t, t = sens["res"]["k1t"], on_sens["ci_hybrid_solve_jvp"]
    kernels.append(dict(
        name="ci_hybrid_solve_jvp", route="cuda",
        source="elmkernels_torch/csrc/ci_hybrid_solve.cu",
        replaces="elmkernels_tpu/driver/sensitivity.py:91",
        launches=sens_launches["ci_hybrid_solve_jvp"], max_abs_err=k1t[
            "max_abs"], ms=t["ms"], plain_ms=k1t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        share_of_bound=t["share_of_bound"], library_ms=None,
        sens_launches=sens_launches["ci_hybrid_solve_jvp"], sens_ms=t["ms"],
        sens_bound_ms=t["bound_ms"], sens_share_of_bound=t["share_of_bound"],
        sens_max_rel_value=k1t["max_rel_value"],
        sens_max_rel_tangent=k1t["max_rel_tangent"],
        sens_equal_iters=k1t["equal_iters"],
        sens_bit_for_bit=k1t["bit_for_bit"],
        sens_warp_efficiency=[p["warp_efficiency_schedule"]
                              for p in sens["profiles"]],
        sens_evals_per_leaf=[p["committed_evals_per_leaf"]
                             for p in sens["profiles"]],
        sens_noon_launches=sens["noon"]["launches"],
        sens_noon_ms=sens["noon"]["on_path"]["ms"],
        sens_noon_bound_ms=sens["noon"]["on_path"]["bound_ms"],
        sens_noon_bound_by=sens["noon"]["on_path"]["bound_by"],
        sens_noon_share_of_bound=sens["noon"]["on_path"]["share_of_bound"],
        sens_noon_warp_efficiency=sens["noon"]["res"]["warp_efficiency"],
        sens_noon_evals_per_leaf=sens["noon"]["res"]["evals_per_leaf"],
        **k1t_numbers(k1t_test)))
    phase("phase times, s: " + json.dumps(laps))
    phase(f"script: {time.perf_counter() - t_script:.1f} s after start")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--k1t-profile"]:
        sys.exit(k1t_profile_main())
    if sys.argv[1:2] == ["--shard-rank"]:
        rank, nranks, port = (int(a) for a in sys.argv[2:5])
        sys.exit(shard_rank(rank, nranks, port, sys.argv[5],
                            sys.argv[6] == "1"))
    sys.exit(main())
