"""Overlap of the window ingest with the device compute, at scale.

    IB_NCOL=65536 python -m elmkernels_torch.tools.ingest_bench

The port's twin of the JAX package's ``tools/ingest_bench.py``.  It
compares the per-step wall time of

- the pre-staged windows: every window's inputs assembled on the host and
  copied to the device before the clock starts (pure compute), then run
  as ``run_scan`` (or ``run_scan_series``) runs them;
- ``Model.run_windows``, the production loop: the NEXT window assembled
  and copied on a host thread while the CURRENT one computes.

Equal times mean an ingest that never stalls the step; the windowed loop's
overhead is reported as a ratio.

``IB_FILES=1`` switches to month files: reference-layout forcing files,
July and August (the bridge), written by
``elmkernels_torch.data.synthetic.write_forcing_months``, read through the
port's native reader with next-month prefetch; ``run_windows(series=True)``
runs from them, timed against the pre-staged ``run_scan_series`` windows
and held equal to them bit for bit on every state field.  The host
assembly of one window (file reads and the series build, no device) is
timed on its own, cold (the month's file read) and warm, and one window's
hyperslab reads are timed by the native reader and by scipy (``netcdf.
read_var`` on an open scipy file), and held equal.

Knobs: ``IB_NCOL`` (65536), ``IB_WINDOW`` (48), ``IB_NWIN`` (4),
``IB_FILES``; in files mode ``IB_NLON`` (256) and ``IB_FORCDIR`` (default
``build/ingest/<nlat>x<nlon>`` in the checkout); ``IB_PLATFORM=cpu`` runs
on the CPU (default: the card).  One JSON line on stdout, with the JAX
script's keys; comment lines on stderr.  Exit 1 if the files run diverges
from the pre-staged one.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

FORCING_VARS = ("TBOT", "PBOT", "QBOT", "FLDS", "FSDS", "PRECTmms", "WIND")


def _device():
    return "cpu" if os.environ.get("IB_PLATFORM") == "cpu" else None


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def date_start(start, dtime: float, window: int):
    """The date ``window`` steps of ``dtime`` seconds after ``start``."""
    d = start.copy()
    d.increment_seconds(int(dtime) * window)
    return d


def _launch_counts(reset: bool = False) -> dict:
    """The kernel wrappers' launch counts (zeroed first with ``reset``)."""
    from elmkernels_torch.ops import ci_solver, pdma
    ks = (ci_solver.ci_hybrid_solve, pdma.pdma_solve, pdma.pdma_solve_f32)
    if reset:
        for k in ks:
            k.launches = 0
    return {k.__name__: k.launches for k in ks}


def forcing_files(ncol: int, nlon: int, directory=None) -> tuple:
    """(basename, nlat): July and August 1985 month files on a
    (nlat, nlon) grid of at least ``ncol`` cells, written once."""
    from elmkernels_torch.data import synthetic
    nlat = (ncol + nlon - 1) // nlon
    d = pathlib.Path(directory or synthetic.BUILD_DIR / "ingest"
                     / f"{nlat}x{nlon}")
    base = str(d / "forc_")
    if not (pathlib.Path(f"{base}1985-07.nc").exists()
            and pathlib.Path(f"{base}1985-08.nc").exists()):
        d.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # written aside, then renamed, so a file appears whole
        tmp = str(d / f"tmp{os.getpid()}_")
        for path in synthetic.write_forcing_months(tmp, 1985, 7, 2, nlat,
                                                   nlon):
            os.replace(path, base + path[len(tmp):])
        print(f"# generated 2 month files ({nlat}x{nlon} grid) in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return base, nlat


def window_slabs(path: str, ncol: int, nt: int, t0: int = 0) -> list:
    """(variable, start, count) of one window's forcing hyperslabs: ``nt``
    samples from sample ``t0``, the grid rows that hold cells [0, ncol)."""
    from elmkernels_torch.data import netcdf
    out = []
    for v in FORCING_VARS:
        shape = netcdf.get_dimensions(path, v)
        nlon = int(np.prod(shape[2:], dtype=np.int64))
        rows = (ncol + nlon - 1) // nlon
        out.append((v, (t0, 0) + (0,) * (len(shape) - 2),
                    (nt, rows) + tuple(shape[2:])))
    return out


def window_reads(path: str, ncol: int, nt: int, reps: int = 3) -> dict:
    """One window's hyperslab reads (``nt`` samples of the seven forcing
    variables over ``ncol`` cells) by the native reader and by scipy, each
    from a file opened beforehand (opening is timed apart: the native
    reader loads the whole file, scipy maps it), held equal at atol 0.
    Host milliseconds, the best of ``reps``."""
    from scipy.io import netcdf_file

    from elmkernels_torch.data import netcdf
    slabs = window_slabs(path, ncol, nt)
    t0 = time.perf_counter()
    nf = netcdf.open_native(path)
    native_open = time.perf_counter() - t0
    t0 = time.perf_counter()
    sf = netcdf_file(path, mmap=True)
    scipy_open = time.perf_counter() - t0
    try:
        def reads(f):
            return [netcdf.read_var(f, v, start=s, count=n)
                    for v, s, n in slabs]

        times = {"native": [], "scipy": []}
        out = {}
        for _ in range(reps):
            for name, f in (("native", nf), ("scipy", sf)):
                t0 = time.perf_counter()
                out[name] = reads(f)
                times[name].append(time.perf_counter() - t0)
        equal = all(np.array_equal(a, b)
                    for a, b in zip(out["native"], out["scipy"]))
        nbytes = sum(a.nbytes for a in out["native"])
    finally:
        nf.close()
        sf.close()
    return dict(window_samples=nt, read_mb=nbytes / 1e6,
                native_open_s=native_open, scipy_open_s=scipy_open,
                native_reads_ms=min(times["native"]) * 1e3,
                scipy_reads_ms=min(times["scipy"]) * 1e3,
                reads_equal=equal)


def _payload_bytes(tree) -> int:
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, tuple):
        return sum(_payload_bytes(v) for v in tree)
    return 0


def bench_files(ncol: int, window: int, nwin: int, device=None,
                nlon: int | None = None, forcdir=None,
                start=(1985, 7, 1, 0)) -> dict:
    """Series ingest from month files: ``run_windows(series=True)``
    through the native reader and prefetch, against the pre-staged
    series windows; returns the JSON record (``bit_identical`` False when
    the two runs' states differ).  ``start`` (year, month, day, second of
    the day) is the first window's; a start late in July puts the timed
    windows across the month boundary, so that August's load runs on the
    host thread under the clock."""
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date

    nlon = nlon or int(os.environ.get("IB_NLON", "256"))
    base, nlat = forcing_files(
        ncol, nlon, forcdir or os.environ.get("IB_FORCDIR"))
    fsize = os.path.getsize(f"{base}1985-07.nc")
    print(f"# forcing file: {fsize / 1e6:.1f} MB/month, native reader "
          f"(elmkernels_torch/csrc/elmio.cc)", file=sys.stderr)
    pft, snicar = synthetic.parameter_files()

    def make():
        return Model(ncol=ncol, forcing_basename=base, pft_path=pft,
                     snicar_path=snicar, device=device)
    m_pre, m_ovl = make(), make()
    dev = m_pre.device
    start = Date.from_ymd(*start)
    nt = int(np.ceil(window * m_pre.dtime / m_pre.forcing.dt_forcing)) + 2
    reads = window_reads(f"{base}1985-07.nc", ncol, nt)
    print(f"# one window's reads ({nt} samples x 7 variables, "
          f"{reads['read_mb']:.1f} MB): native {reads['native_reads_ms']:.1f}"
          f" ms (open {reads['native_open_s']:.2f} s), scipy "
          f"{reads['scipy_reads_ms']:.1f} ms (open "
          f"{reads['scipy_open_s']:.3f} s), equal: {reads['reads_equal']}",
          file=sys.stderr)

    # host assembly alone (file reads and the series build, no device):
    # cold includes the month file's read, warm uses the cached month
    t0 = time.perf_counter()
    m_pre._host_series(start, window)
    t_host_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    payload0 = m_pre._host_series(start, window)
    t_host_warm = time.perf_counter() - t0
    nbytes = _payload_bytes(payload0)
    print(f"# host series assembly: cold {t_host_cold:.3f}s / warm "
          f"{t_host_warm:.3f}s per {window}-step window; payload "
          f"{nbytes / 1e6:.1f} MB", file=sys.stderr)

    # the first window, off the clock (the kernels' load)
    t0 = time.perf_counter()
    m_pre.run_scan_series(start, window)
    _sync(dev)
    print(f"# first window: {time.perf_counter() - t0:.1f}s ncol={ncol} "
          f"window={window} device={dev}", file=sys.stderr)

    # pre-staged: the next nwin windows' payloads on the device first
    date = date_start(start, m_pre.dtime, window)
    staged = []
    for _ in range(nwin):
        idx1, pidx, pinned = m_pre._pin_series(
            m_pre._host_series(date, window))
        staged.append((idx1, pidx, m_pre._put(pinned)))
        date.increment_seconds(int(m_pre.dtime) * window)
    _sync(dev)
    t0 = time.perf_counter()
    for idx1, pidx, payload in staged:
        m_pre._scan_series(idx1, pidx, payload)
    _sync(dev)
    t_pre = (time.perf_counter() - t0) / (nwin * window)
    del staged

    # overlapped: files -> native reader (+ prefetch) -> series payload
    # -> copy, on the host thread against the device compute
    m_ovl.run_scan_series(start, window)      # the same first window
    _sync(dev)
    t0 = time.perf_counter()
    m_ovl.run_windows(date_start(start, m_ovl.dtime, window), nwin * window,
                      window=window, series=True)
    _sync(dev)
    t_ovl = (time.perf_counter() - t0) / (nwin * window)

    same = all(torch.equal(a, b) for a, b in zip(m_pre.state, m_ovl.state))
    overhead = t_ovl / t_pre - 1.0
    print(f"# pre-staged {t_pre * 1e3:.2f} ms/step | overlapped-files "
          f"{t_ovl * 1e3:.2f} ms/step ({overhead * 100:+.1f}%) | "
          f"bit-identical: {same}", file=sys.stderr)
    return {
        "mode": "files", "ncol": ncol, "window": window,
        "file_mb_per_month": round(fsize / 1e6, 1),
        "host_assembly_cold_s": round(t_host_cold, 3),
        "host_assembly_warm_s": round(t_host_warm, 3),
        "payload_mb_per_window": round(nbytes / 1e6, 2),
        "prestaged_ms": round(t_pre * 1e3, 3),
        "overlapped_files_ms": round(t_ovl * 1e3, 3),
        "overhead_pct": round(overhead * 100, 2),
        "bit_identical": bool(same),
        "device": str(dev), "grid": [nlat, nlon], "nwin": nwin,
        "start": "%04d-%02d-%02d %05ds" % (*start.date(), start.sec),
        "window_native_reads_ms": round(reads["native_reads_ms"], 3),
        "window_scipy_reads_ms": round(reads["scipy_reads_ms"], 3),
        "native_open_s": round(reads["native_open_s"], 3),
        "scipy_open_s": round(reads["scipy_open_s"], 4),
        "window_reads_equal": reads["reads_equal"]}


def bench_synthetic(ncol: int, window: int, nwin: int, device=None) -> dict:
    """In-memory synthetic forcing: the per-step stack layout pre-staged
    against ``run_windows``, and ``run_windows(series=True)``."""
    from elmkernels_torch.data import synthetic
    from elmkernels_torch.driver.model import Model
    from elmkernels_torch.utils.dates import Date

    pft, snicar = synthetic.parameter_files()
    model = Model(ncol=ncol, pft_path=pft, snicar_path=snicar, device=device)
    dev = model.device
    start = Date.from_ymd(1985, 7, 1)

    t0 = time.perf_counter()
    model.run_scan(start, window)
    _sync(dev)
    print(f"# first window: {time.perf_counter() - t0:.1f}s ncol={ncol} "
          f"window={window} device={dev}", file=sys.stderr)

    # pre-staged: every window's stacks on the device before the clock
    date = date_start(start, model.dtime, window)
    stacks = []
    for _ in range(nwin):
        stacks.append(model.stack_windows(date, window))
        date.increment_seconds(int(model.dtime) * window)
    _sync(dev)
    t0 = time.perf_counter()
    for payload in stacks:
        model._scan(payload)
    _sync(dev)
    t_scan = (time.perf_counter() - t0) / (nwin * window)
    del stacks

    # overlapped: window k+1's assembly and copy against window k
    t0 = time.perf_counter()
    model.run_windows(date, nwin * window, window=window)
    _sync(dev)
    t_win = (time.perf_counter() - t0) / (nwin * window)

    # overlapped series layout (one window first, off the clock)
    model.run_windows(date, window, window=window, series=True)
    _sync(dev)
    t0 = time.perf_counter()
    model.run_windows(date, nwin * window, window=window, series=True)
    _sync(dev)
    t_ser = (time.perf_counter() - t0) / (nwin * window)

    overhead = t_win / t_scan - 1.0
    overhead_s = t_ser / t_scan - 1.0
    print(f"# pre-staged {t_scan * 1e3:.2f} ms/step | overlapped "
          f"{t_win * 1e3:.2f} ms/step ({overhead * 100:+.1f}%) | "
          f"overlapped-series {t_ser * 1e3:.2f} ms/step "
          f"({overhead_s * 100:+.1f}%)", file=sys.stderr)
    return {"ncol": ncol, "window": window,
            "prestaged_ms": round(t_scan * 1e3, 3),
            "overlapped_ms": round(t_win * 1e3, 3),
            "overlapped_series_ms": round(t_ser * 1e3, 3),
            "overhead_pct": round(overhead * 100, 2),
            "series_overhead_pct": round(overhead_s * 100, 2),
            "device": str(dev)}


def main() -> int:
    ncol = int(os.environ.get("IB_NCOL", "65536"))
    window = int(os.environ.get("IB_WINDOW", "48"))
    nwin = int(os.environ.get("IB_NWIN", "4"))
    files = os.environ.get("IB_FILES", "0") == "1"
    _launch_counts(reset=True)
    if files:
        rec = bench_files(ncol, window, nwin, _device())
    else:
        rec = bench_synthetic(ncol, window, nwin, _device())
    print("# launches: " + json.dumps(_launch_counts()), file=sys.stderr)
    print(json.dumps(rec))
    if files and not rec["bit_identical"]:
        print("# overlapped file ingest diverged from pre-staged",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
