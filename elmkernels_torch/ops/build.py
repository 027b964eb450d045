"""Build the port's CUDA kernels from ``elmkernels_torch/csrc`` and load them.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  The build goes into
``build/kernels`` at the root of the checkout (listed in ``.gitignore``),
at first use; the file name carries a hash of the source and the flags, so
a changed source is rebuilt.  :func:`build` starts one ``nvcc`` per source,
all at once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = {"ci_hybrid_solve": "ci_hybrid_solve.cu",
           "pdma_solve": "pdma_solve.cu"}
# --fmad=false: no contracted multiply-adds, so each kernel repeats its
# plain version's arithmetic operation by operation
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           "the elmkernels_torch kernels")
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{key[:12]}.so"


def build(names=None) -> dict:
    """Compile the named kernels (default: all) whose library is missing,
    one ``nvcc`` each, concurrently.  Returns {name: seconds} for the
    builds it ran; the ``ptxas`` report of each lands beside its library
    as ``<lib>.log``.  Raises with the compiler's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    times = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said about kernel ``name`` (registers, spills)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
