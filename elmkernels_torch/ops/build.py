"""Build the port's CUDA kernels from ``elmkernels_torch/csrc`` and load them.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  A kernel listed in
``CONTRACTED`` links in device code compiled apart with contracted
multiply-adds (relocatable device code: each source to an object, then one
link).  The build goes into ``build/kernels`` at the root of the checkout
(listed in ``.gitignore``), at first use; the file name carries a hash of
the sources, the headers they include and the flags, so a changed source or
header is rebuilt.  :func:`build` starts the compiles of every kernel at
once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = {"ci_hybrid_solve": "ci_hybrid_solve.cu",
           "pdma_solve": "pdma_solve.cu",
           "canopy_stability": "canopy_stability.cu",
           "snow_hydrology": "snow_hydrology.cu",
           "snow_snicar": "snow_snicar.cu",
           "soil_temperature": "soil_temperature.cu"}
# device code a kernel's library links in, compiled with --fmad=true:
# canopy_pow.cu and snow_math.cu hold pow, snicar_math.cu log10, as
# PyTorch's kernels, built so, compute them
CONTRACTED = {"canopy_stability": "canopy_pow.cu",
              "snow_hydrology": "snow_math.cu",
              "snow_snicar": "snicar_math.cu",
              "soil_temperature": "snow_math.cu"}
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# --fmad=false: no contracted multiply-adds, so each kernel repeats its
# plain version's arithmetic operation by operation
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           "the elmkernels_torch kernels")
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def sources_of(name: str) -> list[pathlib.Path]:
    """Kernel ``name``'s source and every file it includes by
    ``#include "..."``, transitively (resolved beside the including file),
    in the order first reached."""
    order, todo = [], [CSRC / SOURCES[name]]
    while todo:
        path = todo.pop(0)
        if path in order:
            continue
        order.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return order


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    paths = sources_of(name)
    if name in CONTRACTED:
        digest.update(b"contracted, linked with -rdc=true")
        paths.append(CSRC / CONTRACTED[name])
    for path in paths:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    key = digest.hexdigest()
    return BUILD_DIR / f"lib{name}_{key[:12]}.so"


def _steps(name: str, out: pathlib.Path) -> list:
    """Kernel ``name``'s build into ``out``: stages of ``nvcc`` command
    lines; a stage's commands run at once, the stages in turn.  One stage
    of one command, or, for a kernel in CONTRACTED, its source and the
    contracted one each compiled to relocatable device code, then linked."""
    src = CSRC / SOURCES[name]
    if name not in CONTRACTED:
        return [[[*NVCC_FLAGS, "-o", str(out), str(src)]]]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-dc"]
    contracted = ["--fmad=true" if f == "--fmad=false" else f
                  for f in compile_flags]
    objs = [out.with_suffix(".main.o"), out.with_suffix(".contracted.o")]
    return [[[*compile_flags, "-o", str(objs[0]), str(src)],
             [*contracted, "-o", str(objs[1]), str(CSRC / CONTRACTED[name])]],
            [[*_ARCH, "-rdc=true", "-shared", "-Xcompiler", "-fPIC", "-o",
              str(out), *map(str, objs)]]]


def build(names=None) -> dict:
    """Compile the named kernels (default: all) whose library is missing,
    every kernel's compiles at once.  Returns {name: seconds} for the
    builds it ran; the ``ptxas`` report of each lands beside its library
    as ``<lib>.log``.  Raises with the compiler's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    times, failures = {}, []

    def run(name, out):
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = []
        for stage in _steps(name, tmp):
            procs = [subprocess.Popen([nvcc, *cmd], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in stage]
            outs = [(p.communicate()[0], p.returncode) for p in procs]
            log += [text for text, _ in outs]
            if any(rc != 0 for _, rc in outs):
                failures.append(f"nvcc failed for {name}:\n" + "".join(log))
                return
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text("".join(log))
        for obj in tmp.parent.glob(tmp.stem + ".*.o"):
            obj.unlink()
        os.replace(tmp, out)

    threads = [threading.Thread(target=run, args=(name, _target(name)))
               for name in names if not _target(name).exists()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
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
