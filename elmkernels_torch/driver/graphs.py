"""The compiled step: the step captured once per configuration as a CUDA
graph, and replayed by the model's loops.

Counterpart of the JAX package's ``_jitted_step``, ``_jitted_scan`` and
``_jitted_scan_series`` (``elmkernels_tpu/driver/model.py``).  There
``jax.jit`` compiles the step, and ``lax.scan`` a window of steps, into
one executable, keyed by the static arguments and the inputs' shapes and
dtypes, with the state donated.  Here the step is recorded once as a CUDA
graph (``torch.cuda.CUDAGraph``) that reads its inputs from static
buffers and the state from the model's packed carry
(:mod:`elmkernels_torch.utils.packing`), and writes the new state back
into the carry.  Each step of ``Model.advance`` (so ``run``),
``run_scan``, ``run_scan_series`` and ``run_windows`` then copies its
inputs into the buffers and launches the graph: one launch in place of the
~11,000 kernel launches of the eager step, and no host wait.

One graph is one step, not a window: a window's graph would hold hundreds
of thousands of nodes, and the series layout's bracket rows move from
step to step, so each step's rows are copied into the buffers before the
replay instead (:meth:`StepGraphs.step`).

- **The key** (:func:`key_of`), as JAX keys its executable: the step's
  static arguments (land type, ``dtime``, the flags, the photosynthesis
  mode), the state's template and the carry's buffers, the inputs' shapes
  and dtypes, the device; and, because a graph bakes addresses, the
  address, shape and strides of every tensor of the parameters, traits,
  albedo traits and SNICAR tables.  A new key drops the old graph (and its
  memory pool): a model whose ``params`` were replaced never replays a
  graph that reads the old buffers.
- **Warm-up**: the first step under a key runs eagerly on the static
  buffers.  It builds the kernels, fills ``math_utils.const``'s cache
  (whose first use is a host copy) and sets the kernels' launch
  attributes.  The next step is captured, then replayed.
- **Counters**: the kernels count their launches on themselves in Python,
  which runs at capture and not at replay.  The capture records each
  counted entry point's launches (:data:`COUNTED`) and every replay adds
  them; K2's last launch's counters (``canopy.counters()``) then read the
  captured launch's buffer, which the graph's pool keeps.
- **No fallback**: a capture that fails (a host wait inside the step, an
  operation a stream capture refuses) raises :class:`CaptureError`, naming
  the torch operation and the line it met.  The eager step on a card is
  asked for with :func:`disable_graphs`, the port's ``jax.disable_jit``.

The CPU always runs the eager step.  :data:`GRAPH` is a seam through
which a test hands in a stand-in for :class:`CudaGraph` (one whose replay
runs the captured body again), so that the captured path also runs on
the CPU; nothing on the card's path sets it.
"""

from __future__ import annotations

import contextlib
import os
import time
import traceback

import torch
from torch.overrides import TorchFunctionMode

from elmkernels_torch.ops import (canopy, ci_solver, pdma, snicar, snow,
                                  soil_temperature)
from elmkernels_torch.utils.packing import template_of

__all__ = ["disable_graphs", "uses_graphs", "key_of",
           "CaptureError", "CudaGraph", "StepGraphs", "COUNTED", "GRAPH"]

_disabled = 0

# a stand-in class for CudaGraph, set by tests; None on the card's path
GRAPH = None

# the kernels' entry points that count their launches on themselves, as
# (module, attribute): looked up at each use, so that a wrapper installed
# in an entry point's place (a timer, a spy) passes the count through
COUNTED = ((canopy, "canopy_stability"), (pdma, "pdma_solve"),
           (pdma, "pdma_solve_f32"), (ci_solver, "ci_hybrid_solve"),
           (ci_solver, "ci_hybrid_solve_jvp"), (snow, "snow_hydrology"),
           (snicar, "snicar"), (soil_temperature, "soil_temperature"))


@contextlib.contextmanager
def disable_graphs():
    """Inside this context every loop runs the eager step, op by op (the
    port's ``jax.disable_jit``): for comparisons, and for timers that put
    events around each kernel call."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def uses_graphs(device) -> bool:
    """Whether a model on ``device`` replays its step now: on a card
    unless graphs are disabled; on the CPU only with a stand-in graph."""
    return _disabled == 0 and (GRAPH is not None
                               or torch.device(device).type == "cuda")


def _sig(v):
    """What a graph bakes of ``v``: a tensor's address, shape, strides,
    dtype and device; a tuple's leaves; a plain value itself."""
    if isinstance(v, torch.Tensor):
        return (v.data_ptr(), tuple(v.shape), v.stride(), v.dtype, v.device)
    if isinstance(v, (tuple, list)):
        return tuple(_sig(x) for x in v)
    try:
        hash(v)
        return v
    except TypeError:
        return ("id", id(v))


def _input_sig(nt) -> tuple:
    return tuple(None if v is None else (tuple(v.shape), v.dtype)
                 for v in nt)


def key_of(static: tuple, trees: tuple, carry, inputs: tuple,
           device) -> tuple:
    """The key of a step's graph: ``static`` (the step's static arguments,
    hashable), the address and layout of every tensor in ``trees`` (the
    parameters and tables the step reads), the carry's state template and
    buffers, the shapes and dtypes of ``inputs`` (the step's
    ``StepForcing`` and ``StepPhenology``) and the device."""
    return (static, _sig(trees), tuple(template_of(carry.state)),
            tuple(b.data_ptr() for b in carry.buffers),
            tuple(_input_sig(x) for x in inputs), torch.device(device))


class CaptureError(RuntimeError):
    """The step could not be captured in a CUDA graph."""


class _OpTrace(TorchFunctionMode):
    """Names the first torch operation that raised inside it."""

    def __init__(self):
        super().__init__()
        self.failed = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        try:
            return func(*args, **(kwargs or {}))
        except BaseException:
            if self.failed is None:
                self.failed = (getattr(func, "__qualname__", None)
                               or getattr(func, "__name__", None)
                               or repr(func))
            raise


_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _where(exc: BaseException) -> str:
    """The port's innermost frame in ``exc``'s traceback, outside this
    module, as ``path:line (function)``."""
    here = os.path.abspath(__file__)
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if os.path.abspath(f.filename).startswith(_PACKAGE)
              and os.path.abspath(f.filename) != here]
    if not frames:
        return "outside the step"
    f = frames[-1]
    path = os.path.relpath(f.filename, os.path.dirname(_PACKAGE))
    return f"{path}:{f.lineno} ({f.name})"


class CudaGraph:
    """The card's graph: :meth:`capture` records ``body()`` on a side
    stream (nothing runs), :meth:`replay` launches the record on the
    current stream.  ``writes`` (the tensors the body writes in place) is
    for stand-ins, which run the body."""

    _streams: dict = {}

    def __init__(self, device):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, body, writes=()):
        stream = self._streams.get(self.device)
        if stream is None:
            stream = self._streams[self.device] = torch.cuda.Stream(
                self.device)
        # thread_local: the window thread may pin memory meanwhile
        with torch.cuda.device(self.device), torch.cuda.graph(
                self.graph, stream=stream,
                capture_error_mode="thread_local"):
            return body()

    def replay(self) -> None:
        self.graph.replay()

    def pool_bytes(self) -> int | None:
        """Bytes of the device segments in the graph's private memory
        pool, from the allocator's snapshot; None where the snapshot does
        not tag segments with their pool."""
        pool = tuple(self.graph.pool())
        segs = torch.cuda.memory_snapshot()
        if not segs or "segment_pool_id" not in segs[0]:
            return None
        return sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == pool)


def _counters(extra=()) -> list:
    """(object getter, attribute) of every counter a replay advances: the
    counted kernels' ``launches``, then ``extra``."""
    return ([((lambda m=m, a=a: getattr(m, a)), "launches")
             for m, a in COUNTED]
            + [((lambda o=o: o), attr) for o, attr in extra])


def _read(counters) -> list:
    return [getattr(get(), attr) for get, attr in counters]


def _write(counters, values) -> None:
    for (get, attr), v in zip(counters, values):
        if getattr(get(), attr) != v:
            setattr(get(), attr, v)


class StepGraphs:
    """A model's compiled step: the static input buffers and the graph of
    the current key, with what its captures cost.

    :meth:`step` runs one step of ``body(forcing, phenology)``, whose
    arguments are the static buffers: eagerly for the first step under a
    key, captured and replayed for the next, replayed after that."""

    def __init__(self):
        self.key = None
        self.static = None
        self.graph = None
        self.outputs = None
        self.warm = False
        self.deltas = None
        self.sched = None
        # one entry a capture: seconds (capture and instantiation, ended by
        # a synchronize) and the private pool's bytes
        self.captures = []
        self.replays = 0

    def drop(self) -> None:
        """Forget the graph and the buffers (their memory is freed)."""
        self.key = self.static = self.graph = self.outputs = None
        self.deltas = self.sched = None
        self.warm = False

    def step(self, key, body, inputs: tuple, device, writes=(),
             counters=()) -> tuple:
        """``(outputs, replayed)`` of this step.  ``inputs`` are the step's
        input NamedTuples, on the device or (pinned) on the host; they are
        copied into the static buffers.  ``writes`` are the tensors the
        body writes in place (the carry's buffers), ``counters`` the
        ``(object, attribute)`` counts that its Python side advances once
        a step (besides the kernels' launches), which a replay advances
        by what the capture recorded."""
        if key != self.key:
            self.drop()
            self.key = key
            self.static = tuple(type(nt)(*(
                None if v is None else torch.empty(v.shape, dtype=v.dtype,
                                                   device=device)
                for v in nt)) for nt in inputs)
        for buf, src in zip(self.static, inputs):
            for b, v in zip(buf, src):
                if v is not None:
                    b.copy_(v, non_blocking=True)
        if self.graph is None:
            if not self.warm:
                self.warm = True
                return body(*self.static), False
            self._capture(body, device, writes, _counters(counters))
        self._replay(_counters(counters))
        return self.outputs, True

    def _capture(self, body, device, writes, counters) -> None:
        before = _read(counters)
        sched = canopy._last_sched
        graph = (GRAPH or CudaGraph)(device)
        trace = _OpTrace()

        def traced():
            with trace:
                return body(*self.static)

        cuda = torch.device(device).type == "cuda"
        t0 = time.perf_counter()
        try:
            out = graph.capture(traced, writes)
        except Exception as exc:
            _write(counters, before)
            canopy._last_sched = sched
            if isinstance(exc, torch.cuda.OutOfMemoryError):
                raise       # the graph's pool does not fit: not a fault
            raise CaptureError(
                f"capturing the step in a CUDA graph failed at "
                f"{trace.failed or 'no torch operation'} in {_where(exc)}: "
                f"{type(exc).__name__}: {exc}  (the eager step on a card "
                f"runs only under elmkernels_torch.driver.graphs."
                f"disable_graphs())") from exc
        if cuda:
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        after = _read(counters)
        self.deltas = [a - b for a, b in zip(after, before)]
        _write(counters, before)
        self.sched = (canopy._last_sched
                      if canopy._last_sched is not sched else None)
        canopy._last_sched = sched
        self.graph, self.outputs = graph, out
        pool = getattr(graph, "pool_bytes", None)
        self.captures.append(dict(seconds=seconds,
                                  pool_bytes=pool() if pool else None))

    def _replay(self, counters) -> None:
        # a stand-in's replay runs the body's Python again: the counts are
        # set from what they were before it, not added to what it left
        before = _read(counters)
        self.graph.replay()
        _write(counters, [b + d for b, d in zip(before, self.deltas)])
        if self.sched is not None:
            canopy._last_sched = self.sched
        self.replays += 1
