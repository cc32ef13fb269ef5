"""Tracing, profiling and timing helpers (PyTorch port of
``fast_rnnt_tpu/utils/profiling.py``): the JAX module's names and return
shapes, on ``torch.profiler``, CUDA events and the caching allocator.

PyTorch runs eagerly, so where the JAX module compiled a program (one
``fori_loop`` per timing, XLA's memory analysis, HLO text) this module
runs the step itself: the timings enqueue the steps back to back behind a
device-side wait, the memory figures come from one measured call, and the
collective census reads the profiler's events.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

__all__ = [
    "annotate",
    "trace_to",
    "device_memory_stats",
    "compiled_memory_mb",
    "benchmark_fn",
    "benchmark_on_device",
    "benchmark_carried_on_device",
    "collective_census",
    "counters",
]

_COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "all-to-all",
    "collective-permute",
    "reduce-scatter",
)
# the backends' own events (one per collective; the dispatcher's
# ``c10d::*_`` op around each one carries no shapes and is not counted)
_BACKENDS = ("gloo:", "nccl:")
_MB = 1.0 / (1024 * 1024)


def _collective_kind(name: str) -> Optional[str]:
    """The census key of a backend event name (``gloo:all_reduce``,
    ``nccl:_allgather_base``, ``nccl:send 0->1``), or None for another
    event or a collective that moves no data (barrier)."""
    if not name.startswith(_BACKENDS):
        return None
    op = name.split(":", 1)[1].split()[0].strip("_").replace("_", "")
    if "reducescatter" in op:
        return "reduce-scatter"
    if "allreduce" in op:
        return "all-reduce"
    if "allgather" in op:
        return "all-gather"
    if "alltoall" in op:
        return "all-to-all"
    if op in ("send", "recv"):
        return "collective-permute"
    if op == "broadcast":
        return "broadcast"
    return None


def collective_census(prof_or_events: Any, lattice_dims=()) -> Dict[str, Any]:
    """Count the collectives in a ``torch.profiler`` run and flag any that
    moves a lattice-sized tensor.

    ``prof_or_events`` is a finished ``torch.profiler.profile`` or its
    ``events()``.  Each backend event (``gloo:*``, ``nccl:*``) counts once
    under the JAX census's keys (``all-reduce``, ``all-gather``,
    ``all-to-all``, ``collective-permute`` for send and recv,
    ``reduce-scatter``), plus ``broadcast``, which has no HLO key.
    ``lattice_dims`` are extents (e.g. T and T+1) that only lattice-shaped
    tensors have; a collective with an input shape that holds one is listed
    in ``census["lattice_moves"]``.  The shapes need the profiler's
    ``record_shapes=True``: a collective event without them raises
    ValueError."""
    events = prof_or_events.events() if hasattr(prof_or_events, "events") else prof_or_events
    census: Dict[str, Any] = {k: 0 for k in _COLLECTIVE_KINDS + ("broadcast",)}
    census["lattice_moves"] = []
    dims = {int(d) for d in lattice_dims}
    for e in events:
        kind = _collective_kind(e.name)
        if kind is None:
            continue
        # a 0-d tensor's shape is [] (a scalar all-reduce, as DTensor reduces
        # a loss): an event without shapes has none at all
        shapes = [list(s) for s in (e.input_shapes or [])]
        if not shapes:
            raise ValueError(f"collective_census: {e.name} has no input shapes; profile with "
                             "record_shapes=True")
        census[kind] += 1
        if any(dims & set(s) for s in shapes):
            census["lattice_moves"].append(f"{e.name} {shapes}"[:160])
    return census


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span in the ``torch.profiler`` timeline: a user-scope
    ``RecordFunction``, through torch's fast handle (about a tenth of
    ``torch.profiler.record_function``'s host time under a profiler).
    Under ``torch.autograd.profiler.emit_nvtx()`` the same record is an
    NVTX range as well, so the span pushes none of its own.  With no
    profiler running it costs one flag test and records nothing."""
    if not torch._C._autograd._profiler_enabled():
        yield
        return
    with torch._C._profiler._RecordFunctionFast(name):
        yield


def counters() -> Dict[str, int]:
    """The port's counts of its own work, taken on the host as it launches
    kernels, since the process started: ``recursion.strip_blocks``, the
    blocks of the diagonal-sweep launches (``ops/kernels/wavefront.py``
    ``BLOCKS``; B x strips a launch, where an utterance's strips run at
    once); ``pruned_lattice.kernel_frames``, the B x T frames of each
    pruned lattice the kernels built (``ops/kernels/pruned.py``
    ``FRAMES``); ``model.attention.kernel_rows``, the B x H x T query rows
    of each relative-position attention forward the kernels computed
    (``ops/kernels/relpos_attention.py`` ``ROWS``).  Read it before and
    after a window for the window's count."""
    from ..ops.kernels import pruned, relpos_attention, wavefront

    return {"recursion.strip_blocks": wavefront.BLOCKS["sweep"],
            "pruned_lattice.kernel_frames": pruned.FRAMES,
            "model.attention.kernel_rows": relpos_attention.ROWS}


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (the CPU activity, and the CUDA activity where
    there is a card) and write a Chrome trace, ``<host>_<pid>.<time>.
    pt.trace.json``, into ``log_dir`` (view it in Perfetto or TensorBoard).
    Yields the profiler; its ``events()`` are there after the block."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def device_memory_stats(device=None) -> Dict[str, float]:
    """Device memory in MB: ``mb_in_use`` and ``peak_mb_in_use`` (the
    caching allocator's tensors, ``torch.cuda.memory_stats``) and
    ``mb_limit`` (the card's memory, ``torch.cuda.mem_get_info``).  The
    current CUDA device by default; ``{}`` without one or for a CPU
    device, as the JAX module returns on backends without stats."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.cuda.current_device()
    device = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    if device.type != "cuda":
        return {}
    raw = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "mb_in_use": raw.get("allocated_bytes.all.current", 0) * _MB,
        "peak_mb_in_use": raw.get("allocated_bytes.all.peak", 0) * _MB,
        "mb_limit": total * _MB,
    }


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves of a tree of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _cuda_device(tree: Any) -> Optional[torch.device]:
    """The device of the first CUDA tensor of ``tree``, or None."""
    return next((t.device for t in _tensors(tree) if t.is_cuda), None)


def benchmark_fn(
    fn: Callable[..., Any],
    *args: Any,
    iters: int = 20,
    warmup: int = 3,
) -> float:
    """Host seconds per call of ``fn(*args)``: ``iters`` calls back to back
    after ``warmup``, with one synchronise at the end (per-call synchronises
    would add a host round trip to every call)."""
    dev = _cuda_device(args)

    def sync(out):
        d = _cuda_device(out) or dev
        if d is not None:
            torch.cuda.synchronize(d)

    out = None
    for _ in range(warmup):
        out = fn(*args)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / iters


def compiled_memory_mb(fn: Callable[..., Any], *args: Any) -> Dict[str, float]:
    """The JAX module's memory figures, measured by one run of ``fn(*args)``
    (eager PyTorch compiles nothing to analyse).  ``argument_mb`` and
    ``output_mb`` are the bytes of the argument and output tensors.  On a
    CUDA device ``peak_mb`` is ``argument_mb`` plus the largest amount the
    call allocated above what was allocated before it
    (``torch.cuda.max_memory_allocated``), and ``temp_mb = peak_mb -
    argument_mb - output_mb``.  Unlike XLA's analysis, which sums the
    program's buffer sizes into an upper bound, this is the allocator's
    peak in one run: it counts the caching allocator's rounding, and it
    does not count the arguments' memory twice when the caller keeps
    other tensors alive.  No ``code_mb``: nothing is compiled."""
    dev = _cuda_device(args)
    if dev is not None:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    res = {"argument_mb": _nbytes(args) * _MB, "output_mb": _nbytes(out) * _MB}
    if dev is not None:
        torch.cuda.synchronize(dev)
        res["peak_mb"] = res["argument_mb"] + (torch.cuda.max_memory_allocated(dev) - base) * _MB
        res["temp_mb"] = res["peak_mb"] - res["argument_mb"] - res["output_mb"]
    return res


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def _slope_estimate(trip: Callable[[int], Any], iters: int, trials: int, dev) -> float:
    """Seconds per step by the JAX module's estimator: runs of ``iters``
    and ``3 * iters`` steps, the median over ``trials`` of ``(t_3n - t_n)
    / 2n``, which cancels every per-run constant.

    On a CUDA device each run is timed by CUDA events behind a device-side
    wait (``torch.cuda._sleep``) sized from the host's measured enqueue
    time of a run, so that the card runs the steps back to back rather than
    at the host's pace; on the CPU by ``time.perf_counter``."""
    trip(3 * iters)  # warm up (allocator, kernel builds, clocks)
    if dev is None:
        def run(n):
            t0 = time.perf_counter()
            trip(n)
            return time.perf_counter() - t0
    else:
        torch.cuda.synchronize(dev)
        with torch.cuda.device(dev):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            cal = 50_000_000  # cycles; the card's wait per cycle, measured
            a.record()
            torch.cuda._sleep(cal)
            b.record()
            b.synchronize()
            s_per_cycle = a.elapsed_time(b) / 1e3 / cal
            t0 = time.perf_counter()
            trip(3 * iters)
            enqueue_s = (time.perf_counter() - t0) / (3 * iters)  # a step's host time
            torch.cuda.synchronize(dev)

            def run(n):
                # cover the host's enqueue of the run, with a margin
                torch.cuda._sleep(int((1.5 * enqueue_s * n + 1e-3) / s_per_cycle))
                a.record()
                trip(n)
                b.record()
                b.synchronize()
                return a.elapsed_time(b) / 1e3
    slopes = []
    for _ in range(trials):
        t_n = run(iters)
        t_3n = run(3 * iters)
        slopes.append(max(t_3n - t_n, 0.0) / (2 * iters))
    return _median(slopes)


def benchmark_on_device(
    step: Callable[..., Any],
    *args: Any,
    iters: int = 20,
    trials: int = 3,
    perturb: Optional[Callable[..., Any]] = None,
) -> float:
    """Device seconds per call of ``step(*args)`` (host seconds on CPU
    tensors), by the median-of-slopes estimator of
    :func:`_slope_estimate`.  ``perturb(i, *args)``, where given, returns
    the i-th step's arguments (the JAX module's hook for keeping a loop
    body loop-variant); by default every step takes ``args`` as they are,
    since eager calls are never hoisted.  A step that reads a device value
    on the host waits for the head start to end, and the figure is then
    the step's wall pace."""

    def trip(n):
        for i in range(n):
            step(*(perturb(i, *args) if perturb is not None else args))

    return _slope_estimate(trip, iters, trials, _cuda_device(args))


def benchmark_carried_on_device(
    step: Callable[..., Any],
    carry: Any,
    *args: Any,
    iters: int = 20,
    trials: int = 3,
) -> float:
    """:func:`benchmark_on_device` for stateful steps, ``step(carry, *args)
    -> new carry`` (a streaming chunk step): each run starts from ``carry``
    and chains every step's carry into the next.  A step that reads the
    host (the greedy decoder's stop test) waits for the device there, which
    ends the head start: the figure is then the step's wall pace, host
    time included."""

    def trip(n):
        c = carry
        for _ in range(n):
            c = step(c, *args)
        return c

    return _slope_estimate(trip, iters, trials, _cuda_device((carry, args)))
