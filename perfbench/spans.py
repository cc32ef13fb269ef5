"""Per-layer attribution of one profiled cycle by the port's spans.

Every call of a public op of the port is a span ``frt.<op>`` in the
profiler's timeline (``fast_rnnt_tpu_torch/ops/kernels/partition.py``).
Over the events of one ``torch.profiler`` run with CPU and CUDA activity:

  * a device kernel, memcpy or memset belongs to the host operation that
    launched it: the CUDA runtime call with the device event's correlation
    id (the event's ``id``), and the innermost operation around that call
    (a ctypes launch inside a public op: the span itself, or the autograd
    function around it);
  * a host operation in the forward belongs to the innermost ``frt.*``
    span above it;
  * a host operation inside ``autograd::engine::evaluate_function: X``
    belongs to the span of the forward operation that made the node X,
    the one with the same (thread, sequence number);
  * a span belongs to its layer by :data:`LAYERS`; a span in none of them
    is the loss entry's own work (``entry``), and work under no span at
    all is the caller's (``caller``).

So every device second of the cycle lands in exactly one layer.

The cycle is the one that ``harness.run`` profiles with CPU and CUDA
activity to name the idle gaps, after the device-only window.  The harness
keeps nothing of it but those names, so the span readers, which load before
the window and only in a traced run, call :func:`watch`: it keeps each
profiled run with CPU activity as it ends, and :func:`cycle` attributes the
last one once, into ``ctx["spans"]``.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Optional, Tuple

PREFIX = "frt."
BACKWARD = "autograd::engine::evaluate_function"

# the benchmark's layers, by the span of the public op that opens them
LAYERS = {
    "frt.get_rnnt_logprobs": "build",
    "frt.get_rnnt_logprobs_rows": "build",
    "frt.get_rnnt_logprobs_smoothed": "build",
    "frt.get_rnnt_logprobs_smoothed_rows": "build",
    "frt.mutual_information_recursion": "recursion",
    "frt.mutual_information_rows": "recursion",
    "frt.get_rnnt_prune_ranges": "ranges",
    "frt.get_rnnt_prune_ranges_rows": "ranges",
    "frt.do_rnnt_pruning": "pruning",
    "frt.get_rnnt_logprobs_pruned": "pruned_lattice",
}
ORDER = ("build", "recursion", "ranges", "pruning", "pruned_lattice", "entry", "caller")


def layer_of(span: Optional[str]) -> str:
    if span is None:
        return "caller"
    return LAYERS.get(span, "entry")


def _seconds(e) -> float:
    return e.time_range.elapsed_us() * 1e-6


def _is_device(e) -> bool:
    import torch

    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _is_host(e) -> bool:
    import torch

    return e.device_type == torch.autograd.DeviceType.CPU


def _runtime(e) -> bool:
    """A CUDA runtime API call (``cudaLaunchKernel``, ``cuLaunchKernel``)."""
    return e.name.startswith("cu")


class Spans:
    """The span of every host operation of one profiled run."""

    def __init__(self, events: Iterable):
        self.events = list(events)
        self.host = [e for e in self.events if _is_host(e)]
        self._memo: Dict[int, Optional[str]] = {}
        # the forward operation that made each autograd node: of the
        # operations that saw a sequence number, the last one made it
        self.forward = {}
        for e in sorted(self.host, key=lambda e: e.time_range.start):
            if e.sequence_nr >= 0 and not self._in_backward(e):
                self.forward[(e.thread, e.sequence_nr)] = e

    @staticmethod
    def _in_backward(e) -> bool:
        while e is not None:
            if e.name.startswith(BACKWARD):
                return True
            e = e.cpu_parent
        return False

    def span(self, e) -> Optional[str]:
        """The innermost ``frt.*`` span of host operation ``e``, through the
        forward operation where ``e`` runs in a backward node; None where
        it has none."""
        key = id(e)
        if key not in self._memo:
            found, node = None, e
            while node is not None:
                if node.name.startswith(PREFIX):
                    found = node.name
                    break
                if node.name.startswith(BACKWARD):
                    fwd = self.forward.get((node.fwd_thread, node.sequence_nr))
                    found = self.span(fwd) if fwd is not None else None
                    break
                node = node.cpu_parent
            self._memo[key] = found
        return self._memo[key]

    def launches(self) -> List[Tuple[object, object]]:
        """(device event, the host operation that launched it, or None)."""
        calls = {e.id: e for e in self.host if _runtime(e)}
        return [(d, calls[d.id].cpu_parent if d.id in calls else None)
                for d in self.events if _is_device(d)]

    def split(self, work) -> Tuple[Dict[str, float], float]:
        """Seconds of each layer over ``work``, pairs of (host operation or
        None, seconds), and the seconds whose operation is unknown (in
        ``caller`` too)."""
        out = dict.fromkeys(ORDER, 0.0)
        unknown = 0.0
        for op, s in work:
            if op is None:
                unknown += s
            out[layer_of(self.span(op) if op is not None else None)] += s
        return out, unknown

    def _outermost(self, e) -> bool:
        """Whether ``e`` is the program's on the host: an outermost span, or
        an outermost backward node outside any span that belongs to one."""
        if e.name.startswith(PREFIX):
            stop = (PREFIX,)
        elif e.name.startswith(BACKWARD) and self.span(e) is not None:
            stop = (PREFIX, BACKWARD)
        else:
            return False
        outer = e.cpu_parent
        while outer is not None and not outer.name.startswith(stop):
            outer = outer.cpu_parent
        return outer is None

    def host_seconds(self) -> Tuple[float, float]:
        """Host seconds in the program (the outermost spans and backward
        nodes of :meth:`_outermost`) less the CUDA runtime calls inside
        them, and those calls' seconds: a launch, and, where the device is
        behind, the wait for room in the launch queue."""
        roots = {id(e) for e in self.host if self._outermost(e)}
        total = sum(_seconds(e) for e in self.host if id(e) in roots)
        runtime = 0.0
        for e in self.host:
            if _runtime(e):
                p = e.cpu_parent
                while p is not None and id(p) not in roots:
                    p = p.cpu_parent
                if p is not None:
                    runtime += _seconds(e)
        return total - runtime, runtime


def attribute(events, steps: int) -> dict:
    """The cycle's attribution for the readers in ``perfbench/metrics/``:
    each layer's device seconds, the device seconds whose launch was not
    found, the cycle's device seconds, the program's host seconds and its
    CUDA runtime calls' seconds, the spans seen and the steps of the cycle."""
    spans = Spans(events)
    launches = spans.launches()
    device, unknown = spans.split((op, _seconds(d)) for d, op in launches)
    host, runtime = spans.host_seconds()
    return {
        "device_s": device,
        "unknown_s": unknown,
        "cycle_device_s": sum(_seconds(d) for d, _ in launches),
        "host_s": host,
        "runtime_s": runtime,
        "seen": sorted({e.name for e in spans.host if e.name.startswith(PREFIX)}),
        "steps": steps,
    }


# the last profiled run with CPU activity that ended since watch(), or none
_ENDED: list = []


def watch() -> None:
    """Keep the last ``torch.profiler`` run with CPU activity as it ends,
    for :func:`cycle`; a second call does nothing."""
    from torch.profiler import ProfilerActivity, profile

    exit_ = profile.__exit__
    if getattr(exit_, "keeps_the_run", False):
        return

    def __exit__(self, *exc):
        out = exit_(self, *exc)
        if ProfilerActivity.CPU in getattr(self, "activities", ()):
            _ENDED[:] = [self]
        return out

    __exit__.keeps_the_run = True
    profile.__exit__ = __exit__


def report(a: dict) -> str:
    per = 1e3 / a["steps"]
    return (f"spans {' '.join(a['seen'])}: device ms a step "
            + " ".join(f"{k} {v * per!r}" for k, v in a["device_s"].items())
            + f", of {a['cycle_device_s'] * per!r}; launch not found {a['unknown_s'] * per!r}; "
            f"host ms a step in the program {a['host_s'] * per!r}, in its CUDA runtime calls "
            f"{a['runtime_s'] * per!r}")


def cycle(ctx: dict) -> Optional[dict]:
    """The attribution of the run's last profiled cycle with CPU activity
    (:func:`attribute`, a cycle of ``steps / cycles`` steps), made once and
    kept in ``ctx["spans"]``, and printed on stderr; None where no such
    cycle ended since :func:`watch`."""
    if "spans" not in ctx:
        prof = _ENDED.pop() if _ENDED else None
        a = None
        if prof is not None and ctx.get("cycles"):
            a = attribute(prof.events(), ctx["steps"] // ctx["cycles"])
            print(report(a), file=sys.stderr)
        ctx["spans"] = a
    return ctx["spans"]


def layer_ms(ctx: dict, layer: str):
    """Device milliseconds a step of ``layer`` in the attributed cycle;
    None where the run holds no span of the port (a program without them)."""
    a = cycle(ctx)
    if not a or not a["seen"]:
        return None
    return 1e3 * a["device_s"][layer] / a["steps"]


def host_ms(ctx: dict):
    """Host milliseconds a step in the program (:meth:`Spans.host_seconds`),
    or None as :func:`layer_ms`."""
    a = cycle(ctx)
    if not a or not a["seen"]:
        return None
    return 1e3 * a["host_s"] / a["steps"]
