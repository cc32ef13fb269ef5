"""Device seconds by span name over the harness's profiled cycle, for the
readers of the model's parts (``frt.model.*``, models/transducer.py and
models/training.py).

:mod:`perfbench.spans` groups a cycle's device time by the benchmark's loss
layers, and its :func:`~perfbench.spans.cycle` takes the one profiled run it
keeps.  This module keeps its own: :func:`watch` wraps
``torch.profiler.profile.__exit__`` once more to hold the last profiled run
with CPU activity, and :func:`by_span` attributes it once into
``ctx["model_spans"]``: every device event goes, as in ``spans``, to its
launch's host operation and that to its innermost ``frt.*`` span (a
backward node's to its forward operation's), here by the span's own name.
"""

from __future__ import annotations

import sys
from typing import Optional

from . import roofline, spans

# the last profiled run with CPU activity that ended since watch(), or none
_ENDED: list = []


def watch() -> None:
    """Keep the last ``torch.profiler`` run with CPU activity as it ends;
    a second call does nothing."""
    from torch.profiler import ProfilerActivity, profile

    exit_ = profile.__exit__
    if getattr(exit_, "keeps_the_model_run", False):
        return

    def __exit__(self, *exc):
        out = exit_(self, *exc)
        if ProfilerActivity.CPU in getattr(self, "activities", ()):
            _ENDED[:] = [self]
        return out

    __exit__.keeps_the_model_run = True
    # perfbench/spans.py wraps __exit__ once, by this mark
    __exit__.keeps_the_run = getattr(exit_, "keeps_the_run", False)
    profile.__exit__ = __exit__


def attribute(events, steps: int) -> dict:
    """Device seconds of a cycle by innermost span name (None: under no
    span), the span names seen on the host, and the cycle's steps."""
    named = spans.Spans(events)
    device = {}
    for d, op in named.launches():
        name = named.span(op) if op is not None else None
        device[name] = device.get(name, 0.0) + d.time_range.elapsed_us() * 1e-6
    seen = sorted({e.name for e in named.host if e.name.startswith(spans.PREFIX)})
    return {"device_s": device, "seen": seen, "steps": steps}


def by_span(ctx: dict) -> Optional[dict]:
    """:func:`attribute` of the run's last profiled cycle with CPU activity,
    made once and kept in ``ctx["model_spans"]``; None where no such cycle
    ended since :func:`watch`."""
    if "model_spans" not in ctx:
        prof = _ENDED.pop() if _ENDED else None
        a = None
        if prof is not None and ctx.get("cycles"):
            a = attribute(prof.events(), ctx["steps"] // ctx["cycles"])
            per = 1e3 / a["steps"]
            print("model spans: device ms a step "
                  + " ".join(f"{k} {v * per!r}" for k, v in sorted(
                      a["device_s"].items(), key=lambda r: str(r[0])) if str(k).startswith("frt.model")),
                  file=sys.stderr)
        ctx["model_spans"] = a
    return ctx["model_spans"]


def span_ms(ctx: dict, name: str):
    """Device milliseconds a step under span ``name``, forward and backward;
    None where the run holds no such span (a program without it)."""
    a = by_span(ctx)
    if not a or name not in a["seen"]:
        return None
    return 1e3 * a["device_s"].get(name, 0.0) / a["steps"]


def roofline_share(ctx: dict, part: str, name: str):
    """Percent of the device time under span ``name`` that the part's
    needed work (``ctx["work"][part]``, a cycle's) bounds from below; None
    where the span or the work is missing."""
    a = by_span(ctx)
    if not a or name not in a["seen"] or part not in ctx.get("work", {}):
        return None
    seconds = a["device_s"].get(name, 0.0)
    if seconds <= 0.0:
        return None
    ops, nbytes, peak = ctx["work"][part]
    return 100.0 * roofline.least_seconds(ops, nbytes, peak) / seconds
