"""The program's own counters over the traced window.

The port counts some of its work on the host as it launches it
(``fast_rnnt_tpu_torch.utils.profiling.counters()``, a dict by metric
name).  A reader calls :func:`watch` when it loads, before the window: from
then on every ``torch.profiler`` run snapshots the counters as it starts and
as it ends.  The first run to end is the harness's device-only window,
whose steps ``ctx["steps"]`` counts, so :func:`per_step` divides its
difference by them.  A program without the counters gives None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# (counters at its start, at its end) of each profiled run since watch()
_RUNS: List[Tuple[Dict[str, int], Dict[str, int]]] = []


def snapshot() -> Dict[str, int]:
    """The program's counters now; {} where it has none."""
    try:
        from fast_rnnt_tpu_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "counters", None)
    return dict(read()) if read is not None else {}


def watch() -> None:
    """Forget the runs seen so far, and snapshot the counters around each
    ``torch.profiler`` run from now on (the wrapping is made once)."""
    from torch.profiler import profile

    _RUNS.clear()
    enter_, exit_ = profile.__enter__, profile.__exit__
    if getattr(enter_, "snapshots_counters", False):
        return

    def __enter__(self):
        self._counters_at_start = snapshot()
        return enter_(self)

    def __exit__(self, *exc):
        out = exit_(self, *exc)
        start = getattr(self, "_counters_at_start", None)
        if start is not None:
            _RUNS.append((start, snapshot()))
        return out

    __enter__.snapshots_counters = True
    # perfbench/spans.py wraps __exit__ once, by this mark
    __exit__.keeps_the_run = getattr(exit_, "keeps_the_run", False)
    profile.__enter__, profile.__exit__ = __enter__, __exit__


def per_step(ctx: dict, name: str) -> Optional[float]:
    """Counter ``name`` over the first profiled run since :func:`watch`, a
    step of it; None where there is no such run or counter."""
    if not _RUNS or not ctx.get("steps"):
        return None
    start, end = _RUNS[0]
    if name not in start or name not in end:
        return None
    return (end[name] - start[name]) / ctx["steps"]
