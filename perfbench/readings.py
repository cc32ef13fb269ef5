"""Shared arithmetic of the metric readers in ``perfbench/metrics/``."""

from __future__ import annotations

from . import roofline
from .harness import kernel_is, port_kernels

# the port's CUDA sources of each layer, by file name
LAYER_SOURCES = {"recursion": "wavefront*.cu*", "build": "latbuild*.cu*", "ranges": "ranges.cu*"}


def kernel_seconds(ctx: dict, pattern: str, own: bool = True) -> float:
    """Device seconds of the traced kernels defined in the port's sources
    matching ``pattern`` (with ``own=False``: of every other kernel)."""
    names = port_kernels(ctx["root"], pattern)
    by_name = {}
    for k, s in ctx["kernels"]:
        by_name[k] = by_name.get(k, 0.0) + s
    return sum(s for k, s in by_name.items() if kernel_is(k, names) == own)


def roofline_share(ctx: dict, layer: str):
    """Percent of the layer's kernel time that its needed work bounds from
    below; None where no kernel of the layer ran."""
    if not ctx.get("kernels"):
        return None
    seconds = kernel_seconds(ctx, LAYER_SOURCES[layer])
    if seconds <= 0.0:
        return None
    ops, nbytes, peak = ctx["work"][layer]
    return 100.0 * ctx["cycles"] * roofline.least_seconds(ops, nbytes, peak) / seconds


def step_share(ctx: dict, part: str):
    """Percent of the traced window that the step's needed work bounds
    from below (an mfu)."""
    if part not in ctx["work"] or not ctx.get("window_s"):
        return None
    ops, nbytes, peak = ctx["work"][part]
    return 100.0 * ctx["cycles"] * roofline.least_seconds(ops, nbytes, peak) / ctx["window_s"]


def idle_share(ctx: dict):
    if "busy_s" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def launches(ctx: dict):
    if "kernels" not in ctx:
        return None
    return len(ctx["kernels"]) / ctx["steps"]
