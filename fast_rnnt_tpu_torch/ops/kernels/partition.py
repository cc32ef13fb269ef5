"""Batch partitioning over ``DTensor`` for the kernels, the entry points
that reach them, and the public glue ops that reach none (the port of
``fast_rnnt_tpu/ops/kernels/partition.py``): every public op of the port
that takes a batch takes batch-sharded ``DTensor`` s, as every public op of
the JAX package takes batch-sharded arrays.  The ops left unwrapped
(``cummin``, ``monotonic_lower_bound``, ``logaddexp``, ``safe_exp``) make
no tensor of their own, so DTensor's sharding rules carry them.

The lattice kernels are independent along the batch: every output row b
depends only on input rows b.  But a kernel launched through ``ctypes`` is
as opaque to ``torch.distributed.tensor`` as a ``pallas_call`` is to XLA's
partitioner: a ``DTensor`` has no storage to hand it, and the plain glue
between the kernels mixes ``DTensor`` and local tensors.  So
:func:`batch_partitioned` wraps a function of tensors:

* No argument is a ``DTensor``: ``fn`` runs unchanged (one ``isinstance``
  scan on top).
* Otherwise it finds the mesh dims that the batch axis is sharded over
  (where operands disagree, the candidate of the largest extent, as the
  JAX wrapper's ``_find_batch`` does), redistributes every batch-carrying
  operand to ``Shard(axis)`` on those dims and ``Replicate`` elsewhere
  (an operand sharded on another axis, such as am on C, is resharded),
  every other operand to ``Replicate``, and runs ``fn`` on the local
  shards.  A plain tensor argument is taken as the global value on every
  rank.  The outputs come back as ``DTensor`` s: ``Shard(axis)`` for batch
  outputs, ``Partial("sum")`` for outputs marked ``"sum"`` (a cotangent
  summed over the batch).  Gradients return with each operand's own
  placement: a replicated operand's local gradient is a ``Partial("sum")``
  part of the whole.
* Inside a partitioned call every argument is local, so nested wrapped
  functions fall through: the wrappers compose, they do not stack.
* A batch that does not divide the batch dims' extent is replicated and
  ``fn`` runs whole on every rank, correct, not fast, as in JAX.  That is
  the one fallback: where the batch divides, nothing is gathered.

Cross-batch terms inside a partitioned call are taken across the mesh by
:func:`batch_mean` (the smoothed build's unigram: one all-reduce of a [C]
vector, and one of its gradient).

The losses apply their reduction on the ``Shard(0)`` loss (``losses.py``),
so that a mean divides by the global batch.

Every call of a wrapped public op is a span of the profiler's timeline,
``frt.<name>`` (:func:`~fast_rnnt_tpu_torch.utils.profiling.annotate`),
on the plain fall-through and on the DTensor path alike, where the
reshard and rewrap fall inside it; nested public calls nest their spans.
With no profiler running the span is one flag test.  The kernel wrappers
(``ops/kernels/*.py``) open none (``span=False``): a kernel launched inside
a public op belongs to that op's span, and the backward of a public op is
found through its autograd node's sequence number, not by a span.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import inspect
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ...utils.profiling import annotate

__all__ = ["batch_partitioned", "partitioned", "batch_mean", "has_dtensor", "current_shards", "within"]

if dist.is_available():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
else:  # a torch without distributed support has no DTensor to partition
    DTensor = None

# Test seam: when set, called as hook(name, per_shard_batch) on every
# partitioned call and on every wrapped function entered inside one (the
# kernels, forward and backward) -- never on the plain fall-through.
_TRACE_HOOK = None

# whether a profiler is running: the one test a span costs without one
_profiler_enabled = torch._C._autograd._profiler_enabled

# (mesh, batch mesh dims) of the partitioned call being run, or None
_SHARDS: contextvars.ContextVar = contextvars.ContextVar("shards", default=None)


def current_shards():
    """The (mesh, batch mesh dims) of the enclosing partitioned call, or
    None.  An autograd function keeps it for its backward (:func:`within`),
    which runs outside the call."""
    return _SHARDS.get()


@contextlib.contextmanager
def within(shards):
    """Run the block as part of the partitioned call ``shards``."""
    token = _SHARDS.set(shards)
    try:
        yield
    finally:
        _SHARDS.reset(token)


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce over ``groups`` in turn; its gradient is the same
    all-reduce of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        y = x.clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


def batch_mean(x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """``x.mean(dim=dims)``, where ``dims`` holds the batch axis 0: inside a
    partitioned call over more than one shard, the mean of the whole
    batch, its sum all-reduced across the batch shards (and its gradient
    likewise); else ``x.mean(dim=dims)`` itself, to the bit."""
    shards = _SHARDS.get()
    n = _extent(*shards) if shards else 1
    if n == 1:
        return x.mean(dim=dims)
    mesh, bdims = shards
    count = n
    for d in dims:
        count *= x.shape[d]
    total = _AllReduceSum.apply(x.sum(dim=dims), [mesh.get_group(d) for d in bdims])
    return total / count


def _is_dtensor(x) -> bool:
    return DTensor is not None and isinstance(x, DTensor)


def has_dtensor(args, kwargs) -> bool:
    """Whether a positional or keyword argument, or a member of a tuple
    argument, is a ``DTensor``."""
    for v in (*args, *kwargs.values()):
        if _is_dtensor(v) or (isinstance(v, (tuple, list)) and any(_is_dtensor(u) for u in v)):
            return True
    return False


def _extent(mesh, dims) -> int:
    n = 1
    for d in dims:
        n *= mesh.size(d)
    return n


def _pairs(value, spec):
    """(tensor, batch axis or None) of every tensor in ``value`` (a tensor,
    or a tuple / list of them) under its axis spec (an int, None, or a
    tuple of specs for a tuple argument)."""
    if isinstance(value, torch.Tensor):
        yield value, spec if isinstance(spec, int) else None
    elif isinstance(value, (tuple, list)):
        specs = spec if isinstance(spec, (tuple, list)) else (spec,) * len(value)
        for v, s in zip(value, specs):
            yield from _pairs(v, s)


def _map(value, spec, fn):
    """``value`` with every tensor t replaced by ``fn(t, axis)``."""
    if isinstance(value, torch.Tensor):
        return fn(value, spec)
    if isinstance(value, (tuple, list)):
        specs = spec if isinstance(spec, (tuple, list)) else (spec,) * len(value)
        return type(value)(_map(v, s, fn) for v, s in zip(value, specs))
    return value


def _out_spec(out, spec):
    """A single tensor output takes the first entry of a tuple spec (an op
    that returns ``scores`` or ``(scores, (gx, gy))``)."""
    if isinstance(out, torch.Tensor) and isinstance(spec, (tuple, list)):
        return spec[0]
    return spec


def _batch_dims(operands, mesh) -> Tuple[int, ...]:
    """Mesh dims the batch axis is sharded over: per batch-carrying
    DTensor operand, the dims holding ``Shard(axis)``; where they disagree,
    the candidate of the largest extent; () when none is sharded."""
    candidates = []
    for x, ax in operands:
        if ax is None or not _is_dtensor(x):
            continue
        dims = tuple(d for d, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim % x.ndim == ax % x.ndim)
        if dims and dims not in candidates:
            candidates.append(dims)
    if not candidates:
        return ()
    return max(candidates, key=lambda dims: _extent(mesh, dims))


def _local_batch(arguments, in_axes) -> Optional[int]:
    for name, spec in in_axes.items():
        for x, ax in _pairs(arguments.get(name), spec):
            if ax is not None:
                return x.shape[ax]
    return None


def batch_partitioned(
    fn: Callable,
    in_axes: Dict[str, Any],
    out_axes: Union[int, str, Sequence],
    name: Union[str, Callable[[Dict[str, Any]], str]] = "kernel",
    span: bool = True,
):
    """Wrap ``fn`` so that it takes batch-sharded ``DTensor`` s and runs per
    shard (see the module docstring).

    Args:
      fn: a function of tensors whose every output row b depends only on
        input rows b, but for outputs marked ``"sum"``.
      in_axes: parameter name -> the argument's batch axis, or None for an
        operand without one (replicated); a tuple argument takes a tuple of
        axes.  Tensor arguments not named are replicated.
      out_axes: per output, its batch axis, or ``"sum"`` for a sum over
        the batch; a structure of tuples as the outputs are nested, and
        one int for every tensor of the result.  ``None`` outputs pass.
      name: the hook's label; a function of the bound arguments where it
        depends on them.
      span: open the span ``frt.<name>`` around every call; False for a
        kernel wrapper.
    """
    sig = inspect.signature(fn)
    span_name = f"frt.{name}" if span else None

    def label(arguments):
        return name(arguments) if callable(name) else name

    def call(*args, **kwargs):
        if not has_dtensor(args, kwargs):
            if _TRACE_HOOK is not None and _SHARDS.get() is not None:
                arguments = sig.bind(*args, **kwargs).arguments
                _TRACE_HOOK(label(arguments), _local_batch(arguments, in_axes))
            return fn(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        operands = [p for n, v in bound.arguments.items() for p in _pairs(v, in_axes.get(n))]
        meshes = {x.device_mesh for x, _ in operands if _is_dtensor(x)}
        if len(meshes) != 1:
            raise ValueError(f"{fn.__name__}: DTensor arguments on {len(meshes)} meshes; one is needed")
        mesh = meshes.pop()
        dims = _batch_dims(operands, mesh)
        n = _extent(mesh, dims)
        if dims and any(ax is not None and x.shape[ax] % n for x, ax in operands):
            dims = ()  # the kernels assume equal shards: replicate
        rep = [Replicate()] * mesh.ndim

        def placed(batch):  # ``batch`` on the batch dims (none when replicating)
            return [batch if d in dims else Replicate() for d in range(mesh.ndim)]

        def localize(x, ax):
            target = placed(Shard(ax)) if ax is not None else rep
            # a replicated operand of a sharded call: each shard's gradient
            # is a part of the whole
            grads = placed(Shard(ax) if ax is not None else Partial())
            if not _is_dtensor(x):
                x = DTensor.from_local(x, mesh, rep, run_check=False)
            if tuple(x.placements) != tuple(target):
                x = x.redistribute(mesh, target)
            return x.to_local(grad_placements=grads)

        for key, value in bound.arguments.items():
            bound.arguments[key] = _map(value, in_axes.get(key), localize)
        shards = (mesh, dims) if dims else None
        with within(shards):
            if shards is not None and _TRACE_HOOK is not None:
                _TRACE_HOOK(label(bound.arguments), _local_batch(bound.arguments, in_axes))
            out = fn(*bound.args, **bound.kwargs)

        def wrap(t, ax):
            return DTensor.from_local(t, mesh, placed(Partial() if ax == "sum" else Shard(ax)),
                                      run_check=False)

        return _map(out, _out_spec(out, out_axes), wrap)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        # the flag here too: without a profiler a call skips even annotate
        if span_name is None or not _profiler_enabled():
            return call(*args, **kwargs)
        with annotate(span_name):
            return call(*args, **kwargs)

    return wrapper


def partitioned(in_axes: Dict[str, Any], out_axes, name=None, span: bool = True):
    """:func:`batch_partitioned` as a decorator; the hook's label defaults
    to the function's name."""
    return lambda fn: batch_partitioned(fn, in_axes, out_axes, name or fn.__name__, span)
