"""Batch data parallelism on ``torch.distributed`` (the port of
``fast_rnnt_tpu/parallel/sharding.py``).

The RNN-T loss is per utterance: every lattice is independent along the
batch axis, so utterances are split over ranks, each rank computes its
shard's loss locally, and only the gradients and the scalar metrics cross
ranks, all-reduced with SUM (``psum``'s counterpart: the loss is a sum
over the batch, so the global gradient is the sum of the shards').

JAX runs one program over global arrays; here every rank is a process of
its own that holds only its slice.  So :func:`shard_batch` takes the
global (host) batch that every rank built the same way and returns this
rank's contiguous slice of axis 0 on its device, and the functions that
:func:`data_parallel` wraps see only that slice.

Without a process group (one process), :func:`make_mesh` returns a
:class:`LocalMesh` of one rank: it has ``DeviceMesh``'s ``size``,
``get_local_rank``, ``device_type`` and ``mesh_dim_names``,
its ``get_group()`` is ``None``, and every collective of this module
returns its inputs unchanged for it (a sum over one rank is the value).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "LocalMesh",
    "make_mesh",
    "batch_sharding",
    "shard_batch",
    "data_parallel",
    "data_parallel_value_and_grad",
    "initialize_distributed",
    "all_reduce_sum",
    "broadcast_from_first",
    "mesh_device",
]

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A one-rank mesh for a process without a process group."""

    device_type: str
    mesh_dim_names: Tuple[str, ...] = (DATA_AXIS,)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_local_rank(self, mesh_dim: Optional[Union[int, str]] = None) -> int:
        return 0

    def get_group(self, mesh_dim: Optional[Union[int, str]] = None) -> None:
        return None


def make_mesh(device: str = "cuda", axis_name: str = DATA_AXIS):
    """1-D data-parallel mesh over every rank of the default process group
    (a ``DeviceMesh`` named ``axis_name``), or a :class:`LocalMesh` when no
    group is initialised.  ``device``: ``"cuda"`` (each rank's current CUDA
    device; raises without one) or ``"cpu"``."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' to run on the CPU)")
    if not dist.is_initialized():
        return LocalMesh(device_type, (axis_name,))
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: its current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Axis 0 (the utterance axis) split in contiguous, equal slices over
    the ranks of ``mesh``'s ``axis_name``, in rank order."""

    mesh: Any
    axis_name: str = DATA_AXIS

    def local_slice(self, n: int) -> slice:
        """This rank's rows of an axis of length ``n``."""
        shards = self.mesh.size(0)
        if n % shards:
            raise ValueError(
                f"batch axis of size {n} does not divide over the {shards} "
                f"ranks of mesh axis {self.axis_name!r}"
            )
        k, i = n // shards, self.mesh.get_local_rank(0)
        return slice(i * k, (i + 1) * k)


def batch_sharding(mesh, axis_name: str = DATA_AXIS) -> BatchSharding:
    """Sharding that splits axis 0 (the utterance/batch axis) over the mesh."""
    if tuple(mesh.mesh_dim_names or ()) != (axis_name,):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} are not ({axis_name!r},)")
    return BatchSharding(mesh, axis_name)


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    _tree_map(out.append, tree)
    return out


def _unflatten(tree: Any, leaves: Sequence[Any]) -> Any:
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def shard_batch(tree: Any, mesh, axis_name: str = DATA_AXIS) -> Any:
    """Every array of ``tree`` (numpy arrays or tensors, the same global
    batch on every rank) as this rank's contiguous slice of axis 0, copied
    to its device.  0-d leaves are replicated.  An axis 0 that does not
    divide by the number of ranks raises."""
    sharding = batch_sharding(mesh, axis_name)
    dev = mesh_device(mesh)

    def put(x):
        x = torch.as_tensor(x)
        if x.ndim:
            x = x[sharding.local_slice(x.shape[0])]
        return x.to(dev, copy=True)

    return _tree_map(put, tree)


def _flat_collective(tensors: List[torch.Tensor], collective) -> List[torch.Tensor]:
    """Run ``collective`` in place on one flat copy of ``tensors`` per dtype
    and device; returns views of the results, in ``tensors``' order."""
    buckets: dict = {}
    for i, t in enumerate(tensors):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in buckets.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        collective(flat)
        o = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[o : o + n].view_as(tensors[i])
            o += n
    return out


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The element-wise SUM of ``tensors`` over the ranks of ``mesh``, in
    one flat buffer per dtype and device (one collective each).  Returns
    new tensors; the inputs are untouched.  On a :class:`LocalMesh`
    returns the inputs."""
    group = mesh.get_group()
    if group is None:
        return list(tensors)
    return _flat_collective(
        list(tensors), lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group))


def broadcast_from_first(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Overwrite ``tensors`` in place with the mesh's first rank's values
    (``P()`` replication's counterpart).  A no-op on a :class:`LocalMesh`."""
    group = mesh.get_group()
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    tensors = list(tensors)
    got = _flat_collective(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))
    with torch.no_grad():
        for t, v in zip(tensors, got):
            t.copy_(v)


def data_parallel(
    fn: Callable[..., Any],
    mesh,
    axis_name: str = DATA_AXIS,
    reduce_outputs: bool = False,
) -> Callable[..., Any]:
    """Wrap a batched function so that it runs shard-locally over the mesh.

    Every positional argument is this rank's shard (:func:`shard_batch`).
    With ``reduce_outputs=False`` the outputs are this rank's shard of the
    result; with ``True`` every tensor of the output tree is SUM-reduced
    over the ranks (for losses that are sums over the batch).
    """
    batch_sharding(mesh, axis_name)  # the mesh must have the data axis

    def run(*args):
        out = fn(*args)
        if not reduce_outputs:
            return out
        return _unflatten(out, all_reduce_sum(_leaves(out), mesh))

    return run


def data_parallel_value_and_grad(
    loss_fn: Callable[..., torch.Tensor],
    mesh,
    axis_name: str = DATA_AXIS,
) -> Callable[..., Any]:
    """Data-parallel ``value_and_grad`` for a training step.

    ``loss_fn(params, *batch)`` must return a scalar that is a SUM over its
    (local) batch shard; ``params`` is a tree of tensors, the same on every
    rank, and ``batch`` this rank's shard.  ``step(params, *batch)``
    returns ``(loss, grads)``, both SUM-reduced over the mesh (one
    collective), ``grads`` with the tree structure of ``params``.
    """
    batch_sharding(mesh, axis_name)

    def step(params, *batch):
        leaves = [p.detach().requires_grad_() for p in _leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_unflatten(params, leaves), *batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        loss, *grads = all_reduce_sum([loss.detach(), *grads], mesh)
        return loss, _unflatten(params, grads)

    return step


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
    backend: Optional[str] = None,
) -> None:
    """Join the process group (``init_process_group``); a no-op when
    single-process or already initialised.  Call once per process before
    :func:`make_mesh`.

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``
    or ``file:///path``; a bare ``host:port`` means TCP), or ``None`` for
    ``env://``.  The backend is NCCL for ``device="cuda"`` and gloo for
    ``"cpu"`` unless ``backend`` names one (gloo also all-reduces CUDA
    tensors, which several ranks on one card need: NCCL takes one rank per
    device).  Every failure but a racing earlier initialisation propagates,
    so no rank falls back to training alone.
    """
    if coordinator_address is None and num_processes in (None, 1):
        return
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    try:
        dist.init_process_group(
            backend,
            init_method=init_method,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id,
        )
    except (RuntimeError, ValueError):
        if dist.is_initialized():
            return
        raise
