"""Batch data parallelism over ``torch.distributed`` ranks."""

from .sharding import (
    DATA_AXIS,
    batch_sharding,
    data_parallel,
    data_parallel_value_and_grad,
    initialize_distributed,
    make_mesh,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "batch_sharding",
    "data_parallel",
    "data_parallel_value_and_grad",
    "initialize_distributed",
    "make_mesh",
    "shard_batch",
]
