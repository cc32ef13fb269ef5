"""Host-side data pipeline (the port's copy of ``fast_rnnt_tpu/data``):
log-mel features, streamed or offline, and ragged static-shape batches.
Batches stay numpy on the host; ``parallel.shard_batch`` moves each
rank's slice to its device."""

from ..csrc import fbank_cpu
from .features import StreamingFbank
from .loader import BatchPlan, RaggedBatcher, collate_batch, prefetch

__all__ = [
    "BatchPlan",
    "RaggedBatcher",
    "StreamingFbank",
    "collate_batch",
    "fbank_cpu",
    "prefetch",
]
