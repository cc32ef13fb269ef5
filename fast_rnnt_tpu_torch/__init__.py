"""PyTorch / CUDA port of fast_rnnt_tpu: the pruned RNN-T loss on NVIDIA
Hopper GPUs, forward and gradient, with hand-written CUDA kernels for the
lattice build (simple and smoothed, with their backward), the recursion
and the pruning windows, and plain PyTorch versions of each for CPU
tensors."""

from .ops.lattice import get_rnnt_logprobs_rows, get_rnnt_logprobs_smoothed_rows
from .ops.losses import (
    rnnt_loss_pruned_simple,
    rnnt_loss_simple,
    rnnt_loss_simple_pruned,
    rnnt_loss_smoothed,
    rnnt_loss_smoothed_pruned,
)
from .ops.pruning import get_rnnt_prune_ranges_rows
from .ops.recursion import mutual_information_rows

__all__ = [
    "get_rnnt_logprobs_rows",
    "get_rnnt_logprobs_smoothed_rows",
    "get_rnnt_prune_ranges_rows",
    "mutual_information_rows",
    "rnnt_loss_pruned_simple",
    "rnnt_loss_simple",
    "rnnt_loss_simple_pruned",
    "rnnt_loss_smoothed",
    "rnnt_loss_smoothed_pruned",
]
