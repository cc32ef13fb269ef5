"""PyTorch / CUDA port of fast_rnnt_tpu: the pruned RNN-T loss on NVIDIA
Hopper GPUs, forward and gradient, with hand-written CUDA kernels for the
lattice build (simple and smoothed, with their backward), the recursion
(split and fused, float32 / bfloat16 / float16 storage) and the pruning
windows, plain PyTorch versions of each for CPU tensors, the real-joiner
recipe (``do_rnnt_pruning``, ``rnnt_loss_pruned``, ``rnnt_loss``) and
Viterbi forced alignment.  The conformer transducer that trains with the
loss, and its decoders, are in ``fast_rnnt_tpu_torch.models``; the on-card
parity gate and the timing helpers in ``fast_rnnt_tpu_torch.utils``."""

from .ops.alignment import viterbi_alignment, viterbi_scores
from .ops.lattice import (
    fix_for_boundary,
    get_rnnt_logprobs,
    get_rnnt_logprobs_joint,
    get_rnnt_logprobs_pruned,
    get_rnnt_logprobs_pruned_simple,
    get_rnnt_logprobs_rows,
    get_rnnt_logprobs_smoothed,
    get_rnnt_logprobs_smoothed_rows,
    matmul_precision,
    roll_by_shifts,
    set_lattice_build_impl,
    set_matmul_precision,
)
from .ops.losses import (
    rnnt_loss,
    rnnt_loss_chunked,
    rnnt_loss_pruned,
    rnnt_loss_pruned_simple,
    rnnt_loss_simple,
    rnnt_loss_simple_pruned,
    rnnt_loss_smoothed,
    rnnt_loss_smoothed_pruned,
)
from .ops.pruning import (
    adjust_pruning_lower_bound,
    do_rnnt_pruning,
    get_rnnt_prune_ranges,
    get_rnnt_prune_ranges_rows,
)
from .ops.recursion import (
    cummin,
    monotonic_lower_bound,
    mutual_information_recursion,
    mutual_information_rows,
    register_impl,
    set_default_impl,
)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    # recursion core
    "mutual_information_recursion",
    "mutual_information_rows",
    "cummin",
    "monotonic_lower_bound",
    "register_impl",
    "set_default_impl",
    # lattice construction
    "fix_for_boundary",
    "get_rnnt_logprobs",
    "get_rnnt_logprobs_joint",
    "get_rnnt_logprobs_pruned",
    "get_rnnt_logprobs_pruned_simple",
    "get_rnnt_logprobs_rows",
    "get_rnnt_logprobs_smoothed",
    "get_rnnt_logprobs_smoothed_rows",
    "matmul_precision",
    "roll_by_shifts",
    "set_lattice_build_impl",
    "set_matmul_precision",
    # pruning pipeline
    "adjust_pruning_lower_bound",
    "do_rnnt_pruning",
    "get_rnnt_prune_ranges",
    "get_rnnt_prune_ranges_rows",
    # losses
    "rnnt_loss",
    "rnnt_loss_chunked",
    "rnnt_loss_pruned",
    "rnnt_loss_pruned_simple",
    "rnnt_loss_simple",
    "rnnt_loss_simple_pruned",
    "rnnt_loss_smoothed",
    "rnnt_loss_smoothed_pruned",
    # viterbi / forced alignment
    "viterbi_scores",
    "viterbi_alignment",
]
