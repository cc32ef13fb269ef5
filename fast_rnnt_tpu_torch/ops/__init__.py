from .lattice import (
    band_mask_rows_smajor,
    fix_for_boundary,
    get_rnnt_logprobs_rows,
    get_rnnt_logprobs_smoothed_rows,
)
from .losses import (
    rnnt_loss_pruned_simple,
    rnnt_loss_simple,
    rnnt_loss_simple_pruned,
    rnnt_loss_smoothed,
    rnnt_loss_smoothed_pruned,
)
from .pruning import (
    adjust_pruning_lower_bound,
    get_rnnt_prune_ranges,
    get_rnnt_prune_ranges_rows,
)
from .recursion import cummin, monotonic_lower_bound, mutual_information_rows

__all__ = [
    "adjust_pruning_lower_bound",
    "band_mask_rows_smajor",
    "cummin",
    "fix_for_boundary",
    "get_rnnt_logprobs_rows",
    "get_rnnt_logprobs_smoothed_rows",
    "get_rnnt_prune_ranges",
    "get_rnnt_prune_ranges_rows",
    "monotonic_lower_bound",
    "mutual_information_rows",
    "rnnt_loss_pruned_simple",
    "rnnt_loss_simple",
    "rnnt_loss_simple_pruned",
    "rnnt_loss_smoothed",
    "rnnt_loss_smoothed_pruned",
]
