from .convert import from_numpy, params_from_flax
from .validation import check_rnnt_inputs, checkify_rnnt_inputs

__all__ = ["check_rnnt_inputs", "checkify_rnnt_inputs", "from_numpy", "params_from_flax"]
