from .convert import from_numpy
from .validation import check_rnnt_inputs

__all__ = ["check_rnnt_inputs", "from_numpy"]
