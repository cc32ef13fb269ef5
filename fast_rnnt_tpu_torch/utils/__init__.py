from .convert import from_numpy, params_from_flax
from .profiling import (
    annotate,
    benchmark_fn,
    benchmark_on_device,
    collective_census,
    compiled_memory_mb,
    device_memory_stats,
    trace_to,
)
from .validation import check_rnnt_inputs, checkify_rnnt_inputs

__all__ = [
    "annotate",
    "benchmark_fn",
    "benchmark_on_device",
    "collective_census",
    "compiled_memory_mb",
    "device_memory_stats",
    "trace_to",
    "check_rnnt_inputs",
    "checkify_rnnt_inputs",
    "from_numpy",
    "params_from_flax",
]
