"""Hand-written CUDA kernels (sources in ``fast_rnnt_tpu_torch/csrc``), each
beside its plain PyTorch version.  A CPU tensor runs the plain version; a
CUDA tensor launches the kernel or raises."""
