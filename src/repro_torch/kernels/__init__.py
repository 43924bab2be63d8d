"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``), the module that
compiles them, and their plain PyTorch versions."""
