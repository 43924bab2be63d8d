"""PyTorch/CUDA port of the DeepSpeed-MoE reproduction.

It mirrors the JAX package ``repro`` module by module (same parameter tree,
same layouts at public functions) and imports nothing of it: what it needs
from framework-free JAX-package modules (configs, the PR-MoE builders) is
copied under ``repro_torch.configs``.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
