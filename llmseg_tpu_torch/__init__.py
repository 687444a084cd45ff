"""PyTorch/CUDA port of llmseg_tpu, beside the JAX package it is held against.

The port keeps the JAX package's public layouts (images (B, H, W, 3), q/k/v
(B, T, H, D), proposal masks (B, K, G, G)) and imports nothing of it.  Its
two attention kernels are CUDA C++ for Hopper under ``csrc/``.
"""
