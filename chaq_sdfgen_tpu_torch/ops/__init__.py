"""Compute ops: threshold, banded exact EDT (plain PyTorch), merge/remap,
and the CUDA kernels of the hard path with their build."""
