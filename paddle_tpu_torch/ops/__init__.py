"""Kernels of the port: each ``*.py`` here wraps one hand-written CUDA
kernel (``csrc/*.cu``) and holds its plain PyTorch version beside it."""
