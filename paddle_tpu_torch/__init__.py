"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package beside it stays the reference. This package mirrors its
module paths and names (``models/gpt.py``, ``inference/serving.py``,
``ops/paged_attention.py`` ...) so every port module has an obvious
counterpart, and it imports neither ``jax`` nor anything of ``paddle_tpu``.

Every TPU kernel on a ported path becomes a kernel written by hand for
Hopper (``csrc/*.cu``, built with ``nvcc`` on first use — see
``ops/_build.py``); beside each sits a plain PyTorch version that runs for
CPU tensors only. Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``; nothing falls back to the CPU on its own.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
