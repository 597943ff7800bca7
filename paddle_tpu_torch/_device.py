"""Device resolution: the port runs on the first CUDA card by default.

``device=None`` means ``cuda:0`` and raises when no card is present — a
caller who wants the plain PyTorch versions on the CPU says so with
``device="cpu"``. There is no silent fallback in either direction.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` for ``None``, else
    ``torch.device(device)``. A CUDA device that is not there raises."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device unless told "
                "otherwise, and torch.cuda.is_available() is False; pass "
                "device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
