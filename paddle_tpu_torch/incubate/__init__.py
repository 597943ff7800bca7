"""``paddle.incubate`` — the fused-op surface; so far the fused MLP-block
functions of ``nn.functional``."""
from . import nn

__all__ = ["nn"]
