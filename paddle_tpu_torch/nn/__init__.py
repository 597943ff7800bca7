from . import functional, quant

__all__ = ["functional", "quant"]
