from .attention import flash_attn_unpadded, scaled_dot_product_attention

__all__ = ["flash_attn_unpadded", "scaled_dot_product_attention"]
