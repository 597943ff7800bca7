"""Kernels of the port: each ``*.py`` here wraps one hand-written CUDA
kernel (``csrc/*.cu``) and holds its plain PyTorch version beside it."""


def twin_routes() -> int:
    """Calls routed to a plain twin on the card (activations of a dtype no
    kernel is built for, fp64 say: ``_build.kernel_takes``), summed over
    every wrapper's ``.twin_routes``."""
    from . import (fused_mlp, grouped_matmul, mega_decode, paged_attention,
                   quant_matmul)

    return sum(f.twin_routes for f in (
        paged_attention.ragged_paged_attention,
        paged_attention.paged_attention, fused_mlp.ln_fwd, fused_mlp.ln_bwd,
        fused_mlp.gelu_fwd, fused_mlp.gelu_bwd,
        quant_matmul.quant_matmul_fwd, quant_matmul.quant_matmul_bwd,
        grouped_matmul.grouped_matmul_fwd, grouped_matmul.grouped_matmul_bwd,
        mega_decode.mega_attn_layer, mega_decode.mega_mlp))
