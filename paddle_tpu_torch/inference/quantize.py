"""PTQ serving conversion — port of ``paddle_tpu/inference/quantize.py``.

:func:`quantize_serving_params` turns the serving params of
``models.gpt.serving_params`` into their weight-only quantized form: each
per-layer matmul stack ``[L, K, N]`` (``wqkv``, ``wo``, ``w1``, ``w2`` —
what a decode step reads every token batch) becomes ``{"q": int8 [L, K, N]
| packed int4 [L, K/2, N], "s": fp32 [L, G, N]}``, and each MoE expert
stack ``[L, E, K, N]`` (``moe_w1``, ``moe_w2``) quantizes per expert into
``{"q": [L, E, K | K/2, N], "s": [L, E, G, N]}``; biases, LayerNorm
affines, the router, the embeddings and the LM head stay as they are. The
unified step sends those leaves to the weight-only GEMM
(``ops/quant_matmul.py``) and the ragged grouped GEMM
(``ops/grouped_matmul.py``).

The scales go through the weight's dtype before fp32, as the reference's
do (``nn.quant`` returns them in ``w.dtype``): a bf16 model serves
bf16-rounded scales, while ``q`` was rounded against the unrounded ones.
Not ported: ``assert_quant_shardable`` (tensor-parallel serving).
"""
from __future__ import annotations

import torch

from ..nn.quant import _qmax, _weight_quantize_fn

#: the per-layer stacks that quantize (the decode-bound matmul weights)
QUANT_LAYER_KEYS = ("wqkv", "wo", "w1", "w2")
#: the MoE expert stacks ([L, E, K, N]: quantize per expert; the ragged
#: grouped GEMM takes {"q": [E, K, N], "s": [E, G, N]} slices)
MOE_QUANT_LAYER_KEYS = ("moe_w1", "moe_w2")


def _algo(weight_dtype: str) -> str:
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(
            f"weight_dtype must be 'int8' or 'int4', got {weight_dtype!r}")
    return f"weight_only_{weight_dtype}"


def quantize_weight(w, weight_dtype="int8", group_size=-1):
    """Quantize a ``[..., K, N]`` weight (leading dims batch: a ``[L, K,
    N]`` layer stack or an ``[L, E, K, N]`` expert stack quantizes in one
    pass, where the reference ``jax.vmap``s its quantizer over L and E):
    ``{"q": int8 [..., K, N] | packed [..., K/2, N], "s": fp32 [..., G,
    N]}`` (per channel: ``G = 1``)."""
    q, s = _weight_quantize_fn(w, _qmax(_algo(weight_dtype)),
                               weight_dtype == "int4", group_size)
    if s.dim() == w.dim() - 1:                     # per channel: [..., N]
        s = s.unsqueeze(-2)
    return {"q": q, "s": s.to(torch.float32)}


def quantize_serving_params(params, weight_dtype="int8", group_size=-1,
                            config=None):
    """Quantize a serving-params dict for the weight-only GEMM path.

    ``config``: an object whose ``_name_cfg`` mapping (the reference's
    ``QuantConfig.add_name_config`` entries) RESTRICTS which stacks of
    :data:`QUANT_LAYER_KEYS` and :data:`MOE_QUANT_LAYER_KEYS` quantize;
    None quantizes every one present. A config naming none of them
    raises. Returns a new dict: fp leaves are shared,
    quantized stacks are new tensors on the stacks' device.
    """
    _algo(weight_dtype)  # validate early
    present = set(params["layers"])
    keys = (set(QUANT_LAYER_KEYS) | set(MOE_QUANT_LAYER_KEYS)) & present
    if config is not None:
        named = set(getattr(config, "_name_cfg", {}))
        keys = named & keys
        if not keys:
            raise ValueError(
                f"QuantConfig names {sorted(named)} match no serving "
                f"layer stack — restrict with names from "
                f"{sorted(QUANT_LAYER_KEYS + MOE_QUANT_LAYER_KEYS)}")
    out = dict(params)
    layers = dict(params["layers"])
    for key in sorted(keys):
        layers[key] = quantize_weight(layers[key], weight_dtype, group_size)
    out["layers"] = layers
    return out


def is_quantized_params(params) -> bool:
    """Whether a serving params dict carries quantized weight stacks."""
    return any(isinstance(params["layers"].get(k), dict)
               for k in QUANT_LAYER_KEYS + MOE_QUANT_LAYER_KEYS)


def serving_weight_bytes(params) -> int:
    """Device bytes a decode step reads in weights (per token batch): every
    tensor leaf of the params dict — what weight-only quantization
    shrinks."""
    def visit(leaf):
        if isinstance(leaf, dict):
            return sum(visit(v) for v in leaf.values())
        return leaf.numel() * leaf.element_size()

    return int(visit(params))
