"""Kernels of the port: each ``*.py`` here wraps one hand-written CUDA
kernel (``csrc/*.cu``) and holds its plain PyTorch version beside it."""


def _wrappers() -> tuple:
    """Every kernel wrapper that keeps launch or twin-route counters."""
    from . import (flash_attention, fused_mlp, grouped_matmul, mega_decode,
                   paged_attention, quant_matmul)

    return (paged_attention.ragged_paged_attention,
            paged_attention.paged_attention, fused_mlp.ln_fwd,
            fused_mlp.ln_bwd, fused_mlp.gelu_fwd, fused_mlp.gelu_bwd,
            quant_matmul.quant_matmul_fwd, quant_matmul.quant_matmul_bwd,
            grouped_matmul.grouped_matmul_fwd,
            grouped_matmul.grouped_matmul_bwd, mega_decode.mega_attn_layer,
            mega_decode.mega_mlp, flash_attention.flash_attention_fwd,
            flash_attention.flash_attention_bwd)


def twin_routes() -> int:
    """Calls routed to a plain twin on the card (activations of a dtype no
    kernel is built for, fp64 say: ``_build.kernel_takes``), summed over
    every wrapper's ``.twin_routes``."""
    return sum(getattr(f, "twin_routes", 0) for f in _wrappers())


def counters() -> dict:
    """Every wrapper's counters (each attribute named ``*launches`` and
    ``twin_routes``), flat: ``(wrapper, attribute, key) -> count``, with
    key ``None`` for an int counter and the dict's key for a dict of
    counts. A captured CUDA graph runs no Python: the serving step reads
    these around its capture and adds the difference on every replay."""
    out = {}
    for fn in _wrappers():
        for attr, v in vars(fn).items():
            if not (attr.endswith("launches") or attr == "twin_routes"):
                continue
            if isinstance(v, dict):
                out.update({(fn.__name__, attr, k): int(n)
                            for k, n in v.items()})
            else:
                out[(fn.__name__, attr, None)] = int(v)
    return out


def set_counters(values: dict, add: bool = False) -> None:
    """Set (``add``: add to) the counters named in ``values``, a dict in
    the form :func:`counters` returns."""
    by_name = {f.__name__: f for f in _wrappers()}
    for (name, attr, key), n in values.items():
        fn = by_name[name]
        if key is None:
            setattr(fn, attr, (getattr(fn, attr) if add else 0) + n)
        else:
            held = getattr(fn, attr)
            held[key] = (held.get(key, 0) if add else 0) + n
