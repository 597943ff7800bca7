"""Weight carry-over between the reference and the port.

Weights cross as a dict of numpy arrays keyed the way the reference's
``jit.api._named_state`` names them (``gpt.embeddings.word_embeddings
.weight``, ``gpt.layers.{i}.attn.qkv_proj.weight``, ...). The port's
module tree uses the same names and the same ``[in, out]`` linear layout,
so loading is a key-for-key copy: no transpose anywhere.
"""
from __future__ import annotations

import numpy as np
import torch

from .gpt import GPTConfig, GPTForCausalLM


def state_from_jax_numpy(named: dict, config: GPTConfig, *, device=None,
                         dtype=torch.float32) -> GPTForCausalLM:
    """A ``GPTForCausalLM`` on ``device`` holding exactly ``named``'s
    weights (cast to ``dtype``). Raises on any missing, extra or wrongly
    shaped key."""
    model = GPTForCausalLM(config, device=device, dtype=dtype)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(want) - set(named))
    extra = sorted(set(named) - set(want))
    bad = sorted(k for k in set(want) & set(named)
                 if tuple(np.shape(named[k])) != want[k])
    if missing or extra or bad:
        raise ValueError(
            "state_from_jax_numpy: "
            + "; ".join(f"{what}: {keys}" for what, keys in
                        (("missing", missing), ("extra", extra),
                         ("wrong shape", [(k, np.shape(named[k]), want[k])
                                          for k in bad])) if keys))
    dev = next(model.parameters()).device
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)).to(dev, dtype)
                           for k, v in named.items()})
    return model


def random_state(config: GPTConfig, seed: int = 0) -> dict:
    """Seeded numpy weights under the reference's names and init scheme:
    N(0, initializer_range) embeddings and weight matrices, zero biases,
    unit LN scales — what both packages load in tests and on the card."""
    rng = np.random.default_rng(seed)
    h, f, v = config.hidden_size, config.ffn_size, config.vocab_size
    std = config.initializer_range

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * std)

    out = {"gpt.embeddings.word_embeddings.weight": normal(v, h),
           "gpt.embeddings.position_embeddings.weight":
               normal(config.max_seq_len, h)}
    for i in range(config.num_layers):
        p = f"gpt.layers.{i}."
        out.update({
            p + "ln_1.weight": np.ones(h, np.float32),
            p + "ln_1.bias": np.zeros(h, np.float32),
            p + "attn.qkv_proj.weight": normal(h, 3 * h),
            p + "attn.qkv_proj.bias": np.zeros(3 * h, np.float32),
            p + "attn.out_proj.weight": normal(h, h),
            p + "attn.out_proj.bias": np.zeros(h, np.float32),
            p + "ln_2.weight": np.ones(h, np.float32),
            p + "ln_2.bias": np.zeros(h, np.float32),
            p + "mlp.fc1.weight": normal(h, f),
            p + "mlp.fc1.bias": np.zeros(f, np.float32),
            p + "mlp.fc2.weight": normal(f, h),
            p + "mlp.fc2.bias": np.zeros(h, np.float32),
        })
    out["gpt.ln_f.weight"] = np.ones(h, np.float32)
    out["gpt.ln_f.bias"] = np.zeros(h, np.float32)
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = normal(h, v)
    return out
