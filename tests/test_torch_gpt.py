"""Port GPT (full forward + serving params) against the JAX package on the
same weights, carried across by ``models/convert.py``.

Full-forward logits: fp32 on the CPU, ``rtol 1e-5, atol 1e-5`` (the same
math with fp32 sums in another order). ``serving_params`` stacks are
copies of the same weights, so they must be equal exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.api import _named_state
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import random_state, state_from_jax_numpy

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=96, initializer_range=0.2)


def _pair(seed=0, **over):
    kw = {**TINY, **over}
    named = random_state(tgpt.GPTConfig(**kw), seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**kw))
    jm.eval()
    state = _named_state(jm)
    assert set(state) == set(named)
    for name, t in state.items():
        t.set_value(named[name])
    tm = state_from_jax_numpy(named, tgpt.GPTConfig(**kw), device="cpu")
    tm.eval()
    return jm, tm


@pytest.mark.parametrize("over", [{}, {"tie_word_embeddings": False},
                                  {"intermediate_size": 48}])
def test_full_forward_logits_match_jax(over):
    jm, tm = _pair(**over)
    ids = np.random.RandomState(5).randint(0, TINY["vocab_size"], (2, 24))
    want = jm(paddle.to_tensor(ids.astype(np.int64))).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_serving_params_stacks_equal():
    jm, tm = _pair(seed=1)
    want = jgpt.serving_params(jm)
    got = tgpt.serving_params(tm)
    assert set(got) == set(want)
    assert set(got["layers"]) == set(want["layers"])
    for k in want:
        if k != "layers":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k, v in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(),
                                      np.asarray(v))


def test_config_and_catalog_match_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jgpt.GPTConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tgpt.GPTConfig)}
    assert tf == jf
    assert {k: dataclasses.asdict(c) for k, c in tgpt.GPT_CONFIGS.items()} \
        == {k: dataclasses.asdict(c) for k, c in jgpt.GPT_CONFIGS.items()}


def test_convert_rejects_bad_state():
    cfg = tgpt.GPTConfig(**TINY)
    named = random_state(cfg, 0)
    missing = dict(named)
    missing.pop("gpt.ln_f.bias")
    with pytest.raises(ValueError, match="missing"):
        state_from_jax_numpy(missing, cfg, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        state_from_jax_numpy({**named, "gpt.bogus": np.zeros(1)}, cfg,
                             device="cpu")
    bad = dict(named)
    bad["gpt.layers.0.attn.qkv_proj.weight"] = np.zeros((96, 32), np.float32)
    with pytest.raises(ValueError, match="wrong shape"):
        state_from_jax_numpy(bad, cfg, device="cpu")


def test_unported_flags_raise():
    with pytest.raises(NotImplementedError, match="moe_experts"):
        tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY, moe_experts=2),
                            device="cpu")
    cfg = tgpt.GPTConfig(**TINY)
    for kw in (dict(kv_quant=True), dict(spec_k=2), dict(mega=True),
               dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="later port slice"):
            tgpt.build_unified_step(cfg, 8, 4, **kw)
