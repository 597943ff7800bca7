"""Port GPT (full forward + serving params) against the JAX package on the
same weights, carried across by ``models/convert.py``.

Full-forward logits: fp32 on the CPU, ``rtol 1e-5, atol 1e-5`` (the same
math with fp32 sums in another order). ``serving_params`` stacks are
copies of the same weights, so they must be equal exactly. With
``fused_mlp=True`` the decoder blocks take the fused LN / GELU ops (their
plain versions on the CPU; the reference's interpret-mode kernels with
``force_fused_mlp``, its jnp references without): logits at the same
tolerance, and every parameter's gradient of a seeded linear loss within
1e-5 of the leaf's max ``|grad|``.
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


@pytest.mark.parametrize("force", [False, True])
def test_fused_mlp_logits_and_grads_match_jax(force):
    jm, tm = _pair(fused_mlp=True, force_fused_mlp=force)
    jm.train()
    tm.train()
    rng = np.random.RandomState(6)
    ids = rng.randint(0, TINY["vocab_size"], (2, 24))
    w = rng.standard_normal((2, 24, TINY["vocab_size"])).astype(np.float32)
    out = jm(paddle.to_tensor(ids.astype(np.int64)))
    (out * paddle.to_tensor(w)).sum().backward()
    want = {n: p.grad for n, p in jm.named_parameters()}
    got_logits = tm(torch.from_numpy(ids))
    (got_logits * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got_logits.detach().numpy(), out.numpy(),
                               rtol=1e-5, atol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        assert g is not None and got[name].grad is not None, name
        wg = np.asarray(g.numpy())
        err = np.abs(got[name].grad.numpy() - wg).max() / np.abs(wg).max()
        assert err <= 1e-5, (name, err)


def test_fused_mlp_forward_equals_unfused():
    """fp32: the fused block computes the unfused block's function."""
    _, plain = _pair(seed=2)
    _, fused = _pair(seed=2, fused_mlp=True)
    ids = torch.from_numpy(np.random.RandomState(7).randint(
        0, TINY["vocab_size"], (2, 20)))
    with torch.no_grad():
        torch.testing.assert_close(fused(ids), plain(ids), rtol=1e-5,
                                   atol=1e-5)


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
    # MoE is ported; the mega step stays dense-only, as in the reference
    with pytest.raises(ValueError, match="dense-only"):
        tgpt.build_unified_step(tgpt.GPTConfig(**TINY, moe_experts=2), 8, 4,
                                mega=True)
    tgpt.build_unified_step(tgpt.GPTConfig(**TINY, moe_experts=2), 8, 4)
    # speculation is ported on the dense step; with MoE it is a later slice
    cfg = tgpt.GPTConfig(**TINY)
    assert tgpt.build_unified_step(cfg, 8, 4, spec_k=2).spec_k == 2
    for c, kw in ((tgpt.GPTConfig(**TINY, moe_experts=2), dict(spec_k=2)),
                  (cfg, dict(mesh=object()))):
        with pytest.raises(NotImplementedError, match="later port slice"):
            tgpt.build_unified_step(c, 8, 4, **kw)
    # mega is ported; int4 weights are what it cannot serve, as in the
    # reference
    with pytest.raises(ValueError, match="int4"):
        tgpt.build_unified_step(tgpt.GPTConfig(**TINY, weight_dtype="int4"),
                                8, 4, mega=True)
