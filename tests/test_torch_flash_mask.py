"""The port's flash attention mask and varlen branches (plain path, CPU)
against the JAX package's Pallas kernels run in interpret mode, on the same
seeded inputs:

- ``flash_attention(mask=)`` forward and q / k / v gradients against the JAX
  ``flash_attention(mask=)`` and ``jax.grad`` of it, for the mask shapes of
  ``tests/test_flash_attention.py`` (``[b, 1|2, s, s]``, the key-padding
  ``[b, 1, 1, s]``) plus ``[1, 1, s, s]``, 2-D, 3-D and a bool mask, causal
  and not; ``lse`` against ``_flash_fwd_impl`` with the same mask;
- ``flash_attention(q_seqlens=, kv_seqlens=)`` the same way, with a zero
  length, ``q_len != kv_len`` under causal (bottom-right per sequence) and
  rows past ``q_len`` (zeros, ``LSE_INVALID``, no gradient);
- an incompatible mask shape raising ``ValueError``;
- ``flash_attn_unpadded`` (the CPU route: the segment-masked plain version)
  and its kernel route run on CPU tensors (scatter, flash with lengths,
  gather) against the JAX ``flash_attn_unpadded`` fallback, forward and
  gradients.

s 128 with head_dim 64: lengths the JAX kernel's blocks divide, as its own
tests run it. fp32 throughout. Tolerances: out and lse ``rtol 1e-5, atol
1e-5`` (the same fp32 math summed in another order); gradients ``rtol
1e-5, atol 1e-5`` for the flash branches, whose backward the JAX kernel
computes with the same casts; the packed route against the JAX fallback
``rtol 1e-5, atol 1e-5`` as well (the same fp32 softmax).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.ops.pallas.flash_attention import (_flash_fwd_impl,
                                                   flash_attention as jflash)
from paddle_tpu_torch.nn.functional import flash_attn_unpadded
from paddle_tpu_torch.nn.functional.attention import _unpadded_flash
from paddle_tpu_torch.ops.flash_attention import (LSE_INVALID, NEG_INF,
                                                  flash_attention,
                                                  flash_attention_fwd,
                                                  normalize_mask, seq_lens)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, H, D = 2, 128, 2, 64


def _qkv(seed, b=B, sq=S, sk=S, h=H):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((b, sq, h, D), (b, sk, h, D), (b, sk, h, D), (b, sq, h, D)))


def _masks(rng):
    """name -> numpy mask (additive fp32 with NEG_INF entries, or bool)."""
    def holes(shape):
        return np.where(rng.rand(*shape) < 0.2, NEG_INF, 0.0).astype(
            np.float32)

    pad = np.zeros((B, 1, 1, S), np.float32)
    pad[0, ..., 100:] = NEG_INF             # batch 0: keys past 100 masked
    return {"b1ss": holes((B, 1, S, S)), "bhss": holes((B, H, S, S)),
            "b11s key padding": pad, "11ss": holes((1, 1, S, S)),
            "2-D": holes((S, S)), "3-D": holes((B, S, S)),
            "bool": rng.rand(B, 1, S, S) >= 0.2}


def _bhsd(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _check_grads(jfn, tfn, q, k, v, do):
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) * do), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tfn(tq, tk, tv) * torch.from_numpy(do)).sum().backward()
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["b1ss", "bhss", "b11s key padding", "11ss",
                                  "2-D", "3-D", "bool"])
def test_mask_matches_jax_kernel(name, causal):
    mask = _masks(np.random.RandomState(5))[name]
    q, k, v, do = _qkv(11)
    tmask = torch.from_numpy(mask)
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal, mask=tmask)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    # lse of the forward wrapper against the JAX kernel's, same mask
    m4 = normalize_mask(tmask, torch.from_numpy(q), S)
    _, lse = flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal, mask=m4)
    _, jlse = _flash_fwd_impl(_bhsd(q), _bhsd(k), _bhsd(v),
                              jnp.asarray(m4.numpy()), None,
                              1.0 / math.sqrt(D), causal, H)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    _check_grads(lambda *a: jflash(*a, causal=causal, mask=jnp.asarray(mask)),
                 lambda *a: flash_attention(*a, causal=causal, mask=tmask),
                 q, k, v, do)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_lens,kv_lens", [
    ([128, 70, 0], [128, 40, 0]),     # the JAX test's lengths: a zero length
    ([50, 128, 1], [90, 17, 128]),    # q_len != kv_len both ways
])
def test_varlen_matches_jax_kernel(q_lens, kv_lens, causal):
    b = len(q_lens)
    q, k, v, do = _qkv(13, b=b)
    ql, kl = np.asarray(q_lens, np.int32), np.asarray(kv_lens, np.int32)
    tl = dict(q_seqlens=torch.from_numpy(ql), kv_seqlens=torch.from_numpy(kl))
    jl = dict(q_seqlens=jnp.asarray(ql), kv_seqlens=jnp.asarray(kl))
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal, **tl)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, **jl)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    lens = seq_lens(tl["q_seqlens"], tl["kv_seqlens"], b, S, S, "cpu")
    _, lse = flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal, lens=lens)
    _, jlse = _flash_fwd_impl(_bhsd(q), _bhsd(k), _bhsd(v), None,
                              jnp.asarray(lens.numpy()), 1.0 / math.sqrt(D),
                              causal, H)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    lse = lse.reshape(b, H, S)
    for i, n in enumerate(q_lens):        # rows past q_len: zero, invalid
        assert not out[i, n:].any()
        assert (lse[i, :, n:] == LSE_INVALID).all()
    _check_grads(lambda *a: jflash(*a, causal=causal, **jl),
                 lambda *a: flash_attention(*a, causal=causal, **tl),
                 q, k, v, do)


def test_incompatible_mask_shape_raises():
    q = torch.zeros(B, S, H, D)
    with pytest.raises(ValueError, match="mask shape"):
        flash_attention(q, q, q, mask=torch.zeros(B, H, S, 1))
    with pytest.raises(ValueError, match="mask shape"):
        flash_attention(q, q, q, mask=torch.zeros(B, 3, S, S))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_unpadded_matches_jax_fallback(causal):
    total, cu = 200, np.array([0, 64, 190, 200], np.int64)
    rng = np.random.RandomState(17)
    q, k, v, do = (rng.standard_normal((total, H, D)).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv = (paddle.to_tensor(x, stop_gradient=False) for x in (q, k, v))
    jcu = paddle.to_tensor(cu)
    jout, none = jattn.flash_attn_unpadded(jq, jk, jv, jcu, jcu, 128, 128,
                                           causal=causal)
    assert none is None
    (jout * paddle.to_tensor(do)).sum().backward()
    want = [np.asarray(t.grad._data) for t in (jq, jk, jv)]
    tcu = torch.from_numpy(cu)
    for label, fn in (
            ("plain route", lambda *a: flash_attn_unpadded(
                *a, tcu, tcu, 128, 128, causal=causal)[0]),
            ("kernel route on CPU tensors", lambda *a: _unpadded_flash(
                *a, tcu, tcu, 128, 128, causal=causal))):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = fn(tq, tk, tv)
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(jout._data), **TOL,
                                   err_msg=label)
        (out * torch.from_numpy(do)).sum().backward()
        for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                              want):
            np.testing.assert_allclose(g.numpy(), w, **TOL,
                                       err_msg=f"{label} {name}")
