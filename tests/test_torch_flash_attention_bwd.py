"""Port flash attention backward (plain path, CPU) against the JAX package:

- ``flash_attention_bwd_reference`` against the Pallas ``_bwd_fused_kernel``
  run in interpret mode (``flash_bwd_impl``), fed the same ``lse`` (from the
  JAX forward) and ``delta``;
- torch autograd through the port's ``flash_attention`` (the custom op: plain
  forward, plain backward twin, delta and the GQA group sum in between)
  against ``jax.grad`` of the JAX ``flash_attention``.

Cases: causal and non-causal; GQA group 2; ``sq < sk`` and ``sq > sk`` (the
causal rows that see no key get no gradient); head_dim 64; seq 128/256;
fp32. Tolerance ``rtol 1e-5, atol 1e-5``: the same fp32 math with sums in
another order.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import (_flash_fwd_impl,
                                                   flash_attention as jflash,
                                                   flash_bwd_impl)
from paddle_tpu_torch.ops.flash_attention import (
    LSE_INVALID, flash_attention, flash_attention_bwd,
    flash_attention_bwd_reference)

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [
    (2, 128, 128, 4, 4),     # self-attention
    (1, 128, 128, 4, 2),     # GQA group 2
    (1, 128, 256, 2, 2),     # sq < sk: bottom-right causal alignment
    (1, 256, 128, 2, 1),     # sq > sk: causal rows 0..127 see no key
]
D = 64


def _inputs(b, sq, sk, hq, hkv, seed):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, sq, hq, D)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, D)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, D)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, D)).astype(np.float32)
    return q, k, v, do


def _bhsd(x):
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _bshd(x, b):
    bh, s, d = x.shape
    return np.asarray(x).reshape(b, bh // b, s, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,sk,hq,hkv", CASES)
def test_bwd_twin_matches_jax_kernel(b, sq, sk, hq, hkv, causal):
    q, k, v, do = _inputs(b, sq, sk, hq, hkv, seed=sq + 3 * sk + hkv)
    scale = 1.0 / math.sqrt(D)
    jq, jk, jv, jdo = (jnp.asarray(_bhsd(x)) for x in (q, k, v, do))
    out, lse = _flash_fwd_impl(jq, jk, jv, None, None, scale, causal, hq)
    delta = jnp.sum(jdo * out, axis=-1)[:, None, :]
    want = flash_bwd_impl(jq, jk, jv, jdo, lse, delta, scale, causal, hq=hq)
    got = flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v, do)),
        torch.from_numpy(np.array(lse)), torch.from_numpy(np.array(delta)),
        causal=causal, scale=scale)
    ref = flash_attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v, do)),
        torch.from_numpy(np.array(lse)), torch.from_numpy(np.array(delta)),
        causal=causal, scale=scale)
    for name, g, r, w in zip(("dq", "dk", "dv"), got, ref, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)   # CPU route = twin
        np.testing.assert_allclose(g.numpy(), _bshd(w, b), **TOL,
                                   err_msg=name)
    if causal and sq > sk:       # rows that saw no key: lse invalid, dq = 0
        assert (np.asarray(lse)[:, 0, :sq - sk] == LSE_INVALID).all()
        assert not got[0].numpy()[:, :sq - sk].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,sk,hq,hkv", CASES)
def test_autograd_matches_jax_grad(b, sq, sk, hq, hkv, causal):
    q, k, v, do = _inputs(b, sq, sk, hq, hkv, seed=7 * sq + sk + hq)

    def jloss(q_, k_, v_):
        return jnp.sum(jflash(q_, k_, v_, causal=causal) * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(do)).sum().backward()
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_bwd_reference_casts_in_bf16():
    """The twin rounds p to do's dtype before p^T do and ds to q's dtype
    before its products (the Pallas kernel's casts): in bf16 its dv equals
    the fp32 formula on the rounded p, not on the exact p."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(1, 64, 64, 2, 2, seed=11))
    scale = 1.0 / math.sqrt(D)
    qh, kh, vh, doh = (x.float().transpose(1, 2) for x in (q, k, v, do))
    s = scale * qh @ kh.transpose(-1, -2)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = (p @ vh).transpose(1, 2)
    delta = (do.float() * out).sum(-1).transpose(1, 2).reshape(2, 1, 64)
    _, _, dv = flash_attention_bwd_reference(
        q, k, v, do, lse.reshape(2, 1, 64), delta, scale=scale)
    want = (p.to(torch.bfloat16).float().transpose(-1, -2) @ doh)
    torch.testing.assert_close(dv.float(), want.transpose(1, 2).to(
        torch.bfloat16).float(), rtol=0, atol=0)
