"""Port flash attention forward (plain path, CPU) against the JAX package's
Pallas ``_fwd_kernel`` run in interpret mode (``_flash_fwd_impl``), for
``out`` and ``lse``, on the same seeded inputs.

Cases: causal and non-causal, GQA, ``sq < sk`` (bottom-right causal
alignment) and ``sq > sk`` causal, whose first rows see no key (out 0,
lse ``LSE_INVALID``). fp32, ``atol 1e-5`` on out (fp32 sums in another
order), ``rtol 1e-5`` on lse.

In bf16 the JAX kernel rounds each key block's ``p`` to bf16 before
``p v`` (as the card's kernel does); the dense twin keeps ``p`` in fp32.
Both round ``out`` to bf16 once, so an element may differ by one bf16 step
(<= 2^-7 of it): each row's max abs error is held to ``1e-2`` of the row's
max ``|out|`` — the tolerance the card's bf16 kernel is held to against the
twin (``KERNEL_TOL`` in ``chip_smoke.py``) — and lse, summed from fp32
``p`` on both sides, to ``1e-5`` relative.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import _flash_fwd_impl
from paddle_tpu_torch.nn.functional.attention import (
    _sdpa_ref, scaled_dot_product_attention)
from paddle_tpu_torch.ops.flash_attention import (LSE_INVALID,
                                                  flash_attention,
                                                  flash_attention_fwd,
                                                  kernel_takes)


def _jax_flash(q, k, v, causal):
    b, sq, hq, d = q.shape

    def bhsd(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(
            b * x.shape[2], x.shape[1], d))

    out, lse = _flash_fwd_impl(bhsd(q), bhsd(k), bhsd(v), None, None,
                               1.0 / math.sqrt(d), causal, hq)
    out = np.asarray(out).reshape(b, hq, sq, d).transpose(0, 2, 1, 3)
    return out, np.asarray(lse)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,sk,hq,hkv", [
    (2, 16, 16, 4, 4),     # self-attention
    (1, 16, 16, 4, 2),     # GQA
    (2, 8, 24, 2, 1),      # sq < sk: bottom-right causal alignment
    (1, 24, 8, 2, 2),      # sq > sk: causal rows 0..15 see no key
])
def test_flash_twin_matches_jax_kernel(b, sq, sk, hq, hkv, causal):
    rng = np.random.RandomState(sq * 7 + sk + hkv)
    d = 16
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    want_out, want_lse = _jax_flash(q, k, v, causal)
    out, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    assert tuple(lse.shape) == want_lse.shape == (b * hq, 1, sq)
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=0)
    if causal and sq > sk:
        dead = sq - sk
        assert not out.numpy()[:, :dead].any()
        assert (lse.numpy()[:, 0, :dead] == LSE_INVALID).all()


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("causal,sq,sk", [(True, 256, 256),
                                          (True, 128, 256),
                                          (False, 256, 128)])
def test_bf16_twin_within_kernel_tolerance_of_jax_kernel(d, causal, sq, sk):
    """gpt3-2.7b's (d 80) and gpt3-760m's (d 96) head widths in bf16:
    the JAX kernel walks 64-key blocks (four or two of them), rounding each
    block's ``p`` with that block's running max."""
    b, hq, hkv = 1, 4, 2
    rng = np.random.RandomState(d + sq + sk)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))

    def bhsd(x):
        return jnp.asarray(x.float().numpy().transpose(0, 2, 1, 3).reshape(
            b * x.shape[2], x.shape[1], d), jnp.bfloat16)

    jout, jlse = _flash_fwd_impl(bhsd(qb), bhsd(kb), bhsd(vb), None, None,
                                 1.0 / math.sqrt(d), causal, hq,
                                 blocks=(64, 64))
    want = np.asarray(jout.astype(jnp.float32)).reshape(
        b, hq, sq, d).transpose(0, 2, 1, 3)
    out, lse = flash_attention_fwd(qb, kb, vb, causal=causal)
    assert out.dtype == torch.bfloat16
    diff = np.abs(out.float().numpy() - want).max(-1)
    row_max = np.maximum(np.abs(want).max(-1), 1e-30)
    assert (diff / row_max).max() <= 1e-2, (diff / row_max).max()
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=0)


def test_flash_mask_and_varlen_raise():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="mask"):
        flash_attention(x, x, x, mask=torch.zeros(1, 1, 4, 4))
    with pytest.raises(NotImplementedError, match="varlen"):
        flash_attention(x, x, x, q_seqlens=torch.tensor([4]))


def test_sdpa_routes_cpu_to_reference():
    """On the CPU every call takes the ``_sdpa_ref`` twin (the flash kernel
    is for CUDA tensors only) — no kernel launch is counted."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 12, 4, 8))
                                .astype(np.float32)) for _ in range(3))
    before = flash_attention_fwd.launches
    out = scaled_dot_product_attention(q, k, v, is_causal=True)
    assert flash_attention_fwd.launches == before
    torch.testing.assert_close(out, _sdpa_ref(q, k, v, causal=True))
    # causal sdpa and the flash twin agree where every row sees a key
    torch.testing.assert_close(out, flash_attention(q, k, v, causal=True),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("d", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32])
def test_kernel_takes_only_what_the_kernels_are_built_for(d, dtype):
    """The routing predicate: CUDA tensors with ``hq % hkv == 0`` in bf16
    at every head dim the reference's configs use (32 / 64 / 80 / 96 /
    128: the tensor-core kernels) or in fp32 at 64 / 128 go to the
    kernels; the rest (fp32 at 32 / 80 / 96, fp16 at any width) to plain
    attention. Decided from shape, dtype and device only, so a stand-in
    with those attributes plays a CUDA tensor here."""
    from types import SimpleNamespace

    cuda = torch.device("cuda", 0)

    def fake(shape, dt=dtype, device=cuda):
        return SimpleNamespace(shape=shape, dtype=dt, device=device)

    want = (dtype == torch.bfloat16
            or (dtype == torch.float32 and d in (64, 128)))
    assert kernel_takes(fake((2, 16, 4, d)), fake((2, 16, 4, d))) == want
    assert kernel_takes(fake((2, 16, 4, d)), fake((2, 16, 2, d))) == want
    assert not kernel_takes(fake((2, 16, 6, d)), fake((2, 16, 4, d)))
    other = torch.float32 if dtype != torch.float32 else torch.bfloat16
    assert not kernel_takes(fake((2, 16, 4, d)), fake((2, 16, 4, d), other))
    cpu = torch.zeros(2, 16, 4, d, dtype=dtype)
    assert not kernel_takes(cpu, cpu)
