"""Port single-token paged decode attention (plain path, CPU) against the
JAX package's jnp ``paged_attention_reference`` on the same seeded inputs,
and the serving entries of ``incubate.nn.functional`` against the JAX
entries.

The oracle is the jnp gather reference (``use_kernel=False``): the JAX
Pallas decode kernel cannot trace on this jax (``pltpu.TPUCompilerParams``).
fp32: both gather and reduce in fp32 in different orders, ``atol 1e-5``.
bf16: both sides compute in fp32 from the same bf16 inputs and round the
result to bf16 once, so an element may sit one bf16 step apart: ``rtol
2^-7`` (one step at the top of a binade), ``atol 1e-6``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JFI
from paddle_tpu.nn import quant as jquant
from paddle_tpu.ops.pallas.paged_attention import (
    paged_attention_reference as jax_decode_reference)
from paddle_tpu_torch.incubate.nn import functional as TFI
from paddle_tpu_torch.ops.paged_attention import (paged_attention,
                                                  paged_attention_reference)

FP32_TOL = dict(atol=1e-5, rtol=0)
BF16_TOL = dict(atol=1e-6, rtol=2 ** -7)


def _inputs(seed, hq, hkv, d, ps, pps=4):
    """Six slots: an empty slot, one token, exactly one page, one past a
    page boundary, two pages, every page; -1 entries past each context."""
    rng = np.random.RandomState(seed)
    lengths = np.array([0, 1, ps, ps + 1, 2 * ps, pps * ps], np.int32)
    b = len(lengths)
    num_pages = b * pps + 2
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    for i in range(b):
        pt[i, (lengths[i] + ps - 1) // ps:] = -1
    return q, kp, vp, pt, lengths


def _jax(arrays, scale=None, dtype=jnp.float32):
    q, kp, vp, pt, lengths = arrays
    out = jax_decode_reference(*(jnp.asarray(a, dtype) for a in (q, kp, vp)),
                               jnp.asarray(pt), jnp.asarray(lengths),
                               scale=scale)
    return np.asarray(out.astype(jnp.float32))


def _torch(arrays, dtype=torch.float32):
    q, kp, vp, pt, lengths = (torch.from_numpy(a) for a in arrays)
    return q.to(dtype), kp.to(dtype), vp.to(dtype), pt, lengths


@pytest.mark.parametrize("d", [8, 32, 80, 96])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_decode_twin_matches_jax_reference(hq, hkv, ps, d):
    arrays = _inputs(hq * 100 + ps + d, hq, hkv, d, ps)
    want = _jax(arrays)
    got = paged_attention(*_torch(arrays)).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)
    assert not got[0].any()                 # the empty slot gives zeros
    assert np.abs(got[1:]).min(axis=-1).max() > 0


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_decode_twin_bf16_matches_jax_reference(hq, hkv, d):
    arrays = _inputs(7 * hq + d, hq, hkv, d, 16)
    want = _jax(arrays, dtype=jnp.bfloat16)
    got = paged_attention(*_torch(arrays, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_decode_scale_override_and_long_lengths():
    """A given scale replaces 1/sqrt(d); a length past the page table's
    reach attends every position the table covers, as the reference's
    mask does."""
    arrays = list(_inputs(5, 4, 2, 32, 8))
    arrays[4] = arrays[4].copy()
    arrays[4][5] = 100                      # > pps * ps = 32
    want = _jax(arrays, scale=0.3)
    got = paged_attention(*_torch(arrays), scale=0.3).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_cpu_entry_takes_the_twin_and_checks_shapes():
    q, kp, vp, pt, lengths = _torch(_inputs(0, 4, 2, 32, 8))
    before = paged_attention.launches
    q.requires_grad_(True)
    out = paged_attention(q, kp, vp, pt, lengths)
    assert paged_attention.launches == before           # no kernel launch
    assert out.device.type == "cpu" and out.dtype == torch.float32
    assert not out.requires_grad                          # decode-only
    torch.testing.assert_close(out, paged_attention_reference(
        q.detach(), kp, vp, pt, lengths))
    with pytest.raises(ValueError, match="divisible by kv"):
        paged_attention(q.detach()[:, :3], kp, vp, pt, lengths)
    with pytest.raises(ValueError, match="pool shapes"):
        paged_attention(q.detach(), kp, vp[:, :4], pt, lengths)
    with pytest.raises(ValueError, match="lead with the batch"):
        paged_attention(q.detach(), kp, vp, pt, lengths[:3])
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_attention(q.detach().to("meta"), kp, vp, pt, lengths)


# -- incubate.nn.functional serving entries --------------------------------


def _to_paddle(*arrays):
    return [None if a is None else paddle.to_tensor(a) for a in arrays]


def _ragged_inputs(rng, b=4, chunk=4, hq=4, hkv=2, d=16, ps=8, pps=3):
    num_pages = b * pps + 1
    q = rng.standard_normal((b, chunk, hq, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    q_lens = np.array([0, 1, chunk, 2], np.int32)
    kv_lens = np.array([0, 17, 9, 24], np.int32)
    return q, kp, vp, pt, kv_lens, q_lens


def _entry_case(entry, rng):
    """(numpy args both entries take, the output rows to compare or None
    for all)."""
    if entry == "paged_attention":
        return _inputs(3, 4, 2, 16, 8), None
    if entry == "ragged_paged_attention":
        args = _ragged_inputs(rng)
        valid = np.arange(4)[None] < args[5][:, None]
        return args, valid
    if entry == "quant_matmul":
        w = (rng.standard_normal((32, 24)) * 0.1).astype(np.float32)
        q, s = (np.asarray(t) for t in
                jquant.weight_quantize(paddle.to_tensor(w),
                                       algo="weight_only_int4",
                                       group_size=8))
        x = rng.standard_normal((5, 32)).astype(np.float32)
        bias = rng.standard_normal(24).astype(np.float32)
        return (x, q, s, bias), None
    w = (rng.standard_normal((3, 16, 12)) * 0.1).astype(np.float32)
    x = rng.standard_normal((7, 16)).astype(np.float32)
    offs = np.array([0, 4, 4, 7], np.int32)
    return (x, w, offs), None


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("entry", ["paged_attention",
                                   "ragged_paged_attention", "quant_matmul",
                                   "grouped_matmul"])
def test_incubate_serving_entries_match_jax(entry, use_kernel):
    """The four serving entries keep the reference's signatures; on a CPU
    tensor ``use_kernel`` None and False both run the plain version, and
    agree with the JAX entry (``use_kernel=False``) in fp32."""
    rng = np.random.RandomState(4)
    args, rows = _entry_case(entry, rng)
    want = np.asarray(getattr(JFI, entry)(*_to_paddle(*args),
                                          use_kernel=False).numpy())
    got = getattr(TFI, entry)(*(torch.from_numpy(np.array(a))
                                for a in args), use_kernel=use_kernel)
    got = got.numpy()
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_incubate_attention_entries_carry_no_gradient():
    q, kp, vp, pt, lengths = _torch(_inputs(1, 4, 4, 16, 8))
    q.requires_grad_(True)
    for use_kernel in (None, False):
        assert not TFI.paged_attention(q, kp, vp, pt, lengths,
                                       use_kernel=use_kernel).requires_grad
    rq, rk, rv, rpt, kv, ql = (torch.from_numpy(a) for a in
                               _ragged_inputs(np.random.RandomState(2)))
    rq.requires_grad_(True)
    assert not TFI.ragged_paged_attention(rq, rk, rv, rpt, kv,
                                          ql).requires_grad


def test_incubate_bf16_decode_entry_matches_jax():
    arrays = _inputs(9, 8, 2, 32, 16)
    q, kp, vp, pt, lengths = arrays
    bf = [paddle.to_tensor(np.asarray(a, ml_dtypes.bfloat16))
          for a in (q, kp, vp)]
    want = np.asarray(JFI.paged_attention(
        *bf, paddle.to_tensor(pt), paddle.to_tensor(lengths),
        use_kernel=False).numpy()).astype(np.float32)
    got = TFI.paged_attention(*_torch(arrays, torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
