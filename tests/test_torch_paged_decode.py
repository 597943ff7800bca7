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


# -- the kernel's split walk (csrc/paged_decode_attention.cu on
# csrc/paged_walk.cuh), written out in torch ---------------------------------

KEYS = 32   # keys a tile of the walk (paged_walk.cuh kKeys)
# (hq, hkv): MHA, GQA 12/4 (a group of 3 rows against the walk's 4-row
# thread groups) and 16/2, MQA 8/1
WALK_HEADS = [(4, 4), (12, 4), (16, 2), (8, 1)]


def decode_split_twin(q, kp, vp, pt, lengths, pages):
    """The decode kernel's algorithm in torch: each (slot, kv head) pair's
    context cut into splits of ``pages`` whole pages, each split an online
    softmax over tiles of at most KEYS keys that never cross a page (a page
    below KEYS keys is one tile), keeping (acc, m, l) of the GQA group's
    rows; the splits merged in split order; an empty slot zeros and no
    page read."""
    b, hq, d = q.shape
    num_pages, ps, hkv, _ = kp.shape
    group, pps = hq // hkv, pt.shape[1]
    scale = 1.0 / np.sqrt(d)
    out = torch.zeros(b, hq, d)
    for i in range(b):
        length = int(lengths[i])
        if length <= 0:
            continue
        ctx = min(length, pps * ps)
        for h in range(hkv):
            qr = q[i, h * group:(h + 1) * group].float()
            parts = []
            for k0 in range(0, pps * ps, pages * ps):
                k1 = min(ctx, k0 + pages * ps)
                if k1 <= k0:
                    parts.append(None)     # owns no page, still arrives
                    continue
                acc = torch.zeros(group, d)
                m = torch.full((group,), -1e30)
                l = torch.zeros(group)
                for p in range(k0 // ps, -(-k1 // ps)):
                    page = min(max(int(pt[i, p]), 0), num_pages - 1)
                    for t0 in range(0, ps, KEYS):
                        key0 = p * ps + t0
                        nt = min(KEYS, ps - t0, k1 - key0)
                        if nt <= 0:
                            break
                        kk = kp[page, t0:t0 + nt, h].float()
                        vv = vp[page, t0:t0 + nt, h].float()
                        s = (qr @ kk.T) * scale
                        m_new = torch.maximum(m, s.amax(1))
                        pr = torch.exp(s - m_new[:, None])
                        alpha = torch.exp(m - m_new)
                        acc = acc * alpha[:, None] + pr @ vv
                        l = l * alpha + pr.sum(1)
                        m = m_new
                parts.append((acc, m, l))
            live = [x for x in parts if x is not None]
            mx = torch.stack([x[1] for x in live]).amax(0)
            acc, l = torch.zeros(group, d), torch.zeros(group)
            for a, ms, ls in live:      # in split order
                w = torch.where(ls > 0, torch.exp(ms - mx), 0.0)
                acc, l = acc + a * w[:, None], l + ls * w
            out[i, h * group:(h + 1) * group] = acc / l[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("pages", [1, 2, 3, 4])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("hq,hkv", WALK_HEADS)
def test_decode_split_twin_matches_jax_reference(hq, hkv, ps, pages):
    """The split walk (any whole pages a split, from one to the whole
    table, empty splits past a short context, pages below the 32-key tile)
    computes the jnp reference's function: fp32, 1e-5; the empty slot
    zeros."""
    arrays = _inputs(hq * 31 + ps + pages, hq, hkv, 16, ps)
    want = _jax(arrays)
    got = decode_split_twin(*_torch(arrays), pages).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)
    assert not got[0].any()


@pytest.mark.parametrize("geom", [
    (8, 12, 16, 64, 64, 1),       # GPT-125M's legacy step: b 8, 1,024 keys
    (8, 32, 32, 64, 64, 1),       # gpt3-1.3b, contexts to 2,048
    (5, 2, 9, 16, 128, 8),        # GQA 16/2 at page 16
    (5, 4, 9, 16, 96, 3),         # GQA 12/4
    (4, 1, 9, 16, 80, 8),         # MQA 8/1
    (4, 4, 9, 16, 32, 1),         # d 32
    (6, 2, 4, 8, 16, 2),          # page 8, the CPU twin's
    (256, 32, 64, 16, 128, 8),    # a large batch: one split a pair
    (1, 1, 1, 64, 64, 1)])        # a one-page table
def test_decode_walk_plan_walks_every_page_once(geom):
    """The decode kernel's plan (``walk_plan`` with the GQA group as its
    rows): every page of the table walked by exactly one split, each split
    one page at least, the partials within ``PARTIAL_CAP``, a decode round
    of GPT-125M's 96 pairs past one wave of the H100's 132 SMs, and the
    same shapes give the same plan (nothing but shapes goes in)."""
    from paddle_tpu_torch.ops.paged_attention import PARTIAL_CAP, walk_plan
    b, hkv, pps, ps, d, group = geom
    plan = walk_plan(b, hkv, pps, ps, d, group, 4, 132)
    seen = np.zeros(pps, int)
    for z in range(plan.splits):
        lo, hi = z * plan.pages, min((z + 1) * plan.pages, pps)
        assert lo < hi, f"split {z} covers no page"
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert plan.blocks == b * hkv * plan.splits
    assert plan.partial_bytes <= PARTIAL_CAP
    assert (plan.partial_bytes == 0) == (plan.splits == 1)
    if plan.splits > 1:   # one fp32 partial of the group's rows a split
        assert plan.partial_bytes == b * hkv * plan.splits * 16 * -(
            -group * (d + 2) // 4)
    if geom[:3] == (8, 12, 16):
        assert plan.blocks > 132 > b * hkv
    assert walk_plan(b, hkv, pps, ps, d, group, 4, 132) == plan
    assert walk_plan(b, hkv, pps, ps, d, group, 2, 132) == plan


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
