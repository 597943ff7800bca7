"""Port ragged paged attention (plain path, CPU) against the JAX package's
jnp ``ragged_paged_attention_reference`` on the same seeded inputs.

Only valid rows (``row < q_lens[b]``) are compared: past ``q_lens`` the
TPU kernel leaves garbage and both references write zeros. fp32,
``atol 1e-5`` (both gather and reduce in fp32, in different orders);
int8 pools dequantize in fp32 on both sides.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.paged_attention import (
    ragged_paged_attention_reference as jax_ragged_reference)
from paddle_tpu_torch.ops.paged_attention import ragged_paged_attention


def _inputs(seed, b, chunk, hq, hkv, d, ps, pps):
    rng = np.random.RandomState(seed)
    num_pages = b * pps + 2
    q = rng.standard_normal((b, chunk, hq, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    # q_lens: idle lane, decode lane, full chunk, partial chunk
    q_lens = np.array([0, 1, chunk, chunk // 2 + 1] * b, np.int32)[:b]
    kv_lens = np.maximum(rng.randint(1, pps * ps + 1, size=b), q_lens
                         ).astype(np.int32)
    for i in range(b):      # unallocated entries past each context
        pt[i, (kv_lens[i] + ps - 1) // ps:] = -1
    return q, kp, vp, pt, kv_lens, q_lens


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_ragged_twin_matches_jax_reference(hq, hkv, ps):
    q, kp, vp, pt, kv_lens, q_lens = _inputs(hq * 10 + ps, b=5, chunk=4,
                                             hq=hq, hkv=hkv, d=8, ps=ps,
                                             pps=4)
    want = np.asarray(jax_ragged_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(kv_lens), jnp.asarray(q_lens)))
    got = ragged_paged_attention(*(torch.from_numpy(a) for a in
                                   (q, kp, vp, pt, kv_lens, q_lens))).numpy()
    for b in range(q.shape[0]):
        n = int(q_lens[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5,
                                   rtol=0)
        assert not got[b, n:].any()        # rows past q_len are zero


def test_cpu_tensor_takes_plain_path():
    arrs = [torch.from_numpy(a) for a in _inputs(0, 2, 4, 4, 4, 8, 8, 2)]
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(*arrs)
    assert ragged_paged_attention.launches == before   # no kernel launch
    assert out.device.type == "cpu" and out.dtype == torch.float32


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_ragged_twin_int8_matches_jax_reference(hq, hkv):
    """int8 pools with per-(slot, head) fp32 scales dequantize after the
    gather on both sides."""
    q, kp, vp, pt, kv_lens, q_lens = _inputs(hq + 7 * hkv, b=5, chunk=4,
                                             hq=hq, hkv=hkv, d=8, ps=8, pps=4)
    rng = np.random.RandomState(hq)
    kq, vq = (rng.randint(-127, 128, kp.shape).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.05, kp.shape[:3]).astype(np.float32)
              for _ in range(2))
    want = np.asarray(jax_ragged_reference(
        *(jnp.asarray(a) for a in (q, kq, vq, pt, kv_lens, q_lens)),
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
    got = ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, kq, vq, pt, kv_lens, q_lens)),
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs)).numpy()
    assert np.abs(want).max() > 1e-3
    for b in range(q.shape[0]):
        n = int(q_lens[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5,
                                   rtol=0)
        assert not got[b, n:].any()
    with pytest.raises(ValueError, match="together"):
        ragged_paged_attention(
            *(torch.from_numpy(a) for a in (q, kq, vq, pt, kv_lens, q_lens)),
            k_scales=torch.from_numpy(ks))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [32, 80, 96])
def test_ragged_twin_head_dims_match_jax_reference(d, quant):
    """The head dims of the reference's GPT configs that the kernel now
    takes (gpt3-tiny 32, gpt3-2.7b 80, gpt3-760m 96), fp and int8 pools."""
    q, kp, vp, pt, kv_lens, q_lens = _inputs(d + quant, b=5, chunk=4, hq=4,
                                             hkv=2, d=d, ps=8, pps=4)
    scales = {}
    if quant:
        rng = np.random.RandomState(d)
        kp, vp = (rng.randint(-127, 128, kp.shape).astype(np.int8)
                  for _ in range(2))
        scales = {name: rng.uniform(0.001, 0.05, kp.shape[:3]).astype(
            np.float32) for name in ("k_scales", "v_scales")}
    want = np.asarray(jax_ragged_reference(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, kv_lens, q_lens)),
        **{k: jnp.asarray(v) for k, v in scales.items()}))
    got = ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, pt, kv_lens, q_lens)),
        **{k: torch.from_numpy(v) for k, v in scales.items()}).numpy()
    for b in range(q.shape[0]):
        n = int(q_lens[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5,
                                   rtol=0)


# -- the kernel's split walk (csrc/paged_walk.cuh), written out in torch ----

KEYS = 32   # keys a tile of the walk (paged_walk.cuh kKeys)


def _tile_walk(qr, k, v, key0, lim, scale):
    """One split's online softmax over keys at positions ``key0 + j``, in
    tiles of KEYS: ``qr [R, d]``, ``k`` / ``v [n, d]`` fp32, row r sees keys
    below ``lim[r]``. Returns the split's (acc [R, d], m [R], l [R])."""
    R = qr.shape[0]
    acc = torch.zeros_like(qr)
    m = torch.full((R,), -1e30)
    l = torch.zeros(R)
    for t in range(0, k.shape[0], KEYS):
        s = (qr @ k[t:t + KEYS].T) * scale
        pos = key0 + t + torch.arange(s.shape[1])
        seen = pos[None] < lim[:, None]
        m_new = torch.maximum(m, torch.where(seen, s, -1e30).amax(1))
        p = torch.where(seen, torch.exp(s - m_new[:, None]), 0.0)
        alpha = torch.exp(m - m_new)
        rows = seen.any(1)
        acc = torch.where(rows[:, None], acc * alpha[:, None]
                          + p @ v[t:t + KEYS], acc)
        l = torch.where(rows, l * alpha + p.sum(1), l)
        m = torch.where(rows, m_new, m)
    return acc, m, l


def _merge(parts):
    """The last split's merge, in split order (None: a split past the
    context); rows that saw no key give zeros."""
    live = [p for p in parts if p is not None]
    mx = torch.stack([m for _, m, _ in live]).amax(0)
    acc, l = torch.zeros_like(live[0][0]), torch.zeros_like(mx)
    for a, m, ls in live:
        w = torch.where(ls > 0, torch.exp(m - mx), 0.0)
        acc, l = acc + a * w[:, None], l + ls * w
    return torch.where(l[:, None] > 0, acc / l.clamp_min(1e-30)[:, None], 0.0)


def split_walk_twin(q, kp, vp, pt, kv_lens, q_lens, pages, k_scales=None,
                    v_scales=None):
    """The ragged kernel's algorithm in torch: each (lane, kv head) pair's
    keys in splits of ``pages`` pages (the grid's split axis), each split
    an online softmax over tiles of KEYS keys with the per-row causal
    limit, the splits merged in order."""
    b, c, hq, d = q.shape
    num_pages, ps, hkv, _ = kp.shape
    group, pps = hq // hkv, pt.shape[1]
    scale = 1.0 / np.sqrt(d)
    splits = -(-pps // pages)
    out = torch.zeros(b, c, hq, d)
    for i in range(b):
        ql, kv = int(q_lens[i]), int(kv_lens[i])
        if ql == 0:
            continue
        ctx = min(kv, pps * ps)
        rows = torch.arange(ql * group)
        lim = torch.minimum(kv - ql + rows // group + 1, torch.tensor(kv))
        for h in range(hkv):
            qr = q[i, :ql, h * group:(h + 1) * group].reshape(-1, d).float()
            parts = []
            for z in range(splits):
                k0, k1 = z * pages * ps, min(ctx, (z + 1) * pages * ps)
                if k1 <= k0:
                    parts.append(None)
                    continue
                keys = torch.arange(k0, k1)
                page = pt[i, keys // ps].long().clamp(0, num_pages - 1)
                kk = kp[page, keys % ps, h].float()
                vv = vp[page, keys % ps, h].float()
                if k_scales is not None:
                    kk = kk * k_scales[page, keys % ps, h][:, None]
                    vv = vv * v_scales[page, keys % ps, h][:, None]
                parts.append(_tile_walk(qr, kk, vv, k0, lim, scale))
            out[i, :ql, h * group:(h + 1) * group] = _merge(parts).reshape(
                ql, group, d)
    return out


def _walk_inputs(seed, hq, hkv, d, ps, pps, kv_lens, q_lens, quant):
    rng = np.random.RandomState(seed)
    b, chunk = len(kv_lens), max(max(q_lens), 1)
    num_pages = b * pps + 2
    q = rng.standard_normal((b, chunk, hq, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
              for _ in range(2))
    scales = {}
    if quant:
        kp, vp = (rng.randint(-127, 128, kp.shape).astype(np.int8)
                  for _ in range(2))
        scales = {n: rng.uniform(0.001, 0.05, kp.shape[:3]).astype(np.float32)
                  for n in ("k_scales", "v_scales")}
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    kv_lens, q_lens = (np.asarray(a, np.int32) for a in (kv_lens, q_lens))
    for i in range(b):
        pt[i, (kv_lens[i] + ps - 1) // ps:] = -1
    return (q, kp, vp, pt, kv_lens, q_lens), scales


# lanes: idle (q_len 0, ctx 0), a first chunk (kv_len == q_len), a context
# ending mid-page, a decode row at a full table, a chunk whose causal limit
# crosses a split boundary, a lane past which every split is empty
WALK_LANES = ([0, 3, 21, 32, 17, 5], [0, 3, 4, 1, 4, 2])


@pytest.mark.parametrize("pages", [1, 2, 3, 4])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 8), (8, 2, 32), (4, 1, 80)])
def test_split_walk_twin_matches_jax_reference(hq, hkv, d, quant, pages):
    """The kernel's split-and-merge walk (any pages a split, in split
    order, empty splits, tiles of 32 keys) computes the jnp reference's
    function: fp32, 1e-5."""
    arrs, scales = _walk_inputs(pages * 7 + d, hq, hkv, d, 8, 4, *WALK_LANES,
                                quant)
    want = np.asarray(jax_ragged_reference(
        *(jnp.asarray(a) for a in arrs),
        **{k: jnp.asarray(v) for k, v in scales.items()}))
    got = split_walk_twin(*(torch.from_numpy(a) for a in arrs), pages,
                          **{k: torch.from_numpy(v)
                             for k, v in scales.items()}).numpy()
    q_lens = arrs[5]
    for i in range(len(q_lens)):
        n = int(q_lens[i])
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=1e-5,
                                   rtol=0)
        assert not got[i, n:].any()


def _covered(plan, pps):
    """How many splits cover each page of a pps-wide table."""
    seen = np.zeros(pps, int)
    for z in range(plan.splits):
        lo, hi = z * plan.pages, min((z + 1) * plan.pages, pps)
        assert lo < hi, f"split {z} covers no page"
        seen[lo:hi] += 1
    return seen


@pytest.mark.parametrize("kv_elt", [4, 2, 1])
@pytest.mark.parametrize("geom", [
    (8, 12, 16, 64, 64, 16),      # GPT-125M serving: b 8, 1024 tokens
    (8, 32, 32, 64, 64, 16),      # gpt3-1.3b, contexts to 2,048
    (8, 16, 16, 64, 96, 16),      # gpt3-760m
    (8, 32, 16, 64, 80, 16),      # gpt3-2.7b
    (1, 1, 4096, 16, 128, 512),   # one long lane, many query rows
    (5, 2, 9, 16, 128, 16),       # odd
    (3, 4, 1, 8, 32, 4)])         # a one-page table
def test_walk_plan_covers_fills_and_bounds_partials(geom, kv_elt):
    from paddle_tpu_torch.ops.paged_attention import PARTIAL_CAP, walk_plan
    b, heads, pps, ps, d, rows = geom
    plan = walk_plan(b, heads, pps, ps, d, rows, kv_elt, 132)
    assert (_covered(plan, pps) == 1).all()
    assert plan.blocks == b * heads * plan.splits
    assert plan.waves == pytest.approx(plan.blocks / 132)
    assert plan.partial_bytes <= PARTIAL_CAP
    assert (plan.partial_bytes == 0) == (plan.splits == 1)
    # a split walks one page at least
    assert 1 <= plan.pages and plan.splits <= max(pps, 1)
    # the same shapes give the same plan: nothing but shapes goes in
    assert walk_plan(b, heads, pps, ps, d, rows, kv_elt, 132) == plan


@pytest.mark.parametrize("kv_elt", [4, 2, 1])
def test_walk_plan_fills_the_card_at_a_decode_round(kv_elt):
    """A decode round (8 lanes, one query row, GPT-125M's 1,024-token
    table) fills at least one wave of the H100's 132 SMs, where one block a
    (lane, head) gave 96 blocks."""
    import inspect

    from paddle_tpu_torch.ops.paged_attention import walk_plan
    plan = walk_plan(8, 12, 1024 // 64, 64, 64, 16, kv_elt, 132)
    assert plan.splits > 1 and plan.waves >= 1
    assert all(p.annotation in (int, "int") for p in
               inspect.signature(walk_plan).parameters.values())
