"""The port's fp16 plain versions (twins) against the JAX package run in fp16
on the CPU, family by family and for a 2-layer fp16 GPT served end to end.

The same seeded numpy inputs, rounded to fp16, go through the reference's
jnp oracles (``ragged_paged_attention_reference``,
``paged_attention_reference``, ``quant_matmul_reference``,
``grouped_matmul_reference``, ``mega_attn_layer_reference`` /
``mega_mlp_reference`` under ``jax.jit``, ``ln_reference`` /
``gelu_reference``), the Pallas flash and fused-MLP kernels in interpret
mode (forward and ``jax.vjp``), and ``ServingPredictor(use_kernel=False,
async_engine=False, dtype=float16)``; no JAX output comes from a kernel
that cannot trace on this jax (``use_kernel=True`` of the quantized,
grouped and mega families). The port's twins are what its fp16 kernels are
held against on the card.

Tolerances, each a fraction of the compared tensor's (or row's) max
``|want|``:

- ``F16_ROW_TOL`` 2e-3 per row: both sides compute in fp32 and round the
  result to fp16 once, so an element may sit one fp16 step (2^-10 of it,
  9.8e-4) apart, plus fp32 summation-order noise;
- ``F16_FLASH_TOL`` 2e-3 per tensor: the Pallas kernel also rounds each key
  tile's ``p`` to fp16 before ``p v`` (the twin keeps fp32 ``p``), a
  further <= 2^-11 of each term (7.1e-4 measured);
- ``F16_GRAD_TOL`` 3e-3 per tensor for results that pass through two or
  more fp16 roundings on each side (the flash backward rounds ``p`` and
  ``ds``, its ``delta`` comes from the fp16 forward output; LN and GELU
  round the upstream gradient; the reference's op-by-op fp16 GELU rounds
  at every step), each a few fp16 steps (5.9e-4 measured).

Masks: a bool mask normalizes to ``-inf`` in fp16 (``-1e30`` overflows),
so a fully masked row and a length-0 key range must give zeros, no NaN,
on both sides.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.jit.api import _named_state
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import fused_mlp as jfm
from paddle_tpu.ops.pallas import grouped_matmul as jgmm
from paddle_tpu.ops.pallas import mega_decode as jmega
from paddle_tpu.ops.pallas import quant_matmul as jqm
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jflash
from paddle_tpu.ops.pallas.paged_attention import (
    paged_attention_reference as jax_decode_reference,
    ragged_paged_attention_reference as jax_ragged_reference)
from paddle_tpu.inference.quantize import quantize_weight as jquantize
from paddle_tpu_torch.inference import ServingPredictor
from paddle_tpu_torch.inference.quantize import quantize_weight
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import (random_state,
                                             serving_params_from_jax_numpy,
                                             state_from_jax_numpy)
from paddle_tpu_torch.ops import fused_mlp as tfm
from paddle_tpu_torch.ops import grouped_matmul as tgmm
from paddle_tpu_torch.ops import mega_decode as tmega
from paddle_tpu_torch.ops import quant_matmul as tqm
from paddle_tpu_torch.ops.flash_attention import flash_attention
from paddle_tpu_torch.ops.paged_attention import (paged_attention,
                                                  ragged_paged_attention)

F16_ROW_TOL = 2e-3
F16_FLASH_TOL = 2e-3
F16_GRAD_TOL = 3e-3
EPS = 1e-5


def _h(a):
    """numpy -> fp16 numpy (the inputs both sides get)."""
    return np.asarray(a, np.float32).astype(np.float16)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float32)


def _held(got, want, tol, rows=True, what=""):
    """``got`` within ``tol`` of ``want``'s max ``|value|`` per row (or over
    the tensor), with NaN and infinities at the same places."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    for test in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(test(got), test(want)), (what, test.__name__)
    fin = np.isfinite(want)
    diff = np.where(fin, np.abs(got - want), 0.0)
    mag = np.where(fin, np.abs(want), 0.0)
    if rows:
        diff = diff.reshape(-1, want.shape[-1]).max(-1)
        mag = mag.reshape(-1, want.shape[-1]).max(-1)
    else:
        diff, mag = diff.max(), mag.max()
    err = diff / np.maximum(mag, 1e-30)
    assert np.max(err) <= tol, (what, float(np.max(err)))


# ---- paged attention (rows 1 and 4) ----------------------------------------


def _pools(seed, b, chunk, hq, hkv, d, ps, pps):
    rng = np.random.RandomState(seed)
    num_pages = b * pps + 2
    q = rng.standard_normal((b, chunk, hq, d))
    kp = rng.standard_normal((num_pages, ps, hkv, d))
    vp = rng.standard_normal((num_pages, ps, hkv, d))
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    q_lens = np.array([0, 1, chunk, chunk // 2 + 1] * b, np.int32)[:b]
    kv_lens = np.maximum(rng.randint(1, pps * ps + 1, size=b), q_lens
                         ).astype(np.int32)
    for i in range(b):
        pt[i, (kv_lens[i] + ps - 1) // ps:] = -1
    return _h(q), _h(kp), _h(vp), pt, kv_lens, q_lens


@pytest.mark.parametrize("kv", ["fp16", "int8"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_ragged_fp16_matches_jax(kv, hq, hkv):
    q, kp, vp, pt, kv_lens, q_lens = _pools(hq + hkv, 5, 4, hq, hkv, 16, 8,
                                            4)
    scales = {}
    if kv == "int8":
        rng = np.random.RandomState(hq)
        kp, vp = (rng.randint(-127, 128, kp.shape).astype(np.int8)
                  for _ in range(2))
        scales = {n: rng.uniform(1e-3, 5e-2, kp.shape[:3]).astype(np.float32)
                  for n in ("k_scales", "v_scales")}
    want = jax_ragged_reference(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, kv_lens, q_lens)),
        **{n: jnp.asarray(s) for n, s in scales.items()})
    got = ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, pt, kv_lens, q_lens)),
        **{n: torch.from_numpy(s) for n, s in scales.items()})
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    for b in range(q.shape[0]):
        n = int(q_lens[b])
        if n:
            _held(got[b, :n], want[b, :n], F16_ROW_TOL, what=f"lane {b}")
        assert not got[b, n:].float().any()


def test_decode_fp16_matches_jax_with_an_empty_slot():
    q, kp, vp, pt, _, _ = _pools(3, 4, 1, 8, 2, 32, 8, 4)
    q = q[:, 0]
    lengths = np.array([0, 1, 17, 32], np.int32)
    want = jax_decode_reference(*(jnp.asarray(a) for a in
                                  (q, kp, vp, pt, lengths)))
    got = paged_attention(*(torch.from_numpy(a) for a in
                            (q, kp, vp, pt, lengths)))
    assert got.dtype == torch.float16
    assert not got[0].float().any() and not np.asarray(want[0]).any()
    _held(got[1:], want[1:], F16_ROW_TOL)


# ---- flash attention (rows 2 and 3) ----------------------------------------

B, S, H, D = 2, 128, 2, 64


def _qkv(seed, sq=S, sk=S):
    rng = np.random.RandomState(seed)
    return tuple(_h(rng.standard_normal(s)) for s in
                 ((B, sq, H, D), (B, sk, H, D), (B, sk, H, D), (B, sq, H, D)))


def _flash_pair(q, k, v, do, jfn, tfn):
    """Forward and ``jax.vjp`` of ``jfn`` against ``tfn`` and autograd."""
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want, vjp = jax.vjp(jfn, jq, jk, jv)
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tfn(tq, tk, tv)
    assert got.dtype == torch.float16
    got.backward(torch.from_numpy(do))
    _held(got, want, F16_FLASH_TOL, rows=False, what="out")
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          want_grads):
        assert g.dtype == torch.float16
        _held(g, w, F16_GRAD_TOL, rows=False, what=name)
    return got, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fp16_matches_jax_kernel(causal):
    q, k, v, do = _qkv(1 + causal)
    _flash_pair(q, k, v, do,
                lambda a, b_, c: jflash(a, b_, c, causal=causal),
                lambda a, b_, c: flash_attention(a, b_, c, causal=causal))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fp16_bool_mask_with_fully_masked_rows(causal):
    """A bool mask in fp16 is 0 / -inf on both sides: rows 3 and 70 of
    batch 0 see no key (zeros and no gradient), the rest see random
    holes; nothing is NaN."""
    q, k, v, do = _qkv(5)
    rng = np.random.RandomState(6)
    mask = rng.rand(B, 1, S, S) >= 0.2
    mask[0, 0, [3, 70]] = False
    out, grads = _flash_pair(
        q, k, v, do,
        lambda a, b_, c: jflash(a, b_, c, causal=causal,
                                mask=jnp.asarray(mask)),
        lambda a, b_, c: flash_attention(a, b_, c, causal=causal,
                                         mask=torch.from_numpy(mask)))
    assert not out[0, [3, 70]].float().any()
    assert not grads[0][0, [3, 70]].float().any()
    assert all(torch.isfinite(t).all() for t in (out, *grads))


def test_flash_fp16_lengths_with_an_empty_sequence():
    """Varlen in fp16: batch 0 has no query and no key (q_len = kv_len =
    0), batch 1 a causal q_len != kv_len: zeros past q_len, no NaN."""
    q, k, v, do = _qkv(7)
    q_lens, kv_lens = np.array([0, 100], np.int32), np.array([0, 77],
                                                             np.int32)
    out, grads = _flash_pair(
        q, k, v, do,
        lambda a, b_, c: jflash(a, b_, c, causal=True,
                                q_seqlens=jnp.asarray(q_lens),
                                kv_seqlens=jnp.asarray(kv_lens)),
        lambda a, b_, c: flash_attention(
            a, b_, c, causal=True, q_seqlens=torch.from_numpy(q_lens),
            kv_seqlens=torch.from_numpy(kv_lens)))
    assert not out[0].float().any() and not out[1, 100:].float().any()
    assert not grads[1][0].float().any() and not grads[2][0].float().any()
    assert all(torch.isfinite(t).all() for t in (out, *grads))


# ---- fused LN and GELU (rows 5-8) ------------------------------------------


def _check_vjp(jfn, tfn, arrays, cots):
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a).requires_grad_() for a in arrays]
    want, vjp = jax.vjp(jfn, *jx)
    got = tfn(*tx)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float16
        _held(g, w, F16_ROW_TOL, what=f"out {i}")
    want_grads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1
                     else jnp.asarray(cots[0]))
    got_grads = torch.autograd.grad(got, tx, [torch.from_numpy(c)
                                              for c in cots])
    for i, (g, w) in enumerate(zip(got_grads, want_grads)):
        assert g.dtype == torch.float16
        _held(g, w, F16_GRAD_TOL, rows=False, what=f"grad {i}")


def _n(rng, shape, scale=1.0):
    return _h(scale * rng.standard_normal(shape))


@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_fp16_matches_jax_kernel(residual):
    rng = np.random.RandomState(11 + residual)
    shape, h = (64, 256), 256
    x, r = _n(rng, shape), _n(rng, shape)
    g, b = _h(1 + 0.1 * rng.standard_normal(h)), _n(rng, (h,), 0.1)
    if residual:
        _check_vjp(lambda *a: jfm.fused_ln_residual(*a, EPS, True),
                   lambda *a: tfm.fused_ln_residual(*a, EPS),
                   (x, r, g, b), (_n(rng, shape), _n(rng, shape)))
    else:
        _check_vjp(lambda *a: jfm.fused_layer_norm(*a, EPS, True),
                   lambda *a: tfm.fused_layer_norm(*a, EPS),
                   (x, g, b), (_n(rng, shape),))
    # the oracle twin against the reference's ln_reference
    _held(tfm.ln_reference(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b)),
          jfm.ln_reference(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)),
          F16_ROW_TOL)


@pytest.mark.parametrize("bias", [False, True])
def test_gelu_fp16_matches_jax_kernel(bias):
    rng = np.random.RandomState(13 + bias)
    shape = (64, 256)
    x, b = _n(rng, shape, 3.0), _n(rng, (256,), 0.5)
    if bias:
        _check_vjp(lambda *a: jfm.fused_bias_gelu(*a, True),
                   lambda *a: tfm.fused_bias_gelu(*a), (x, b),
                   (_n(rng, shape),))
    else:
        _check_vjp(lambda a: jfm.fused_gelu(a, True),
                   lambda a: tfm.fused_gelu(a), (x,), (_n(rng, shape),))
    # the kernels' oracle (fp32 with one cast) against the reference's
    # op-by-op fp16 gelu_reference: each of its fp16 steps rounds
    want = jfm.gelu_reference(jnp.asarray(x), jnp.asarray(b) if bias
                              else None)
    got = tfm.gelu_fwd_reference(torch.from_numpy(x),
                                 torch.from_numpy(b) if bias else None)
    _held(got, want, F16_GRAD_TOL)


# ---- weight-only GEMM (rows 9-12) ------------------------------------------


def _quantized(rng, k, n, bits, group):
    w = _h(0.1 * rng.standard_normal((k, n)))
    qw = quantize_weight(torch.from_numpy(w), f"int{bits}", group)
    return qw["q"].numpy(), qw["s"].numpy()


@pytest.mark.parametrize("bits,group", [(8, -1), (8, 16), (4, -1), (4, 16)])
def test_quant_matmul_fp16_and_dx_match_jax(bits, group):
    rng = np.random.RandomState(17 + bits + group)
    k, n = 64, 48
    q, s = _quantized(rng, k, n, bits, group)
    x, dy = _n(rng, (2, 5, k)), _n(rng, (2, 5, n))
    bias = rng.standard_normal(n).astype(np.float32)
    want = jqm.quant_matmul_reference(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(s), bias=jnp.asarray(bias))
    jdx = jax.vjp(lambda x_: jqm.quant_matmul(x_, jnp.asarray(q),
                                              jnp.asarray(s),
                                              use_kernel=False),
                  jnp.asarray(x))[1](jnp.asarray(dy))[0]
    tx = torch.from_numpy(x).requires_grad_()
    got = tqm.quant_matmul(tx, torch.from_numpy(q), torch.from_numpy(s),
                           bias=torch.from_numpy(bias))
    assert got.dtype == torch.float16
    _held(got, want, F16_ROW_TOL, what="y")
    got.backward(torch.from_numpy(dy))
    assert tx.grad.dtype == torch.float16
    _held(tx.grad, jdx, F16_ROW_TOL, what="dx")


def test_quant_matmul_fp16_subnormal_scales_round_as_jax():
    """Scales below fp16's normal range (6.1e-5) round to fp16 subnormals
    before the product, on both sides, exactly as the reference's
    ``q * s`` in x's dtype."""
    rng = np.random.RandomState(19)
    q = rng.randint(-127, 128, (32, 16)).astype(np.int8)
    s = rng.uniform(1e-7, 5e-5, (1, 16)).astype(np.float32)
    got = tqm.dequantize_weight(torch.from_numpy(q), torch.from_numpy(s),
                                out_dtype=torch.float16)
    want = jqm.dequantize_weight(jnp.asarray(q), jnp.asarray(s),
                                 out_dtype=jnp.float16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    x = _n(rng, (3, 32))
    _held(tqm.quant_matmul(torch.from_numpy(x), torch.from_numpy(q),
                           torch.from_numpy(s)),
          jqm.quant_matmul_reference(jnp.asarray(x), jnp.asarray(q),
                                     jnp.asarray(s)), F16_ROW_TOL)


# ---- grouped GEMM (rows 15-19) ---------------------------------------------


@pytest.mark.parametrize("weights", ["fp", "int8", "int8g8", "int4g8"])
def test_grouped_matmul_fp16_and_dx_match_jax(weights):
    rng = np.random.RandomState(23)
    counts, k, n = [0, 5, 0, 1, 40, 3], 24, 40
    m, e = sum(counts), len(counts)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    x, dy = _n(rng, (m, k)), _n(rng, (m, n))
    w = _h(0.1 * rng.standard_normal((e, k, n)))
    if weights == "fp":
        tw, ts = torch.from_numpy(w), None
    else:
        bits, group = {"int8": ("int8", -1), "int8g8": ("int8", 8),
                       "int4g8": ("int4", 8)}[weights]
        qw = quantize_weight(torch.from_numpy(w), bits, group)
        tw, ts = qw["q"], qw["s"]
    jw = jnp.asarray(tw.numpy())
    js = None if ts is None else jnp.asarray(ts.numpy())
    want = jgmm.grouped_matmul_reference(jnp.asarray(x), jw,
                                         jnp.asarray(offs), scales=js)
    got = tgmm.grouped_matmul(torch.from_numpy(x), tw, torch.from_numpy(offs),
                              ts)
    assert got.dtype == torch.float16
    _held(got, want, F16_ROW_TOL, what="out")
    if weights in ("fp", "int8"):     # the reference's dx kernels
        jdx = jax.vjp(lambda x_: jgmm.grouped_matmul_reference(
            x_, jw, jnp.asarray(offs), scales=js), jnp.asarray(x))[1](
            jnp.asarray(dy))[0]
        tdx = tgmm.grouped_matmul_dx_reference(
            torch.from_numpy(dy), tw, torch.from_numpy(offs),
            None if ts is None else ts.reshape(e, -1, n), k, torch.float16)
        _held(tdx, jdx, F16_ROW_TOL, what="dx")


# ---- mega layer (rows 13 and 14) --------------------------------------------

MH, MHD, MF, PAGE = 32, 8, 64, 8


def _np_tree(tree, dtype=None):
    if isinstance(tree, dict):
        if "q" in tree:        # a quantized leaf: int8 payload, fp32 scales
            return {k: np.asarray(v) for k, v in tree.items()}
        return {k: _np_tree(v, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(dtype) if dtype is not None else a


def _mega_layer(rng, quant):
    def w(*s):
        return jnp.asarray(rng.randn(*s) * 0.05, jnp.float32)

    p = {"ln1_g": 1.0 + w(MH), "ln1_b": w(MH) * 0.1,
         "ln2_g": 1.0 + w(MH), "ln2_b": w(MH) * 0.1,
         "wqkv": w(MH, 3 * MH), "bqkv": w(3 * MH) * 0.1, "wo": w(MH, MH),
         "bo": w(MH) * 0.1, "w1": w(MH, MF), "b1": w(MF) * 0.1,
         "w2": w(MF, MH), "b2": w(MH) * 0.1}
    if quant:
        for k in ("wqkv", "wo", "w1", "w2"):
            p[k] = jquantize(p[k], "int8", group_size=16)
    tree = _np_tree(p, np.float16)
    return (jax.tree.map(jnp.asarray, tree),
            serving_params_from_jax_numpy(tree, device="cpu"))


def _mega_geometry(rng, kv_int8, b=5, chunk=4, pps=4):
    nh, num_pages = 4, b * pps + 2
    shape = (num_pages, PAGE, nh, MHD)
    if kv_int8:
        kp, vp = (rng.randint(-127, 128, shape).astype(np.int8)
                  for _ in range(2))
        ks, vs = ((np.abs(rng.randn(*shape[:3])) * 0.01 + 1e-3).astype(
            np.float32) for _ in range(2))
    else:
        kp, vp = _h(rng.randn(*shape)), _h(rng.randn(*shape))
        ks = vs = None
    ctx = np.array([13, 0, 5, 0, 11], np.int32)
    qlens = np.array([1, 0, chunk, chunk - 1, chunk // 2], np.int32)
    pt = np.full((b, pps), -1, np.int32)
    used = iter(rng.permutation(num_pages))
    for i in range(b):
        for j in range(-(-int(ctx[i] + qlens[i]) // PAGE) if qlens[i] else 0):
            pt[i, j] = next(used)
    return _h(rng.randn(b, chunk, MH)), (kp, vp, ks, vs), pt, ctx, qlens


def _opt(a, fn):
    return None if a is None else fn(a)


@pytest.mark.parametrize("quant,kv_int8", [(False, False), (True, True)])
def test_mega_layers_fp16_match_jax(quant, kv_int8):
    rng = np.random.RandomState(29 + quant)
    p_j, p_t = _mega_layer(rng, quant)
    xb, (kp, vp, ks, vs), pt, ctx, qlens = _mega_geometry(rng, kv_int8)
    want = jax.jit(functools.partial(jmega.mega_attn_layer_reference,
                                     eps=EPS))(
        jnp.asarray(xb), p_j, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(qlens),
        k_scales=_opt(ks, jnp.asarray), v_scales=_opt(vs, jnp.asarray))
    got = tmega.mega_attn_layer(
        torch.from_numpy(xb), p_t, torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(pt), torch.from_numpy(ctx),
        torch.from_numpy(qlens), eps=EPS,
        k_scales=_opt(ks, torch.from_numpy),
        v_scales=_opt(vs, torch.from_numpy))
    assert got[0].dtype == torch.float16
    valid = np.arange(xb.shape[1])[None] < qlens[:, None]
    # y2, s, k_new, v_new: fp16 rows (the int8 payloads, with kv_int8, sit
    # within one quantization step where fp16 K / V rows differ in the
    # last bit)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy()[valid], np.asarray(w)[valid]
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max(initial=0) <= 1
        else:
            _held(g, w, F16_ROW_TOL, what=f"out {i}")
    y2, sres = _h(rng.randn(9, MH)), _h(rng.randn(9, MH))
    want = jax.jit(jmega.mega_mlp_reference)(jnp.asarray(y2),
                                             jnp.asarray(sres), p_j)
    got = tmega.mega_mlp(torch.from_numpy(y2), torch.from_numpy(sres), p_t)
    assert got.dtype == torch.float16
    _held(got, want, F16_ROW_TOL, what="mlp")


# ---- a 2-layer fp16 GPT served end to end ----------------------------------

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=96, initializer_range=0.5)


def _churn():
    rng = np.random.RandomState(11)
    p0 = [int(x) for x in rng.randint(0, 97, 30)]
    return [p0, [int(x) for x in rng.randint(0, 97, 9)],
            [int(x) for x in rng.randint(0, 97, 17)], list(p0),
            p0[:20] + [int(x) for x in rng.randint(0, 97, 6)]]


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_fp16_predictor_matches_jax_sync_engine(kv_cache_dtype):
    named = random_state(tgpt.GPTConfig(**TINY), 3)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY))
    jm.eval()
    for name, t in _named_state(jm).items():
        t.set_value(named[name])
    tm = state_from_jax_numpy(named, tgpt.GPTConfig(**TINY), device="cpu")
    tm.eval()
    kw = dict(max_batch=3, page_size=8, chunk=8, num_pages=10,
              kv_cache_dtype=kv_cache_dtype)
    jsp = JaxPredictor(jm, use_kernel=False, async_engine=False,
                       dtype=jnp.float16, **kw)
    tsp = ServingPredictor(tm, device="cpu", dtype=torch.float16, **kw)
    assert tsp.params["tok_emb"].dtype == torch.float16
    want = jsp.generate(_churn(), max_new_tokens=10)
    got = tsp.generate(_churn(), max_new_tokens=10)
    assert all(want) and len({t for s in want for t in s}) > 3
    assert got == want
