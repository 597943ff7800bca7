"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: on a machine without CUDA every test skips with a reason
(decided inside the ``cuda`` fixture, never at import). On the card run

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_kernels.py -q

(``--noconftest``: the suite's conftest imports JAX, which a CUDA machine
need not have; this file imports only torch and the port.)

Tolerances: fp32 kernels sum in another order than the plain version and
use ``expf`` — ``atol 2e-5, rtol 1e-4`` on outputs of magnitude <= ~3.
The backward kernel's fp32 dq is summed with atomics across key blocks, in
an order that changes from run to run: its dq, dk and dv are held as the
max abs error over the tensor's max ``|want|``, to ``1e-5``. In bf16 both
sides round an fp32 result to 8 mantissa bits once, so an element may
differ by one bf16 step (<= 2^-7 of it): each row's (last axis) max abs
error is held to ``1e-2`` of the row's max ``|want|``. fp16 (10 mantissa
bits, one step <= 2^-10) is held the same way to ``2e-3``: about two
steps, where the flash forward kernels also round each key tile's ``p``
to fp16 (<= 2^-11 of each term) and the plain version does not. Every
dtype-parametrized test runs fp32, bf16 and fp16 (``DTYPES``). The dq row of a
query that sees one key is zero in exact arithmetic (``ds = p (dp -
delta)`` with ``p = 1`` and ``dp = delta``): both sides return fp32
rounding noise there (the bf16 tensor-core kernel sums ``dp`` in another
rounding than the plain GEMM and ``delta``), so such a row has no scale
of its own and is held as an fp32 gradient, its max abs error over the
tensor's max ``|want|``, to ``1e-5`` (``1e-4`` in fp16: ``ZERO_ROW_TOL``).
Whole-model
gradients (flash vs plain attention, fp32, TF32 off): each parameter's max
abs error over its max ``|grad|``, to ``1e-5`` (seen: <= 2e-6). The
weight-only GEMM splits its fp32 sums across blocks in another order than
cuBLAS: fp32 outputs and dx are held as the max abs error over the
tensor's max ``|want|``, to ``1e-5``; in bf16 both sides dequantize with
the same rounding and round one fp32 sum, held per row as above. The
fused LayerNorm and GELU kernels sum rows in another order than the plain
versions and use ``rsqrtf`` / GELU's sigmoid form (``ex2.approx`` and
``rcp.approx``, ~2 ulp): fp32 outputs, and the fp32 dgamma / dbeta / dbias
sums in both types, held as the max abs error over the tensor's max
``|want|``, to ``1e-5``; bf16 outputs per row as above. GELU inputs with
+-inf or NaN must give them at the same places; the finite entries are held
as above.
The mega kernels keep every rounding of their plain versions and sum in
another order (heads and ffn tiles in a fixed order, not cuBLAS's): fp32
outputs held as the max abs error over the tensor's max ``|want|``, to
``1e-5``, bf16 per row as above, on the rows each lane feeds; int8 K / V
payloads may sit one step apart where the fp32 row sits on a rounding
boundary, in under 1% of the entries, and their scales (absmax / 127 of
those rows) are held like the outputs; where a payload differs, what
attends it moves, and the fp32 outputs are then held to ``1e-3``.
The ragged grouped GEMM computes what the weight-only GEMM computes per
expert, and is held the same way (fp32 to ``1e-5`` of the tensor's max,
bf16 per row; its bf16 tensor-core kernels sum exact bf16 products in
another order and round once, as the plain version does); attention routed to
plain ``_sdpa_ref`` (fp32 head_dim 96, fp64) runs the same function as the
reference path on the same device and is held to ``atol/rtol 1e-6``. The paged
decode kernel is held like the ragged kernel (fp32 ``FP32_TOL``, bf16 per row),
against its plain version and against the ragged kernel at chunk 1 on the same
pools.
"""
import contextlib
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.convert import random_state, state_from_jax_numpy
from paddle_tpu_torch.models.gpt import GPT_CONFIGS
from paddle_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_reference)
from paddle_tpu_torch.inference.kv_cache import quantize_kv_rows
from paddle_tpu_torch.inference.quantize import quantize_weight
from paddle_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference, ragged_paged_attention,
    ragged_paged_attention_reference)
from paddle_tpu_torch.ops.fused_mlp import (
    MAX_H, fused_bias_gelu, fused_gelu, fused_layer_norm, fused_ln_residual,
    gelu_bwd, gelu_bwd_reference, gelu_fwd, gelu_fwd_reference, ln_bwd,
    ln_bwd_plan, ln_bwd_reference, ln_fwd, ln_fwd_reference)
from paddle_tpu_torch.ops.mega_decode import (
    mega_attn_layer, mega_attn_layer_reference, mega_mlp, mega_mlp_reference)
from paddle_tpu_torch.ops.quant_matmul import (
    quant_matmul, quant_matmul_bwd, quant_matmul_dx_reference,
    quant_matmul_fwd, quant_matmul_reference)
from paddle_tpu_torch.ops import quant_matmul as qmm_mod
from paddle_tpu_torch.ops.grouped_matmul import (
    grouped_matmul, grouped_matmul_bwd, grouped_matmul_dx_reference,
    grouped_matmul_fwd, grouped_matmul_reference)

pytestmark = pytest.mark.gpu

FP32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_ROW_TOL = 1e-2
FP16_ROW_TOL = 2e-3
ROW_TOL = {torch.bfloat16: BF16_ROW_TOL, torch.float16: FP16_ROW_TOL}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# idle host time after a profiler starts and before it stops: without it
# a trace can lose the records of the kernels launched just after the
# start (a short session's all; ``profile_margin.py``)
PROFILE_MARGIN_S = 0.2
BWD_FP32_TOL = 1e-5
# rows zero in exact arithmetic, over the tensor's max |want|: fp32 noise
# both sides. bf16's 16-bit products mostly sum exactly in fp32; fp16's
# 22-bit products are rounded by the fp32 sums of dp and delta, so the
# noise left is larger (seen 1.7e-5 on an H100): held to 1e-4 in fp16
ZERO_ROW_TOL = {torch.bfloat16: BWD_FP32_TOL, torch.float16: 1e-4}
GRAD_TOL = 1e-5
QMM_FP32_TOL = 1e-5


def _assert_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **FP32_TOL)
        return
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    worst = (diff / scale).max().item()
    assert worst <= ROW_TOL[dtype], (
        f"{dtype} row error {worst:.3e} of the row's max |want| > "
        f"{ROW_TOL[dtype]}")


def _assert_bwd_close(got, want, zero_rows=None):
    """A bf16 / fp16 gradient ``[b, s, h, d]``: rows per ``_assert_close``;
    the ``zero_rows`` (``[s]`` bool: dq of the queries that see one key) to
    ``ZERO_ROW_TOL`` of the tensor's max ``|want|``."""
    if zero_rows is None or not zero_rows.any():
        _assert_close(got, want, got.dtype)
        return
    zero = zero_rows.view(1, -1, 1).expand(got.shape[:-1])
    _assert_close(got[~zero], want[~zero], got.dtype)
    err = ((got[zero].float() - want[zero].float()).abs().max()
           / want.float().abs().max())
    assert err.item() <= ZERO_ROW_TOL[got.dtype], err.item()


def _one_key_rows(sq, sk, causal, device):
    """``[sq]`` bool: the queries that see exactly one key."""
    r = torch.arange(sq, device=device)
    seen = (r + sk - sq + 1).clamp(0, sk) if causal else torch.full_like(
        r, sk)
    return seen == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _ragged_inputs(rng, b, chunk, hq, hkv, d, ps, pps, device, dtype):
    num_pages = b * pps + 3
    q = rng.standard_normal((b, chunk, hq, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    perm = rng.permutation(num_pages)[:b * pps].reshape(b, pps)
    q_lens = np.array([0, 1, chunk, chunk // 2 + 1] * b, np.int32)[:b]
    kv_lens = rng.randint(chunk, pps * ps + 1, size=b).astype(np.int32)
    kv_lens[1] = pps * ps
    pt = perm.astype(np.int32)
    for i in range(b):        # entries past the context are unallocated
        pt[i, (kv_lens[i] + ps - 1) // ps:] = -1
    to = lambda a, dt: torch.from_numpy(a).to(device, dt)  # noqa: E731
    return (to(q, dtype), to(kp, dtype), to(vp, dtype),
            to(pt, torch.int32), to(kv_lens, torch.int32),
            to(q_lens, torch.int32))


def _valid_rows(out, q_lens):
    mask = (torch.arange(out.shape[1], device=out.device)[None]
            < q_lens[:, None].long())
    return out[mask]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", [(8, 16, 12, 12, 64, 64, 16),
                                  (4, 8, 8, 2, 128, 16, 12)])
def test_ragged_kernel_matches_plain(cuda, dtype, geom):
    b, chunk, hq, hkv, d, ps, pps = geom
    args = _ragged_inputs(np.random.RandomState(0), b, chunk, hq, hkv, d,
                          ps, pps, cuda, dtype)
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    want = ragged_paged_attention_reference(*args)
    q_lens = args[-1]
    _assert_close(_valid_rows(got, q_lens).float(),
                  _valid_rows(want, q_lens).float(), dtype)
    # idle lanes (q_len 0) and rows past q_len come back zero
    assert torch.count_nonzero(got[0]) == 0


def _check_flash_fwd(cuda, dtype, shape, seed):
    """The forward kernel on one ``(b, sq, sk, hq, hkv, d, causal)`` case:
    one launch, out and lse as its plain version's, rows that see no key
    zero."""
    b, sq, sk, hq, hkv, d, causal = shape
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype) for s in ((b, sq, hq, d), (b, sk, hkv, d),
                                          (b, sk, hkv, d)))
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want_out, want_lse = flash_attention_reference(q, k, v, causal=causal)
    _assert_close(out.float(), want_out.float(), dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    if causal and sq > sk:
        assert torch.count_nonzero(out[:, :sq - sk]) == 0


def _check_flash_bwd(cuda, dtype, shape, seed):
    """The backward kernel on one case, fed the plain forward's lse and
    delta: one launch, dq, dk, dv as its plain version's."""
    b, sq, sk, hq, hkv, d, causal = shape
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda, dtype) for s in
        ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d)))
    out, lse = flash_attention_reference(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    delta = delta.reshape(b * hq, 1, sq).contiguous()
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                         causal=causal)
    zero_rows = _one_key_rows(sq, sk, causal, cuda)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            err = (g - w).abs().max() / w.abs().max()
            assert err.item() <= BWD_FP32_TOL, err.item()
        else:
            _assert_bwd_close(g, w, zero_rows if g is got[0] else None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 512, 512, 12, 12, 64, True),
                                   (2, 200, 200, 8, 2, 64, True),
                                   (2, 64, 300, 4, 4, 128, True),
                                   (2, 300, 100, 4, 1, 64, True),
                                   (2, 130, 77, 6, 3, 64, False)])
def test_flash_kernel_matches_plain(cuda, dtype, shape):
    _check_flash_fwd(cuda, dtype, shape, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 1024, 1024, 12, 12, 128, True),
                                   (2, 128, 128, 4, 4, 64, True),
                                   (2, 128, 128, 4, 4, 64, False),
                                   (1, 128, 128, 4, 2, 64, True),
                                   (1, 128, 256, 2, 2, 64, True),
                                   (1, 256, 128, 2, 1, 128, True),
                                   (2, 333, 333, 6, 3, 64, True),
                                   (2, 130, 77, 6, 3, 128, False)])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, shape):
    _check_flash_bwd(cuda, dtype, shape, 2)


# bf16 and fp16 (fp32 is built for d 64 / 128): every head dim the
# reference's configs use, with sq < sk (causal offset) and GQA, ragged
# tails, rows that see no key (sq > sk causal), non-causal, GQA 8 with
# ragged tails on both sides, and one query row
TC_SHAPES = [(2, 200, 456, 12, 4, 32, True),
             (2, 333, 333, 8, 8, 80, True),
             (1, 300, 100, 6, 2, 96, True),
             (2, 130, 77, 4, 4, 96, False),
             (1, 257, 515, 16, 2, 128, True),
             (2, 64, 300, 4, 1, 80, False),
             (1, 1, 129, 4, 4, 64, True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_flash_tc_kernel_matches_plain_at_every_head_dim(cuda, shape, dtype):
    _check_flash_fwd(cuda, dtype, shape, 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_flash_tc_bwd_kernel_matches_plain_at_every_head_dim(cuda, shape,
                                                             dtype):
    _check_flash_bwd(cuda, dtype, shape, 5)


def test_eager_gpt_gradients_flash_vs_plain(cuda):
    """The eager GPT's backward through the flash kernels: every parameter
    gets the gradient plain attention gives it, and none is ``None``."""
    cfg = GPT_CONFIGS["gpt3-125m"]
    cfg = type(cfg)(**{**cfg.__dict__, "num_layers": 2})
    model = state_from_jax_numpy(random_state(cfg, 0), cfg, device=cuda)
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 257))).to(cuda)
    grads = {}
    for flash in (True, False):
        cfg.use_flash_attention = flash
        model.zero_grad(set_to_none=True)
        before = flash_attention_bwd.launches
        logits = model(ids[:, :-1]).float()
        torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size), ids[:, 1:].reshape(-1)
        ).backward()
        torch.cuda.synchronize()
        assert flash_attention_bwd.launches - before == (2 if flash else 0)
        grads[flash] = {n: p.grad for n, p in model.named_parameters()}
    for name, want in grads[False].items():
        got = grads[True][name]
        assert got is not None and want is not None, name
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= GRAD_TOL, (name, err.item())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", [(8, 16, 12, 12, 64, 64, 16),
                                  (4, 8, 8, 2, 128, 16, 12)])
def test_ragged_int8_kernel_matches_plain(cuda, dtype, geom):
    """The int8-KV branch: pages quantized by the KV write's formula,
    dequantized with their scales in the kernel's load loop."""
    b, chunk, hq, hkv, d, ps, pps = geom
    q, kp, vp, pt, kv_lens, q_lens = _ragged_inputs(
        np.random.RandomState(1), b, chunk, hq, hkv, d, ps, pps, cuda,
        torch.float32)
    (kq, ks), (vq, vs) = (quantize_kv_rows(t.reshape(-1, hkv, d))
                          for t in (kp, vp))
    kq, vq = kq.reshape(kp.shape), vq.reshape(vp.shape)
    ks, vs = ks.reshape(kp.shape[:3]), vs.reshape(vp.shape[:3])
    args = (q.to(dtype), kq, vq, pt, kv_lens, q_lens)
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    want = ragged_paged_attention_reference(*args, k_scales=ks, v_scales=vs)
    _assert_close(_valid_rows(got, q_lens).float(),
                  _valid_rows(want, q_lens).float(), dtype)
    assert torch.count_nonzero(got[0]) == 0


def _qmm_err(got, want, dtype):
    if dtype == torch.float32:
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err <= QMM_FP32_TOL, err
    else:
        _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(24, 768, 2304, 8, -1),
                                   (24, 768, 768, 8, 128),
                                   (24, 3072, 768, 4, 128),
                                   (24, 768, 3072, 4, -1),
                                   (5, 200, 130, 8, 40),
                                   (5, 200, 130, 4, 40),
                                   (70, 96, 64, 4, -1)])
def test_quant_matmul_kernels_match_plain(cuda, dtype, shape):
    """Forward and dx of the weight-only GEMM against their plain versions
    (the serving shapes, ragged tiles, groups that straddle k tiles, more
    than one tile of rows), with a grad_fn on every output whose input
    requires grad."""
    m, k, n, bits, gs = shape
    name = f"int{bits}"
    rng = np.random.RandomState(4)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    qw = quantize_weight((0.05 * w).to(dtype), name, gs)
    q, s = qw["q"].to(cuda), qw["s"].to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        cuda, dtype).requires_grad_()
    fwd0, bwd0 = quant_matmul_fwd.launches[name], quant_matmul_bwd.launches[name]
    y = quant_matmul(x, q, s)
    torch.cuda.synchronize()
    assert quant_matmul_fwd.launches[name] == fwd0 + 1
    assert y.grad_fn is not None and y.dtype == dtype
    _qmm_err(y.detach().float(), quant_matmul_reference(x.detach(), q, s
                                                        ).float(), dtype)
    dy = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(
        cuda, dtype)
    y.backward(dy)
    torch.cuda.synchronize()
    assert quant_matmul_bwd.launches[name] == bwd0 + 1
    _qmm_err(x.grad.float(),
             quant_matmul_dx_reference(dy, q, s, k, dtype).float(), dtype)


def test_quant_matmul_bias_and_grad_wiring(cuda):
    """A bias adds in fp32 before the cast and gets its row-sum gradient;
    the weight and scales get none; an input without grad gives an output
    without grad_fn."""
    rng = np.random.RandomState(6)
    qw = quantize_weight(torch.from_numpy(
        0.05 * rng.standard_normal((256, 96)).astype(np.float32)), "int8",
        64)
    q, s = qw["q"].to(cuda), qw["s"].to(cuda).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((3, 7, 256)).astype(
        np.float32)).to(cuda).requires_grad_()
    b = torch.from_numpy(rng.standard_normal(96).astype(np.float32)).to(
        cuda).requires_grad_()
    y = quant_matmul(x, q, s, bias=b)
    want = quant_matmul_reference(x.detach(), q, s.detach(), bias=b.detach())
    _qmm_err(y.detach(), want, torch.float32)
    y.sum().backward()
    assert x.grad is not None and s.grad is None
    torch.testing.assert_close(b.grad, torch.full_like(b, 21.0))
    assert quant_matmul(x.detach(), q, s.detach()).grad_fn is None


def _fused_err(got, want, dtype):
    """fp32 tensors (and every fp32 parameter sum) to 1e-5 of their max;
    bf16 rows to 1e-2 of each row's max."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err <= QMM_FP32_TOL, err
    else:
        _assert_close(got, want, dtype)


def _rand(rng, shape, cuda, dtype, scale=1.0):
    return (scale * torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32))).to(cuda, dtype)


def _bits(t):
    """``t``'s bits as integers, so equal NaNs compare equal."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _offset(t):
    """``t`` copied one element past a 16-byte boundary (the kernels'
    element-by-element path)."""
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    flat[1:] = t.reshape(-1)
    out = flat[1:].view(t.shape)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,inputs", [
    ((8192, 1536), "normal"), ((2048, 768), "normal"), ((77, 200), "normal"),
    ((9, 1001), "normal"), ((16, MAX_H), "normal"), ((1, 1536), "normal"),
    ((3, 768), "normal"), ((8191, 1536), "short band"),
    ((2048, 768), "offset")])
@pytest.mark.parametrize("res", [False, True])
def test_ln_kernels_match_plain(cuda, dtype, shape, inputs, res):
    """LN forward (with and without the residual) and backward (with and
    without ``dso``) against their plain versions: the flagship and GPT-125M
    shapes, a ragged row, a width that takes no 16-byte vectors, the widest
    row, one and three rows (fewer than the backward's blocks), a row count
    whose last band is short (8191 is prime), and inputs one element off
    the 16-byte grid; a second backward launch is bitwise equal to the
    first."""
    rows, h = shape
    rng = np.random.RandomState(8)
    x, r, dy, dso = (_rand(rng, shape, cuda, dtype) for _ in range(4))
    if inputs == "offset":
        x, r, dy, dso = (_offset(t) for t in (x, r, dy, dso))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = ln_bwd_plan(rows, h, x.element_size(), sms)
    assert plan.blocks <= min(rows, sms)
    if inputs == "short band":
        assert plan.blocks * plan.band > rows
    g = 1 + _rand(rng, (h,), cuda, dtype, 0.1)
    b = _rand(rng, (h,), cuda, dtype, 0.1)
    resid = r if res else None
    f0, b0 = ln_fwd.launches, ln_bwd.launches
    got = ln_fwd(x, resid, g, b, 1e-5)
    torch.cuda.synchronize()
    assert ln_fwd.launches == f0 + 1
    want = ln_fwd_reference(x, resid, g, b, 1e-5)
    _fused_err(got[0], want[0], dtype)
    if res:   # one rounding of the same fp32 sum
        assert torch.equal(got[1], want[1])
    for g_, w_ in zip(got[-2:], want[-2:]):
        _fused_err(g_, w_, torch.float32)
    s = got[1] if res else x
    mean, rstd = got[-2:]
    d_so = dso if res else None
    dgot = ln_bwd(dy, d_so, s, mean, rstd, g)
    torch.cuda.synchronize()
    assert ln_bwd.launches == b0 + 1
    dwant = ln_bwd_reference(dy, d_so, s, mean, rstd, g)
    for g_, w_ in zip(dgot, dwant):
        _fused_err(g_, w_, dtype)
    again = ln_bwd(dy, d_so, s, mean, rstd, g)
    torch.cuda.synchronize()
    for a, b in zip(dgot, again):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("has_dso", [False, True])
def test_ln_bwd_is_one_kernel_and_leaves_counters_zero(cuda, dtype,
                                                       has_dso):
    """One ``ln_bwd`` call at the flagship shape is exactly one CUDA kernel
    under ``torch.profiler`` (dgamma and dbeta are summed inside it), and
    its arrival counters are zero after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import _build

    rng = np.random.RandomState(12)
    shape = (8192, 1536)
    x, dy, dso = (_rand(rng, shape, cuda, dtype) for _ in range(3))
    g = 1 + _rand(rng, (shape[1],), cuda, dtype, 0.1)
    _, mean, rstd = ln_fwd_reference(x, None, g, g, 1e-5)
    args = (dy, dso if has_dso else None, x, mean, rstd, g)
    ln_bwd(*args)      # builds the library and grows the kept buffers
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        ln_bwd(*args)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    kernels = [ev.name() for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == DeviceType.CUDA]
    assert len(kernels) == 1 and "ln_bwd_kernel" in kernels[0], kernels
    plan = ln_bwd_plan(*shape, x.element_size(),
                       torch.cuda.get_device_properties(cuda)
                       .multi_processor_count)
    assert int(_build.kept(cuda, "ln_bwd", plan.sets + 1)
               [:plan.sets + 1].abs().sum()) == 0


def _gelu_inputs(rng, shape, cuda, dtype, inputs):
    """``x [rows, n]`` as the kernels get it: ``"normal"`` N(0, 2);
    ``"extreme"`` uniform in +-30 with +-1e4, +-inf and NaN in every row;
    ``"offset"`` N(0, 2) one element past a 16-byte boundary (the scalar
    path)."""
    rows, n = shape
    if inputs == "extreme":
        u = rng.uniform(-30, 30, shape).astype(np.float32)
        special = np.array([1e4, -1e4, np.inf, -np.inf, np.nan], np.float32)
        for r in range(rows):
            u[r, rng.choice(n, special.size, replace=False)] = special
        return torch.from_numpy(u).to(cuda, dtype)
    x = _rand(rng, shape, cuda, dtype, 2.0)
    if inputs == "offset":
        flat = torch.empty(rows * n + 1, device=cuda, dtype=dtype)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(rows, n)
        assert x.data_ptr() % 16 != 0
    return x


def _gelu_held(got, want, dtype):
    """``_fused_err`` over the finite entries; NaN, +inf and -inf must sit
    at the same places on both sides."""
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want)), test
    fin = torch.isfinite(want)
    _fused_err(torch.where(fin, got, 0), torch.where(fin, want, 0), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,inputs", [
    ((8192, 6144), "normal"), ((2048, 3072), "normal"), ((77, 200), "normal"),
    ((9, 1001), "normal"), ((1, 6144), "normal"), ((64, 8), "normal"),
    ((33, 6152), "normal"), ((2048, 3072), "extreme"),
    ((77, 200), "extreme"), ((33, 6152), "offset"), ((9, 1001), "offset")])
@pytest.mark.parametrize("has_bias", [False, True])
def test_gelu_kernels_match_plain(cuda, dtype, shape, inputs, has_bias):
    """GELU forward and backward against their plain versions: the
    flagship and GPT-125M shapes, ragged rows and widths, one row, a row of
    one 16-byte chunk, a width one chunk past the flagship's, +-30 / +-1e4
    / +-inf / NaN inputs, a pointer off the 16-byte grid; a second launch
    is bitwise equal to the first."""
    rows, n = shape
    rng = np.random.RandomState(9)
    x = _gelu_inputs(rng, shape, cuda, dtype, inputs)
    dy = _rand(rng, shape, cuda, dtype)
    bias = _rand(rng, (n,), cuda, dtype, 0.5) if has_bias else None
    f0, b0 = gelu_fwd.launches, gelu_bwd.launches
    y = gelu_fwd(x, bias)
    torch.cuda.synchronize()
    assert gelu_fwd.launches == f0 + 1
    _gelu_held(y, gelu_fwd_reference(x, bias), dtype)
    dx, db = gelu_bwd(dy, x, bias)
    torch.cuda.synchronize()
    assert gelu_bwd.launches == b0 + 1
    want_dx, want_db = gelu_bwd_reference(dy, x, bias)
    _gelu_held(dx, want_dx, dtype)
    assert (db is None) == (not has_bias)
    if has_bias:
        _gelu_held(db, want_db, torch.float32)
    dx2, db2 = gelu_bwd(dy, x, bias)
    y2 = gelu_fwd(x, bias)
    torch.cuda.synchronize()
    for a, b in ((y, y2), (dx, dx2), (db, db2)):
        assert (a is None and b is None) or torch.equal(
            a.view(torch.int16 if a.element_size() == 2 else torch.int32),
            b.view(torch.int16 if b.element_size() == 2 else torch.int32))


def test_fused_ops_grad_wiring(cuda):
    """Every custom op's output has a grad_fn when an input requires grad,
    and its backward launches the backward kernel; the parameters get
    gradients in their own dtype; widths past the kernels' maximum
    raise."""
    rng = np.random.RandomState(10)
    x = _rand(rng, (3, 7, 64), cuda, torch.bfloat16).requires_grad_()
    r = _rand(rng, (3, 7, 64), cuda, torch.bfloat16).requires_grad_()
    g = (1 + _rand(rng, (64,), cuda, torch.bfloat16, 0.1)).requires_grad_()
    b = _rand(rng, (64,), cuda, torch.bfloat16, 0.1).requires_grad_()
    counts = lambda: (ln_fwd.launches, ln_bwd.launches,  # noqa: E731
                      gelu_fwd.launches, gelu_bwd.launches)
    c0 = counts()
    y1 = fused_layer_norm(x, g, b)
    y2, s = fused_ln_residual(x, r, g, b)
    z1 = fused_gelu(x)
    z2 = fused_bias_gelu(x, b)
    for t in (y1, y2, s, z1, z2):
        assert t.grad_fn is not None and t.dtype == torch.bfloat16
    (y1.float().sum() + (y2.float() * s.float()).sum() + z1.float().sum()
     + z2.float().sum()).backward()
    torch.cuda.synchronize()
    assert [n - m for n, m in zip(counts(), c0)] == [2, 2, 2, 2]
    for t in (x, r, g, b):
        assert t.grad is not None and t.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match=str(MAX_H)):
        ln_fwd(torch.zeros(2, MAX_H + 8, device=cuda), None,
               torch.ones(MAX_H + 8, device=cuda),
               torch.zeros(MAX_H + 8, device=cuda), 1e-5)


def test_eager_gpt_gradients_fused_vs_unfused(cuda):
    """The eager GPT with ``fused_mlp``: the same logits and every
    parameter's gradient as the unfused block (fp32), none ``None``, with
    two LN and one GELU launch a layer each way."""
    base = GPT_CONFIGS["gpt3-125m"]
    grads, logits = {}, {}
    ids = torch.from_numpy(np.random.RandomState(11).randint(
        0, base.vocab_size, (2, 129))).to(cuda)
    for fused in (True, False):
        cfg = type(base)(**{**base.__dict__, "num_layers": 2,
                            "fused_mlp": fused})
        model = state_from_jax_numpy(random_state(cfg, 0), cfg, device=cuda)
        c0 = (ln_fwd.launches, ln_bwd.launches, gelu_fwd.launches,
              gelu_bwd.launches)
        out = model(ids[:, :-1]).float()
        torch.nn.functional.cross_entropy(
            out.reshape(-1, cfg.vocab_size), ids[:, 1:].reshape(-1)
        ).backward()
        torch.cuda.synchronize()
        n = [a - b for a, b in zip((ln_fwd.launches, ln_bwd.launches,
                                    gelu_fwd.launches, gelu_bwd.launches),
                                   c0)]
        assert n == ([4, 4, 2, 2] if fused else [0, 0, 0, 0])
        logits[fused] = out.detach()
        grads[fused] = {k: p.grad for k, p in model.named_parameters()}
    err = ((logits[True] - logits[False]).abs().max()
           / logits[False].abs().max()).item()
    assert err <= GRAD_TOL, err
    for name, want in grads[False].items():
        got = grads[True][name]
        assert got is not None and want is not None, name
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= GRAD_TOL, (name, err.item())


# fp32 outputs of the mega attention kernel where an int8 K / V payload
# landed one step (1/127 of its row's absmax) from the plain version's
MEGA_KV_TOL = 1e-3
MEGA_GEOMS = {   # b, chunk, h, heads, head_dim, page, pages a lane, ffn
    "serving": (8, 16, 768, 12, 64, 64, 16, 3072),
    "odd": (5, 3, 256, 4, 64, 16, 6, 640),
    "d128": (3, 40, 512, 4, 128, 32, 5, 1024),
    # the head dims the split-walk kernel added: gpt3-tiny's 32, gpt3-2.7b's
    # 80 and gpt3-760m's 96 (its 16 heads, h 1536)
    "d32": (5, 4, 128, 4, 32, 16, 6, 512),
    "d80": (5, 3, 320, 4, 80, 16, 6, 640),
    "d96": (4, 16, 1536, 16, 96, 64, 4, 6144),
}


def _mega_inputs(geom, weights, group, kv_quant, dtype, device, seed=0):
    """One layer's lane blocks, weights and pools: lane 0 idle, lane 1 a
    first chunk (ctx 0), lane 2 a full chunk, the rest decode rows or
    ragged chunks over contexts that end mid-page."""
    b, chunk, h, nh, d, ps, pps, f = MEGA_GEOMS[geom]
    rng = np.random.RandomState(seed)
    hq = nh * d
    to = lambda a, dt=dtype: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(device, dt)
    p = {"ln1_g": to(1 + 0.1 * rng.randn(h)), "ln1_b": to(0.1 * rng.randn(h)),
         "ln2_g": to(1 + 0.1 * rng.randn(h)), "ln2_b": to(0.1 * rng.randn(h)),
         "bqkv": to(0.1 * rng.randn(3 * hq)), "bo": to(0.1 * rng.randn(h)),
         "b1": to(0.1 * rng.randn(f)), "b2": to(0.1 * rng.randn(h))}
    for name, (k, n) in (("wqkv", (h, 3 * hq)), ("wo", (hq, h)),
                         ("w1", (h, f)), ("w2", (f, h))):
        w = to(rng.randn(k, n) / np.sqrt(k), torch.float32)
        p[name] = (quantize_weight(w, "int8", group) if weights == "int8"
                   else w.to(dtype))
    num_pages = b * pps + 2
    ctx = np.minimum(rng.randint(1, pps * ps - chunk, b), pps * ps - chunk)
    ctx[:2] = 0
    qlens = rng.randint(1, chunk + 1, b)
    qlens[0], qlens[2] = 0, chunk
    qlens[3:] = np.where(np.arange(3, b) % 2, 1, qlens[3:])
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps)
    for i in range(b):
        pt[i, (ctx[i] + qlens[i] + ps - 1) // ps:] = -1
    kp, vp = (rng.randn(num_pages, ps, nh, d) for _ in range(2))
    pools = dict(k_pages=to(kp), v_pages=to(vp))
    if kv_quant:
        (kq, ks), (vq, vs) = (quantize_kv_rows(to(t, torch.float32))
                              for t in (kp, vp))
        pools = dict(k_pages=kq, v_pages=vq, k_scales=ks, v_scales=vs)
    ints = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.int32)).to(device)
    return (to(rng.randn(b, chunk, h)), p, pools, ints(pt), ints(ctx),
            ints(qlens))


def _mega_close(got, want, dtype, q_lens, fp32_tol=QMM_FP32_TOL):
    """Outputs on the rows each lane feeds: int8 payloads by steps (returns
    how many differ), the rest by the module docstring's tolerances."""
    g, w = _valid_rows(got, q_lens), _valid_rows(want, q_lens)
    if got.dtype == torch.int8:
        diff = (g.int() - w.int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).float().mean() < 0.01
        return int((diff > 0).sum())
    if dtype == torch.float32:
        err = ((g - w).abs().max() / w.abs().max()).item()
        assert err <= fp32_tol, err
    else:
        _assert_close(g.float(), w.float(), dtype)
    return 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", sorted(MEGA_GEOMS))
@pytest.mark.parametrize("weights,group,kv_quant", [
    ("fp", -1, False), ("int8", -1, False), ("int8", 64, True),
    ("fp", -1, True)])
def test_mega_attn_kernel_matches_plain(cuda, dtype, geom, weights, group,
                                        kv_quant):
    xb, p, pools, pt, ctx, q_lens = _mega_inputs(geom, weights, group,
                                                 kv_quant, dtype, cuda)
    for fuse in (True, False):
        args = (xb, p, pools["k_pages"], pools["v_pages"], pt, ctx, q_lens)
        kw = dict(k_scales=pools.get("k_scales"),
                  v_scales=pools.get("v_scales"), fuse_epilogue=fuse)
        before = mega_attn_layer.launches
        got = mega_attn_layer(*args, **kw)
        torch.cuda.synchronize()
        assert mega_attn_layer.launches == before + 1
        want = mega_attn_layer_reference(*args, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
        # a payload one step apart moves what attends it: the fp32 outputs
        # are held to 1e-5 when every payload agrees, else to MEGA_KV_TOL
        n_out = 2 if fuse else 1
        flips = sum(_mega_close(g, w, dtype, q_lens)
                    for g, w in zip(got[n_out:], want[n_out:])
                    if g.dtype == torch.int8)
        for g, w in zip(got[:n_out] + got[n_out + 2:],
                        want[:n_out] + want[n_out + 2:]):
            _mega_close(g, w, dtype, q_lens,
                        fp32_tol=MEGA_KV_TOL if flips else QMM_FP32_TOL)
        assert torch.count_nonzero(got[0][0]) == 0     # the idle lane


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", ["odd", "d128"])
def test_mega_attn_kernel_head_major(cuda, dtype, geom):
    """wqkv's columns in the head-major ``[nh, 3, hd]`` order (the
    tensor-parallel layout), int8 weights and KV, both epilogues."""
    xb, p, pools, pt, ctx, q_lens = _mega_inputs(geom, "int8", 64, True,
                                                 dtype, cuda, seed=5)
    args = (xb, p, pools["k_pages"], pools["v_pages"], pt, ctx, q_lens)
    for fuse in (True, False):
        kw = dict(k_scales=pools["k_scales"], v_scales=pools["v_scales"],
                  head_major=True, fuse_epilogue=fuse)
        got = mega_attn_layer(*args, **kw)
        torch.cuda.synchronize()
        want = mega_attn_layer_reference(*args, **kw)
        n_out = 2 if fuse else 1
        flips = sum(_mega_close(g, w, dtype, q_lens)
                    for g, w in zip(got[n_out:n_out + 2],
                                    want[n_out:n_out + 2]))
        for g, w in zip(got[:n_out] + got[n_out + 2:],
                        want[:n_out] + want[n_out + 2:]):
            _mega_close(g, w, dtype, q_lens,
                        fp32_tol=MEGA_KV_TOL if flips else QMM_FP32_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(128, 768, 3072, 128), (15, 200, 640, 40),
                                   (15, 192, 640, 32)])
@pytest.mark.parametrize("weights", ["fp", "int8"])
def test_mega_mlp_kernel_matches_plain(cuda, dtype, shape, weights):
    t, h, f, group = shape
    rng = np.random.RandomState(3)
    to = lambda a, dt=dtype: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(cuda, dt)
    p = {"b1": to(0.1 * rng.randn(f)), "b2": to(0.1 * rng.randn(h))}
    for name, (k, n) in (("w1", (h, f)), ("w2", (f, h))):
        w = to(rng.randn(k, n) / np.sqrt(k), torch.float32)
        p[name] = (quantize_weight(w, "int8", group) if weights == "int8"
                   else w.to(dtype))
    y2, s_res = to(rng.randn(t, h)), to(rng.randn(t, h))
    for fuse in (True, False):
        before = mega_mlp.launches
        got = mega_mlp(y2, s_res if fuse else None, p, fuse_epilogue=fuse)
        torch.cuda.synchronize()
        assert mega_mlp.launches == before + 1
        want = mega_mlp_reference(y2, s_res, p, fuse_epilogue=fuse)
        _mega_close(got[None], want[None], dtype,
                    torch.full((1,), t, device=cuda))


# (lanes, chunk, h, ffn, q_lens or None, int8 group): GPT-125M's served
# round (24 live rows of 128), its decode round (8 of 128), the dense block
# (no q_lens), an odd block (5 lanes of 3, an idle lane: 9 live rows), a
# wide one (more than 64 live rows: two passes), and widths off the
# kernel's tiles and stages (h 200, ffn 600) with groups of 40 rows
MLP_LIVE_CASES = {
    "served": (8, 16, 768, 3072, [16, 2, 1, 1, 1, 1, 1, 1], 128),
    "decode": (8, 16, 768, 3072, [1] * 8, 128),
    "dense": (8, 16, 768, 3072, None, 128),
    "odd": (5, 3, 256, 640, [0, 3, 2, 1, 3], 64),
    "wide": (12, 16, 256, 640, [16, 16, 16, 16, 16, 9, 0, 1, 16, 2, 3, 4],
             32),
    "edge": (5, 3, 200, 600, [0, 3, 2, 1, 3], 40),
}


def _mlp_live_inputs(case, weights, dtype, device, seed=3):
    b, chunk, h, f, ql, group = MLP_LIVE_CASES[case]
    rng = np.random.RandomState(seed)
    to = lambda a, dt=dtype: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(device, dt)
    p = {"b1": to(0.1 * rng.randn(f)), "b2": to(0.1 * rng.randn(h))}
    for name, (k, n) in (("w1", (h, f)), ("w2", (f, h))):
        w = to(rng.randn(k, n) / np.sqrt(k), torch.float32)
        p[name] = (quantize_weight(w, "int8", group if weights == "int8g"
                                   else -1) if weights != "fp"
                   else w.to(dtype))
    y2, s_res = to(rng.randn(b * chunk, h)), to(rng.randn(b * chunk, h))
    q_lens = None if ql is None else torch.tensor(ql, dtype=torch.int32,
                                                  device=device)
    return y2, s_res, p, q_lens, chunk


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(MLP_LIVE_CASES))
@pytest.mark.parametrize("weights", ["fp", "int8", "int8g"])
def test_mega_mlp_live_rows_repeat_and_graph(cuda, dtype, case, weights):
    """The mega MLP kernel on the rows each lane feeds (zeros elsewhere)
    against its plain version, both epilogues, one launch each; a second
    launch bitwise equal; a captured call bitwise equal to an eager one."""
    y2, s_res, p, q_lens, chunk = _mlp_live_inputs(case, weights, dtype,
                                                   cuda)
    for fuse in (True, False):
        kw = dict(fuse_epilogue=fuse, q_lens=q_lens, chunk=chunk)
        before = mega_mlp.launches
        got = mega_mlp(y2, s_res if fuse else None, p, **kw)
        again = mega_mlp(y2, s_res if fuse else None, p, **kw)
        torch.cuda.synchronize()
        assert mega_mlp.launches == before + 2
        assert torch.equal(got, again)
        want = mega_mlp_reference(y2, s_res, p, **kw)
        _mega_close(got[None], want[None], dtype,
                    torch.full((1,), got.shape[0], device=cuda))
    _graph_equal(lambda: mega_mlp(y2, s_res, p, q_lens=q_lens, chunk=chunk))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mega_mlp_unaligned_inputs(cuda, dtype):
    """Inputs that do not start on 16 bytes (each a view one element into
    its buffer) give the same result as aligned copies, bitwise, at widths
    off the kernel's tiles."""
    y2, s_res, p, q_lens, chunk = _mlp_live_inputs("edge", "int8g", dtype,
                                                   cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        return view

    moved = {k: ({"q": shifted(v["q"]), "s": shifted(v["s"])}
                 if isinstance(v, dict) else shifted(v))
             for k, v in p.items()}
    kw = dict(q_lens=q_lens, chunk=chunk)
    got = mega_mlp(shifted(y2), shifted(s_res), moved, **kw)
    want = mega_mlp(y2, s_res, p, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# (M, K, N, int8 group): GPT-125M's four serving GEMMs at the token budget,
# a decode round (8 tokens), one token, the route's widest M, and an odd M
QMM_TC_CASES = [(24, 768, 2304, -1), (24, 768, 768, 128),
                (24, 768, 3072, 128), (24, 3072, 768, -1), (8, 768, 2304, 64),
                (1, 768, 768, -1), (64, 3072, 768, 128), (37, 512, 336, 32)]


@pytest.mark.parametrize("weights", ["int8", "int4 g128", "int4"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", QMM_TC_CASES)
def test_quant_matmul_tc_route_matches_plain(cuda, dtype, case, weights):
    """The int8 forward (the case's group) and the packed int4 forward (in
    groups of 128 and per channel) at M <= 64 on aligned widths run the
    tensor-core route in bf16 (one ``tc_launches`` a call; fp32 the
    CUDA-core kernel) and match their plain version, with the bias; a
    second launch is bitwise equal, a captured call equal to an eager
    one."""
    m, k, n, gs = case
    name = weights.split()[0]
    if name == "int4":
        gs = 128 if "g128" in weights else -1
    rng = np.random.RandomState(8)
    qw = quantize_weight(torch.from_numpy(0.05 * rng.standard_normal(
        (k, n)).astype(np.float32)).to(dtype), name, gs)
    q, s = qw["q"].to(cuda), qw["s"].to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        cuda, dtype)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        cuda)
    plan = qmm_mod.qmm_plan(m, k, n, s.reshape(-1, n).shape[0], dtype,
                            name == "int4", False, True, 132)
    tc = dtype != torch.float32
    assert plan.route == ("tc" if tc else "cc")
    before = quant_matmul_fwd.tc_launches
    got = quant_matmul_fwd(x, q, s.reshape(-1, n), bias)
    again = quant_matmul_fwd(x, q, s.reshape(-1, n), bias)
    torch.cuda.synchronize()
    assert quant_matmul_fwd.tc_launches == before + 2 * tc
    assert torch.equal(got, again)
    _qmm_err(got.float(), quant_matmul_reference(x, q, s, bias=bias).float(),
             dtype)
    _graph_equal(lambda: quant_matmul_fwd(x, q, s.reshape(-1, n), bias))


@pytest.mark.parametrize("weights", ["int8", "int4 g128", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", QMM_TC_CASES + [(65, 768, 768, -1),
                                                 (256, 768, 2304, 128)])
def test_quant_matmul_dx_tc_route_matches_plain(cuda, dtype, case, weights):
    """The 16-bit int8 dx (the case's group) and packed int4 dx (in groups
    of 128 and per channel) on aligned widths run the tensor-core dx kernel
    at any M (one ``tc_launches`` of the backward a call; M 65 and 256: two
    and four passes of 64 dy rows) and match their plain version; a second
    launch is bitwise equal, a captured call equal to an eager one."""
    m, k, n, gs = case
    name = weights.split()[0]
    if name == "int4":
        gs = 128 if "g128" in weights else -1
    rng = np.random.RandomState(10)
    qw = quantize_weight(torch.from_numpy(0.05 * rng.standard_normal(
        (k, n)).astype(np.float32)).to(dtype), name, gs)
    q, s = qw["q"].to(cuda), qw["s"].to(cuda).reshape(-1, n)
    dy = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(
        cuda, dtype)
    plan = qmm_mod.qmm_plan(m, k, n, s.shape[0], dtype, name == "int4", True,
                            True, 132)
    assert plan.route == "tc"
    before = quant_matmul_bwd.tc_launches
    got = quant_matmul_bwd(dy, q, s, k, dtype)
    again = quant_matmul_bwd(dy, q, s, k, dtype)
    torch.cuda.synchronize()
    assert quant_matmul_bwd.tc_launches == before + 2
    assert torch.equal(got, again)
    _qmm_err(got.float(),
             quant_matmul_dx_reference(dy, q, s, k, dtype).float(), dtype)
    _graph_equal(lambda: quant_matmul_bwd(dy, q, s, k, dtype))


def test_quant_matmul_other_shapes_run_cuda_cores(cuda):
    """M past the forward route's 64 rows, K off the routes' 64-row stages
    (int8 K 200; int4 K / 2 = 100), N off 16, fp32 and unaligned pointers
    take the CUDA-core kernel (no ``tc_launches``), correct: the forward
    and the dx (whose route takes M 65)."""
    rng = np.random.RandomState(9)
    for m, k, n, bits, gs, dtype, off in (
            (65, 768, 768, 8, -1, torch.bfloat16, 0),
            (24, 200, 768, 8, 40, torch.bfloat16, 0),
            (24, 768, 130, 8, -1, torch.bfloat16, 0),
            (24, 200, 768, 4, 40, torch.bfloat16, 0),
            (24, 768, 768, 4, 128, torch.float32, 0),
            (24, 768, 768, 8, -1, torch.float32, 0),
            (24, 768, 768, 8, 128, torch.bfloat16, 1),
            (24, 768, 768, 4, 128, torch.float16, 1)):
        name = f"int{bits}"
        qw = quantize_weight(torch.from_numpy(0.05 * rng.standard_normal(
            (k, n)).astype(np.float32)).to(dtype), name, gs)
        q, s = qw["q"].to(cuda), qw["s"].to(cuda)
        x, dy = (torch.from_numpy(rng.standard_normal(
            (m * c + off,)).astype(np.float32)).to(cuda, dtype)[off:].view(
                m, c) for c in (k, n))   # off: starts 2 or 4 bytes past 16
        before = quant_matmul_fwd.tc_launches
        got = quant_matmul(x, q, s)
        torch.cuda.synchronize()
        assert quant_matmul_fwd.tc_launches == before
        _qmm_err(got.float(), quant_matmul_reference(x, q, s).float(), dtype)
        on_route = (m > 64 and not off and dtype != torch.float32)
        before = quant_matmul_bwd.tc_launches
        dx = quant_matmul_bwd(dy, q, s, k, dtype)
        torch.cuda.synchronize()
        assert quant_matmul_bwd.tc_launches == before + on_route
        _qmm_err(dx.float(),
                 quant_matmul_dx_reference(dy, q, s, k, dtype).float(), dtype)


def test_mega_serving_launches_and_tokens(cuda):
    """A two-layer model (head_dim 64) served with ``mega_decode=True``:
    one launch of each mega kernel per layer and step, none of the ragged
    kernel or the weight-only GEMM, and the per-op predictor's greedy
    tokens (fp32)."""
    from paddle_tpu_torch.inference import ServingPredictor
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=97, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=96, initializer_range=0.5)
    model = state_from_jax_numpy(random_state(cfg, 3), cfg, device=cuda)
    model.eval()
    rng = np.random.RandomState(11)
    p0 = [int(x) for x in rng.randint(0, 97, 30)]
    prompts = [p0, [int(x) for x in rng.randint(0, 97, 9)], list(p0),
               p0[:20] + [1, 2, 3]]
    kw = dict(max_batch=3, page_size=8, chunk=8, num_pages=10, device=cuda)
    per_op = ServingPredictor(model, **kw).generate(prompts,
                                                    max_new_tokens=12)
    counts = (mega_attn_layer.launches, mega_mlp.launches,
              ragged_paged_attention.launches,
              dict(quant_matmul_fwd.launches))
    sp = ServingPredictor(model, mega_decode=True, **kw)
    got = sp.generate(prompts, max_new_tokens=12)
    torch.cuda.synchronize()
    assert got == per_op
    n = sp.steps * cfg.num_layers
    assert mega_attn_layer.launches - counts[0] == n > 0
    assert mega_mlp.launches - counts[1] == n
    assert ragged_paged_attention.launches == counts[2]
    assert dict(quant_matmul_fwd.launches) == counts[3]


# (K, N, rows per expert, scale group): the serving shapes (48 routed rows,
# one expert empty), a prefill-sized skewed split, an odd shape with an
# empty and a 1-row expert, and serving rows with a 1-row, an empty and a
# 100-row expert (two 64-row tiles of one expert on the skinny route)
GMM_SHAPES = {
    "serving_w1": (768, 3072, [30, 0, 11, 7], 128),
    "serving_w2": (3072, 768, [30, 0, 11, 7], 128),
    "prefill": (768, 3072, [2400, 900, 0, 796], 128),
    "odd": (136, 72, [5, 0, 1, 9, 3], 8),
    "one_row": (1024, 320, [1, 0, 100, 7], 64),
}
# the shapes whose quantized forward takes the skinny route in bf16
GMM_SK_SHAPES = ("serving_w1", "serving_w2", "one_row")


def _gmm_inputs(shape, weights, dtype, cuda, seed=7):
    """x [M, K], the expert stack (NaN in the empty expert's weights or
    scales), its [E, G, N] scales or None, offsets."""
    k, n, counts, gs = GMM_SHAPES[shape]
    rng = np.random.RandomState(seed)
    m, e = sum(counts), len(counts)
    x = _rand(rng, (m, k), cuda, dtype)
    w = _rand(rng, (e, k, n), cuda, torch.float32, 0.05)
    empty = counts.index(0)
    if weights == "fp":
        w = w.to(dtype)
        w[empty] = float("nan")
        scales = None
    else:
        bits, group = {"int8": ("int8", -1), "int8g": ("int8", gs),
                       "int4g": ("int4", gs)}[weights]
        qw = quantize_weight(w.to(dtype), bits, group)
        w, scales = qw["q"], qw["s"]
        scales[empty] = float("nan")
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=cuda)
    return x, w, scales, offs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(GMM_SHAPES))
@pytest.mark.parametrize("weights", ["fp", "int8", "int8g", "int4g"])
def test_grouped_matmul_kernels_match_plain(cuda, dtype, shape, weights):
    """Forward and dx of the ragged grouped GEMM against their plain
    versions; the empty expert's NaN weights never reach the output (its
    tiles read nothing). The quantized forward at the serving rows runs the
    skinny route in bf16 (one ``sk_launches`` a call), fp32, prefill rows
    and the odd shape the CUDA-core kernel; a second launch is bitwise
    equal. int4 dx is the plain contraction on both sides."""
    from paddle_tpu_torch.ops import grouped_matmul as gm

    x, w, scales, offs = _gmm_inputs(shape, weights, dtype, cuda)
    name = "fp" if weights == "fp" else weights[:4]
    k, n, counts, _ = GMM_SHAPES[shape]
    bits = {"fp": 0, "int8": 8, "int4": 4}[name]
    plan = gm._plan(x.shape[0], len(counts), k, n, bits, False, dtype, True,
                    torch.cuda.get_device_properties(
                        cuda).multi_processor_count,
                    1 if scales is None else scales.shape[1])
    sk = bits and shape in GMM_SK_SHAPES and dtype != torch.float32
    assert (plan.route == "sk") == bool(sk)
    before = dict(grouped_matmul_fwd.launches)
    sk0 = grouped_matmul_fwd.sk_launches
    got = grouped_matmul_fwd(x, w, offs, scales)
    again = grouped_matmul_fwd(x, w, offs, scales)
    torch.cuda.synchronize()
    assert grouped_matmul_fwd.launches[name] == before[name] + 2
    assert grouped_matmul_fwd.sk_launches == sk0 + 2 * bool(sk)
    assert torch.equal(got, again)
    want = grouped_matmul_reference(x, w, offs, scales)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    _qmm_err(got.float(), want.float(), dtype)
    if name == "int4":
        return
    rng = np.random.RandomState(8)
    dy = _rand(rng, (x.shape[0], w.shape[2]), cuda, dtype)
    before = dict(grouped_matmul_bwd.launches)
    dx = grouped_matmul_bwd(dy, w, offs, scales, x.shape[1], dtype)
    torch.cuda.synchronize()
    assert grouped_matmul_bwd.launches[name] == before[name] + 1
    assert bool(torch.isfinite(dx).all())
    _qmm_err(dx.float(), grouped_matmul_dx_reference(
        dy, w, offs, scales, x.shape[1], dtype).float(), dtype)


# the tensor-core kernel (bf16 fp weights): (K, N, rows per expert, tile).
# The serving rows and both GEMMs' widths; the prefill rows; rows that end
# mid-tile; empty first / middle / last experts; K and N multiples of 8 but
# not of the tiles (64 deep, 128 wide); a 1-row expert; a split reduction
# over a K that leaves a short last stage
GMM_TC_CASES = {
    "serving_w1": (768, 3072, [30, 0, 11, 7], "serving"),
    "serving_w2": (3072, 768, [30, 0, 11, 7], "serving"),
    "prefill_w1": (768, 3072, [2400, 0, 900, 796], "prefill"),
    "prefill_w2": (3072, 768, [2400, 900, 796, 0], "prefill"),
    "empty_ends": (136, 72, [0, 5, 1, 0, 9, 3, 0], "serving"),
    "mid_tile": (200, 264, [0, 177, 1, 0, 330, 133], "prefill"),
    "short_stage": (1000, 40, [1, 0, 15, 2], "serving"),
}


def _gmm_tc_inputs(case, cuda, seed=21, dtype=torch.bfloat16):
    """x [M, K], dy [M, N], W [E, K, N] in ``dtype`` (bf16 or fp16) with NaN
    in every empty expert, and the offsets."""
    k, n, counts, _ = GMM_TC_CASES[case]
    rng = np.random.RandomState(seed)
    m, e = sum(counts), len(counts)
    x = _rand(rng, (m, k), cuda, dtype)
    dy = _rand(rng, (m, n), cuda, dtype)
    w = _rand(rng, (e, k, n), cuda, dtype, 0.05)
    w[[i for i, c in enumerate(counts) if c == 0]] = float("nan")
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=cuda)
    return x, dy, w, offs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(GMM_TC_CASES))
def test_grouped_matmul_tc_matches_plain(cuda, case, dtype):
    """The tensor-core forward and dx against their plain versions, the
    empty experts' NaN weights absent from the outputs, one tensor-core
    launch each, two launches bitwise equal."""
    from paddle_tpu_torch.ops import grouped_matmul as gm

    x, dy, w, offs = _gmm_tc_inputs(case, cuda, dtype=dtype)
    k, n, counts, tile = GMM_TC_CASES[case]
    plan = gm._plan(x.shape[0], w.shape[0], k, n, 0, False, dtype,
                    True, torch.cuda.get_device_properties(
                        cuda).multi_processor_count)
    assert (plan.route, plan.tile) == ("tc", tile)
    fwd_tc, bwd_tc = grouped_matmul_fwd.tc_launches, \
        grouped_matmul_bwd.tc_launches
    fp_fwd, fp_bwd = grouped_matmul_fwd.launches["fp"], \
        grouped_matmul_bwd.launches["fp"]
    outs = [(grouped_matmul_fwd(x, w, offs),
             grouped_matmul_bwd(dy, w, offs, None, k, dtype))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert grouped_matmul_fwd.tc_launches == fwd_tc + 2
    assert grouped_matmul_bwd.tc_launches == bwd_tc + 2
    assert grouped_matmul_fwd.launches["fp"] == fp_fwd + 2
    assert grouped_matmul_bwd.launches["fp"] == fp_bwd + 2
    (got, dx), again = outs
    assert torch.equal(got, again[0]) and torch.equal(dx, again[1])
    assert got.dtype == dx.dtype == dtype
    assert bool(torch.isfinite(got).all()) and bool(
        torch.isfinite(dx).all())
    _assert_close(got, grouped_matmul_reference(x, w, offs), dtype)
    _assert_close(dx, grouped_matmul_dx_reference(dy, w, offs, None, k,
                                                  dtype), dtype)


@pytest.mark.parametrize("kn", [(136, 76), (132, 72)])
def test_grouped_matmul_width_off_the_copies_runs_cuda_cores(cuda, kn):
    """bf16 fp weights at a K or N that is not a multiple of 8, or with an
    unaligned weight pointer, run the CUDA-core kernel (no tensor-core
    launch) and match the plain version."""
    k, n = kn
    rng = np.random.RandomState(22)
    counts = [5, 0, 1, 9, 3]
    x = _rand(rng, (18, k), cuda, torch.bfloat16)
    dy = _rand(rng, (18, n), cuda, torch.bfloat16)
    w = _rand(rng, (5, k, n), cuda, torch.bfloat16, 0.05)
    w[1] = float("nan")
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=cuda)
    ws = [w]
    if k % 8 == 0 and n % 8 == 0:   # the same values one element off
        flat = torch.empty(w.numel() + 1, dtype=w.dtype, device=cuda)
        ws = [flat[1:].view(w.shape).copy_(w)]
        assert ws[0].data_ptr() % 16 != 0
    tc = (grouped_matmul_fwd.tc_launches, grouped_matmul_bwd.tc_launches)
    for wt in ws:
        got = grouped_matmul_fwd(x, wt, offs)
        dx = grouped_matmul_bwd(dy, wt, offs, None, k, torch.bfloat16)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()) and bool(
            torch.isfinite(dx).all())
        _assert_close(got, grouped_matmul_reference(x, w, offs),
                      torch.bfloat16)
        _assert_close(dx, grouped_matmul_dx_reference(
            dy, w, offs, None, k, torch.bfloat16), torch.bfloat16)
    assert (grouped_matmul_fwd.tc_launches,
            grouped_matmul_bwd.tc_launches) == tc


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_matmul_grad_wiring(cuda, dtype):
    """dx by the backward kernel (in bf16 the tensor-core one) and fp dw by
    the per-expert segment products equal the plain version's autograd
    gradients; int8 weights take no gradient."""
    rng = np.random.RandomState(9)
    counts = [7, 0, 40, 1]
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=cuda)
    x = _rand(rng, (48, 96), cuda, dtype).requires_grad_()
    w = _rand(rng, (4, 96, 80), cuda, dtype, 0.1).requires_grad_()
    r = _rand(rng, (48, 80), cuda, dtype)
    tc = grouped_matmul_bwd.tc_launches
    (grouped_matmul(x, w, offs) * r).sum().backward()
    assert grouped_matmul_bwd.tc_launches == tc + (dtype != torch.float32)
    gx, gw = x.grad.clone(), w.grad.clone()
    assert gx.dtype == gw.dtype == dtype
    x.grad = w.grad = None
    (grouped_matmul(x, w, offs, use_kernel=False) * r).sum().backward()
    _qmm_err(gx.float(), x.grad.float(), dtype)
    _qmm_err(gw.float(), w.grad.float(), dtype)
    if dtype != torch.float32:
        return
    qw = quantize_weight(w.detach(), "int8", 32)
    x.grad = None
    before = grouped_matmul_bwd.launches["int8"]
    (grouped_matmul(x, qw["q"], offs, qw["s"]) * r).sum().backward()
    assert grouped_matmul_bwd.launches["int8"] == before + 1
    assert grouped_matmul(x.detach(), qw["q"], offs, qw["s"]).grad_fn is None


# the dx route (int8 stacks, gmm_dx_kernel): (K, N, rows per expert). The
# serving rows (a) and the prefill rows (b) of both MoE GEMMs, and a 1-row,
# an empty and a 100-row expert (two 64-row tiles of one expert)
GMM_DX_CASES = {
    "serving_w1": (768, 3072, [30, 0, 11, 7]),
    "serving_w2": (3072, 768, [30, 0, 11, 7]),
    "prefill_w1": (768, 3072, [2400, 0, 900, 796]),
    "prefill_w2": (3072, 768, [2400, 900, 796, 0]),
    "one_row": (1024, 320, [1, 0, 100, 7]),
}


@pytest.mark.parametrize("gs", [-1, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(GMM_DX_CASES))
def test_grouped_matmul_dx_route_matches_plain(cuda, case, dtype, gs):
    """The 16-bit int8 dx (per channel and in groups of 128) runs the dx
    route at the serving and the prefill rows (one ``dx_launches`` a call)
    and matches its plain version; the empty expert's NaN scales never
    reach dx; a second launch is bitwise equal, a captured call equal to an
    eager one."""
    from paddle_tpu_torch.ops import grouped_matmul as gm

    k, n, counts = GMM_DX_CASES[case]
    rng = np.random.RandomState(23)
    m, e = sum(counts), len(counts)
    qw = quantize_weight(_rand(rng, (e, k, n), cuda, dtype, 0.05), "int8",
                         gs)
    w, scales = qw["q"], qw["s"]
    scales[counts.index(0)] = float("nan")
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=cuda)
    dy = _rand(rng, (m, n), cuda, dtype)
    plan = gm._plan(m, e, k, n, 8, True, dtype, True,
                    torch.cuda.get_device_properties(
                        cuda).multi_processor_count, scales.shape[1])
    assert plan.route == "dx"
    before, launches = grouped_matmul_bwd.dx_launches, dict(
        grouped_matmul_bwd.launches)
    got = grouped_matmul_bwd(dy, w, offs, scales, k, dtype)
    again = grouped_matmul_bwd(dy, w, offs, scales, k, dtype)
    torch.cuda.synchronize()
    assert grouped_matmul_bwd.dx_launches == before + 2
    assert grouped_matmul_bwd.launches["int8"] == launches["int8"] + 2
    assert torch.equal(got, again)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    _assert_close(got, grouped_matmul_dx_reference(dy, w, offs, scales, k,
                                                   dtype), dtype)
    _graph_equal(lambda: grouped_matmul_bwd(dy, w, offs, scales, k, dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mkn", [(24, 768, 3072, 128), (24, 3072, 768, -1),
                                 (256, 768, 2304, 128), (65, 768, 768, -1)])
def test_grouped_matmul_dx_one_expert_equals_qmm_dx(cuda, dtype, mkn):
    """Both dx kernels run csrc/dx_tile.cuh's tile: a one-expert grouped
    dx (its grid the weight-only GEMM's, the same split plan) is bitwise
    equal to ``qmm_dx_kernel``'s on the same weight, and both match the
    plain version."""
    from paddle_tpu_torch.ops import grouped_matmul as gm

    m, k, n, gs = mkn
    rng = np.random.RandomState(24)
    qw = quantize_weight(_rand(rng, (1, k, n), cuda, dtype, 0.05), "int8",
                         gs)
    dy = _rand(rng, (m, n), cuda, dtype)
    offs = torch.tensor([0, m], dtype=torch.int32, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = gm._plan(m, 1, k, n, 8, True, dtype, True, sms, qw["s"].shape[1])
    q = qmm_mod.qmm_plan(m, k, n, qw["s"].shape[1], dtype, False, True,
                         True, sms)
    assert (g.route, q.route) == ("dx", "tc")
    assert (g.rows * g.cols, g.splits, g.per) == (q.tiles, q.splits, q.per)
    before = (grouped_matmul_bwd.dx_launches, quant_matmul_bwd.tc_launches)
    got = grouped_matmul_bwd(dy, qw["q"], offs, qw["s"], k, dtype)
    ref = quant_matmul_bwd(dy, qw["q"][0], qw["s"][0], k, dtype)
    torch.cuda.synchronize()
    assert (grouped_matmul_bwd.dx_launches,
            quant_matmul_bwd.tc_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(_bits(got), _bits(ref))
    _assert_close(got, quant_matmul_dx_reference(dy, qw["q"][0], qw["s"][0],
                                                 k, dtype), dtype)


def test_moe_serving_launches_and_tokens(cuda):
    """A two-layer MoE model (4 experts, top-2, no drops) served on the
    per-op step: two grouped-GEMM launches per layer and step, and the
    greedy tokens of the same step with the plain grouped GEMM (fp32)."""
    from paddle_tpu_torch.inference import ServingPredictor
    from paddle_tpu_torch.models import moe
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=97, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=96, initializer_range=0.5,
                    moe_experts=4, moe_capacity_factor=4.0)
    model = state_from_jax_numpy(random_state(cfg, 3), cfg, device=cuda)
    model.eval()
    rng = np.random.RandomState(12)
    prompts = [[int(t) for t in rng.randint(0, 97, n)] for n in (30, 9, 17)]
    kw = dict(max_batch=3, page_size=8, chunk=8, num_pages=12, device=cuda)
    before = grouped_matmul_fwd.launches["fp"]
    sp = ServingPredictor(model, **kw)
    got = sp.generate(prompts, max_new_tokens=10)
    torch.cuda.synchronize()
    assert grouped_matmul_fwd.launches["fp"] - before == \
        2 * cfg.num_layers * sp.steps
    kernel_mm = moe._grouped_mm
    moe._grouped_mm = lambda xs, w, offs, use_kernel: kernel_mm(
        xs, w, offs, False)
    try:
        want = ServingPredictor(model, **kw).generate(prompts,
                                                      max_new_tokens=10)
    finally:
        moe._grouped_mm = kernel_mm
    assert got == want


def test_attention_routes_what_the_kernel_cannot_take(cuda):
    """fp32 head_dim 96 and fp64 attention (no kernel is built for either)
    run plain ``_sdpa_ref`` on the card instead of raising, equal to it; a
    d 96 ``gpt_spmd`` step runs."""
    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.nn.functional import attention as A

    rng = np.random.RandomState(13)
    for d, dtype in ((96, torch.float32), (64, torch.float64)):
        q, k, v = (_rand(rng, (2, 40, 4, d), cuda, dtype) for _ in range(3))
        before = flash_attention_fwd.launches
        got = A.scaled_dot_product_attention(q, k, v, is_causal=True)
        assert flash_attention_fwd.launches == before
        want = A._sdpa_ref(q, k, v, causal=True)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    cfg = GPTConfig(vocab_size=128, hidden_size=384, num_layers=2,
                    num_heads=4, max_seq_len=64)
    step, params, mom, (ids, labels) = gpt_spmd.build_spmd_train_step(
        cfg, batch_size=2, seq_len=32, num_micro=1, lr=1e-3, device=cuda)
    params, mom, loss = step(params, mom, ids, labels)
    assert bool(torch.isfinite(loss))


# (b, hq, hkv, d, page size, pages a slot): GPT-125M's serving shape, GQA,
# MQA and the other head dims, then GQA 12/4 at page 8 (a page below the
# walk's 32-key tile, as the CPU twin's)
DECODE_GEOMS = [(8, 12, 12, 64, 64, 16), (5, 16, 2, 128, 16, 9),
                (5, 12, 4, 96, 16, 9), (4, 8, 1, 80, 16, 9),
                (4, 4, 4, 32, 16, 9), (6, 12, 4, 64, 8, 12)]


def _decode_inputs(rng, b, hq, hkv, d, ps, pps, device, dtype):
    """Lengths 0 (an empty slot), 1, one page, one past it, and the last
    slot at every page; -1 entries past each context."""
    num_pages = b * pps + 3
    q = _rand(rng, (b, hq, d), device, dtype)
    kp, vp = (_rand(rng, (num_pages, ps, hkv, d), device, dtype)
              for _ in range(2))
    lengths = np.array([0, 1, ps, ps + 1] + [pps * ps] * b, np.int32)[:b]
    lengths[-1] = pps * ps
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    for i in range(b):
        pt[i, (lengths[i] + ps - 1) // ps:] = -1
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return q, kp, vp, to(pt), to(lengths)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", DECODE_GEOMS)
def test_paged_decode_kernel_matches_plain(cuda, dtype, geom):
    """The split-walk decode kernel against its plain version: the empty
    slot zero, a second launch bitwise equal."""
    args = _decode_inputs(np.random.RandomState(3), *geom, cuda, dtype)
    before = paged_attention.launches
    got = paged_attention(*args)
    again = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 2
    assert torch.equal(got, again)
    want = paged_attention_reference(*args)
    _assert_close(got[1:].float(), want[1:].float(), dtype)
    assert torch.count_nonzero(got[0]) == 0           # the empty slot


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", DECODE_GEOMS)
def test_paged_decode_kernel_matches_ragged_at_chunk_1(cuda, dtype, geom):
    """The reference's ``test_ragged_decode_lane_matches_decode_kernel``:
    a decode lane of the ragged kernel (chunk 1, q_len 1) computes what the
    decode kernel computes on the same pools."""
    q, kp, vp, pt, lengths = _decode_inputs(np.random.RandomState(4), *geom,
                                            cuda, dtype)
    got = paged_attention(q, kp, vp, pt, lengths)
    ragged = ragged_paged_attention(q[:, None].contiguous(), kp, vp, pt,
                                    lengths, (lengths > 0).to(torch.int32))
    torch.cuda.synchronize()
    _assert_close(got[1:].float(), ragged[1:, 0].float(), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", [DECODE_GEOMS[0], DECODE_GEOMS[-1]])
def test_paged_decode_kernel_graph_replay(cuda, dtype, geom):
    """A captured decode launch (its split partials and counters kept
    across the capture) replays to the eager result."""
    args = _decode_inputs(np.random.RandomState(5), *geom, cuda, dtype)
    _graph_equal(lambda: paged_attention(*args))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [32, 80, 96])
def test_ragged_kernel_head_dims(cuda, dtype, d, quant):
    """The ragged kernel at the head dims of gpt3-tiny, -2.7b and -760m."""
    b, chunk, hq, hkv, ps, pps = 4, 8, 16 if d == 96 else 8, 4, 16, 12
    q, kp, vp, pt, kv_lens, q_lens = _ragged_inputs(
        np.random.RandomState(d), b, chunk, hq, hkv, d, ps, pps, cuda,
        torch.float32)
    scales = {}
    if quant:
        (kp, ks), (vp, vs) = (quantize_kv_rows(t.reshape(-1, hkv, d))
                              for t in (kp, vp))
        kp, vp = kp.reshape(-1, ps, hkv, d), vp.reshape(-1, ps, hkv, d)
        scales = dict(k_scales=ks.reshape(-1, ps, hkv),
                      v_scales=vs.reshape(-1, ps, hkv))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    args = (q.to(dtype), kp, vp, pt, kv_lens, q_lens)
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args, **scales)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    want = ragged_paged_attention_reference(*args, **scales)
    _assert_close(_valid_rows(got, q_lens).float(),
                  _valid_rows(want, q_lens).float(), dtype)


def test_legacy_serving_launches_and_tokens(cuda):
    """``ServingPredictor(unified=False)`` on the card: one decode-kernel
    launch per layer and decode step, no ragged launch, and the unified
    per-op predictor's greedy tokens (fp32)."""
    from paddle_tpu_torch.inference import ServingPredictor
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=97, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=96, initializer_range=0.5)
    model = state_from_jax_numpy(random_state(cfg, 3), cfg, device=cuda)
    model.eval()
    rng = np.random.RandomState(11)
    prompts = [[int(x) for x in rng.randint(0, 97, n)] for n in (30, 9, 1, 17)]
    kw = dict(max_batch=3, page_size=8, num_pages=10, device=cuda)
    unified = ServingPredictor(model, chunk=8, **kw).generate(
        prompts, max_new_tokens=12)
    counts = (paged_attention.launches, ragged_paged_attention.launches)
    sp = ServingPredictor(model, unified=False, **kw)
    got = sp.generate(prompts, max_new_tokens=12)
    torch.cuda.synchronize()
    assert got == unified
    assert paged_attention.launches - counts[0] == sp.steps * 2 > 0
    assert ragged_paged_attention.launches == counts[1]


# -- the split page walks (rows 1 and 13) ------------------------------------

# (b, chunk, hq, hkv, d, page, pages a lane, kv_lens, q_lens): GPT-125M's
# decode round (8 lanes, one row each, 1,024 tokens), gpt3-1.3b's 32 heads
# at 2,048 tokens with prefill chunks, GQA 4 and MQA at contexts ending
# mid-page, an idle lane, a first chunk (kv_len == q_len)
WALK_CASES = {
    "decode_round": (8, 16, 12, 12, 64, 64, 16, [1024] * 8, [1] * 8),
    "long_1p3b": (8, 16, 32, 32, 64, 64, 32, [2048] * 8,
                  [1, 16, 1, 7, 1, 1, 16, 1]),
    "gqa4_d128": (6, 16, 16, 4, 128, 16, 40, [0, 16, 333, 640, 97, 17],
                  [0, 16, 16, 1, 5, 1]),
    "mqa_d80": (5, 8, 8, 1, 80, 32, 20, [640, 1, 8, 300, 511],
                [1, 1, 8, 3, 8]),
    "d32": (4, 16, 4, 4, 32, 64, 9, [576, 33, 64, 65], [16, 1, 16, 2]),
}


def _walk_inputs(case, dtype, quant, device, seed=0):
    b, chunk, hq, hkv, d, ps, pps, kv_lens, q_lens = WALK_CASES[case]
    rng = np.random.RandomState(seed)
    num_pages = b * pps + 1
    q = rng.standard_normal((b, chunk, hq, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
              for _ in range(2))
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    for i in range(b):
        pt[i, (kv_lens[i] + ps - 1) // ps:] = -1
    to = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device, dt)  # noqa
    kp, vp = to(kp, torch.float32), to(vp, torch.float32)
    kw = {}
    if quant:
        (kp, ks), (vp, vs) = (quantize_kv_rows(t.reshape(-1, hkv, d))
                              for t in (kp, vp))
        shape = (num_pages, ps, hkv)
        kp, vp = kp.reshape(*shape, d), vp.reshape(*shape, d)
        kw = dict(k_scales=ks.reshape(shape), v_scales=vs.reshape(shape))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    args = (to(q, dtype), kp, vp, to(pt, torch.int32),
            to(kv_lens, torch.int32), to(q_lens, torch.int32))
    return args, kw


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_ragged_split_walk_matches_plain(cuda, case, dtype, quant):
    """The split walk against the plain version (fp and int8 KV, MHA, GQA,
    MQA, d 32 / 64 / 80 / 128), and a second launch bitwise equal to the
    first (the splits merge in a fixed order)."""
    args, kw = _walk_inputs(case, dtype, quant, cuda)
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args, **kw)
    again = ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 2
    assert torch.equal(got, again)
    want = ragged_paged_attention_reference(*args, **kw)
    q_lens = args[-1]
    _assert_close(_valid_rows(got, q_lens).float(),
                  _valid_rows(want, q_lens).float(), dtype)
    rows = (torch.arange(got.shape[1], device=cuda)[None]
            >= q_lens[:, None].long())
    assert torch.count_nonzero(got[rows]) == 0


def _graph_equal(fn):
    """One call captured in a CUDA graph and replayed: bitwise equal to an
    eager call on the same inputs (the scratch the call needs is grown by
    the eager call first and kept, so the graph holds live buffers)."""
    eager = fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    flat = lambda t: t if isinstance(t, tuple) else (t,)  # noqa: E731
    for a, b in zip(flat(eager), flat(out)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_split_walk_graph_replay(cuda, dtype):
    args, kw = _walk_inputs("decode_round", dtype, False, cuda)
    _graph_equal(lambda: ragged_paged_attention(*args, **kw))


def _mega_decode_round(dtype, kv_quant, device):
    """GPT-125M's decode round for one layer: 8 lanes of one row over
    1,023-token contexts (page 64, 16 pages a lane), chunk 16."""
    b, chunk, h, nh, d, ps, pps, f = MEGA_GEOMS["serving"]
    xb, p, pools, pt, ctx, q_lens = _mega_inputs("serving", "fp", -1,
                                                 kv_quant, dtype, device)
    ctx = torch.full((b,), 1023, dtype=torch.int32, device=device)
    q_lens = torch.ones(b, dtype=torch.int32, device=device)
    rng = np.random.RandomState(4)
    pt = torch.from_numpy(rng.permutation(b * pps + 2)[:b * pps].reshape(
        b, pps).astype(np.int32)).to(device)
    return (xb, p, pools["k_pages"], pools["v_pages"], pt, ctx, q_lens), \
        dict(k_scales=pools.get("k_scales"), v_scales=pools.get("v_scales"))


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mega_attn_decode_round_repeat_and_graph(cuda, dtype, kv_quant):
    """The mega attention kernel at the decode round against its plain
    version, a second launch bitwise equal to the first, and a captured
    call bitwise equal to an eager one."""
    args, kw = _mega_decode_round(dtype, kv_quant, cuda)
    got = mega_attn_layer(*args, **kw)
    again = mega_attn_layer(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = mega_attn_layer_reference(*args, **kw)
    q_lens = args[-1]
    flips = sum(_mega_close(g, w, dtype, q_lens)
                for g, w in zip(got[2:4], want[2:4]))
    for g, w in zip(got[:2] + got[4:], want[:2] + want[4:]):
        _mega_close(g, w, dtype, q_lens,
                    fp32_tol=MEGA_KV_TOL if flips else QMM_FP32_TOL)
    _graph_equal(lambda: mega_attn_layer(*args, **kw))


# -- fp16: every family's plain twin on the card ------------------------------


def _routes():
    from paddle_tpu_torch.ops import twin_routes
    return twin_routes()


def _fp16_held(got, want):
    """An fp16 kernel result against its fp16 plain twin: per row, to
    ``FP16_ROW_TOL``."""
    assert got.dtype == want.dtype == torch.float16
    _assert_close(got.float(), want.float(), torch.float16)


def test_fp16_runs_every_family_twin(cuda):
    """fp16 is a kernel dtype: each family launches its kernel (no twin
    route counted) and returns what its fp16 twin returns; fp64, which no
    kernel takes, still routes to the twin and is counted."""
    from paddle_tpu_torch.ops.fused_mlp import gelu_bwd, ln_bwd

    rng = np.random.RandomState(9)
    h16 = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(cuda, torch.float16)
    n0 = _routes()
    # ragged and decode attention
    args = _ragged_inputs(rng, 4, 8, 8, 2, 64, 16, 6, cuda, torch.float16)
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args)
    assert ragged_paged_attention.launches == before + 1
    want = ragged_paged_attention_reference(*args)
    _fp16_held(_valid_rows(got, args[-1]), _valid_rows(want, args[-1]))
    lengths = args[4]
    before = paged_attention.launches
    q1 = args[0][:, 0].contiguous()
    got = paged_attention(q1, *args[1:4], lengths)
    assert paged_attention.launches == before + 1
    want = paged_attention_reference(q1, *args[1:4], lengths)
    _fp16_held(got[lengths > 0], want[lengths > 0])
    # fused LN / GELU, forward and backward through the custom ops
    x = h16(rng.randn(33, 200)).requires_grad_()
    g, b = h16(1 + 0.1 * rng.randn(200)), h16(0.1 * rng.randn(200))
    before = (ln_fwd.launches, gelu_fwd.launches, ln_bwd.launches,
              gelu_bwd.launches)
    y = fused_bias_gelu(fused_layer_norm(x, g, b), b)
    y.float().sum().backward()
    assert (ln_fwd.launches, gelu_fwd.launches, ln_bwd.launches,
            gelu_bwd.launches) == tuple(n + 1 for n in before)
    _fp16_held(y, gelu_fwd_reference(
        ln_fwd_reference(x.detach(), None, g, b, 1e-5)[0], b))
    assert x.grad is not None and x.grad.dtype == torch.float16
    # weight-only GEMM and grouped GEMM
    w = torch.from_numpy(rng.randn(200, 72).astype(np.float32)).to(cuda)
    qw = quantize_weight(w, "int8", -1)
    xq = h16(rng.randn(5, 200))
    before = quant_matmul_fwd.launches["int8"]
    _fp16_held(quant_matmul(xq, qw["q"], qw["s"]),
               quant_matmul_reference(xq, qw["q"], qw["s"]))
    assert quant_matmul_fwd.launches["int8"] == before + 1
    we = torch.from_numpy(rng.randn(3, 200, 72).astype(np.float32)).to(
        cuda).half()
    offs = torch.tensor([0, 2, 2, 5], dtype=torch.int32, device=cuda)
    before = grouped_matmul_fwd.launches["fp"]
    _fp16_held(grouped_matmul(xq, we, offs),
               grouped_matmul_reference(xq, we, offs))
    assert grouped_matmul_fwd.launches["fp"] == before + 1
    # mega attention and MLP
    xb, p, pools, pt, ctx, q_lens = _mega_inputs("odd", "fp", -1, False,
                                                 torch.float16, cuda)
    args = (xb, p, pools["k_pages"], pools["v_pages"], pt, ctx, q_lens)
    before = (mega_attn_layer.launches, mega_mlp.launches)
    got = mega_attn_layer(*args)
    want = mega_attn_layer_reference(*args)
    _fp16_held(_valid_rows(got[1], q_lens), _valid_rows(want[1], q_lens))
    y2 = h16(rng.randn(15, 256))
    _fp16_held(mega_mlp(y2, y2, p), mega_mlp_reference(y2, y2, p))
    assert (mega_attn_layer.launches, mega_mlp.launches) == (
        before[0] + 1, before[1] + 1)
    assert _routes() == n0
    # fp64: no kernel, the twin on the card, one route counted
    args = _ragged_inputs(rng, 2, 4, 4, 4, 64, 16, 3, cuda, torch.float64)
    got = ragged_paged_attention(*args)
    assert _routes() == n0 + 1 and got.dtype == torch.float64


# -- the flash kernels' mask and varlen branches ----------------------------

# (b, s, hq, hkv, d): BERT-base's attention cut in batch, a GQA case with a
# ragged tail, and the wgmma route (d 128); fp32 runs d 64 / 128 only
FLASH_BRANCH_SHAPES = [(2, 512, 12, 12, 64), (2, 200, 8, 2, 64),
                       (1, 333, 4, 4, 128)]


def _branch_mask(kind, b, s, hq, rng, device):
    """The masks the kernels stream: key padding ``[b, 1, 1, s]`` (-1e9
    past a length, as BERT builds it), a dense bias ``[b, hq, s, s]``, a
    shared ``[1, 1, s, s]`` with ``NEG_INF`` holes, a bool ``[b, 1, s, s]``
    (normalized to ``0 / NEG_INF``)."""
    if kind == "key padding":
        lens = rng.randint(s // 4, s + 1, b)
        m = (np.arange(s)[None] >= lens[:, None]) * -1e9
        return torch.from_numpy(m.reshape(b, 1, 1, s).astype(np.float32))
    if kind == "dense bias":
        return torch.from_numpy(rng.standard_normal(
            (b, hq, s, s)).astype(np.float32))
    if kind == "shared holes":
        return torch.from_numpy(np.where(rng.rand(1, 1, s, s) < 0.2, -1e30,
                                         0.0).astype(np.float32))
    return torch.from_numpy(rng.rand(b, 1, s, s) >= 0.2)


def _zero_rows(b, s, hq, hkv, causal, mask, lens, device):
    """The gradient rows that are zero in exact arithmetic, where both
    sides return fp32 rounding noise: ``[b, s, hq]`` bool, the dq rows of
    queries that see exactly one key (``p = 1``, so ``ds = 0``), and
    ``[b, s, hkv]`` bool, the dk rows of keys seen only by such queries
    (for every head of the kv head's group). A bias below -1e6 hides a
    key."""
    from paddle_tpu_torch.ops.flash_attention import _scores_masked

    s0, dead = _scores_masked(torch.zeros(b, hq, s, s, device=device), b, s,
                              s, causal, mask, lens)
    seen = s0 > -1e6
    if dead is not None:
        seen = seen & ~dead
    one = seen.sum(-1) == 1                              # [b, hq, sq]
    lone_key = ~(seen & ~one[..., None]).any(-2)        # [b, hq, sk]
    lone_key = lone_key.reshape(b, hkv, hq // hkv, s).all(2)
    return one.transpose(1, 2), lone_key.transpose(1, 2)


def _check_branches(cuda, dtype, shape, causal, mask=None, lens=None,
                    seed=0):
    """Forward and backward kernels against their plain versions with a
    normalized mask and / or lens: one launch each, counted under the
    branch; out and lse, then dq, dk, dv fed the plain forward's lse and
    delta. In bf16 / fp16 the rows that are zero in exact arithmetic
    (``_zero_rows``) are held over the tensor's max, as
    ``_assert_bwd_close`` holds them."""
    from paddle_tpu_torch.ops.flash_attention import normalize_mask

    b, s, hq, hkv, d = shape
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(x).astype(
        np.float32)).to(cuda, dtype) for x in
        ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
    if mask is not None:
        mask = normalize_mask(mask.to(cuda), q, s)
    kw = dict(causal=causal, mask=mask, lens=lens)
    n = (flash_attention_fwd.launches, flash_attention_fwd.mask_launches,
         flash_attention_fwd.lens_launches)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_fwd.mask_launches,
            flash_attention_fwd.lens_launches) == (
        n[0] + 1, n[1] + (mask is not None), n[2] + (lens is not None))
    want, want_lse = flash_attention_reference(q, k, v, **kw)
    _assert_close(out.float(), want.float(), dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    delta = (do.float() * want.float()).sum(-1).transpose(1, 2)
    delta = delta.reshape(b * hq, 1, s).contiguous()
    nb = flash_attention_bwd.mask_launches + flash_attention_bwd.lens_launches
    got = flash_attention_bwd(q, k, v, do, want_lse, delta, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_bwd.mask_launches
            + flash_attention_bwd.lens_launches) == nb + (
        mask is not None) + (lens is not None)
    ref = flash_attention_bwd_reference(q, k, v, do, want_lse, delta, **kw)
    zero_rows = dict(zip(("dq", "dk"), _zero_rows(b, s, hq, hkv, causal,
                                                   mask, lens, cuda)))
    for name, g, w in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        zero = zero_rows.get(name)
        if dtype == torch.float32:
            err = (g - w).abs().max() / w.abs().max()
            assert err.item() <= BWD_FP32_TOL, (name, err.item())
        elif zero is not None and zero.any():
            _assert_close(g[~zero], w[~zero], dtype)
            err = (g[zero].float() - w[zero].float()).abs().max() \
                / w.float().abs().max()
            assert err.item() <= ZERO_ROW_TOL[dtype], err.item()
        else:
            _assert_close(g, w, dtype)
    return out, lse.reshape(b, hq, s), got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH_BRANCH_SHAPES)
@pytest.mark.parametrize("kind", ["key padding", "dense bias",
                                  "shared holes", "bool"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_mask_branch_matches_plain(cuda, dtype, shape, kind, causal):
    b, s, hq, _, _ = shape
    mask = _branch_mask(kind, b, s, hq, np.random.RandomState(1), cuda)
    _check_branches(cuda, dtype, shape, causal, mask=mask, seed=2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH_BRANCH_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_flash_varlen_branch_matches_plain(cuda, dtype, shape, causal,
                                           with_mask):
    """Lengths with a 0, q_len != kv_len both ways, a full one and one
    past a tile edge; rows past q_len come back zero with LSE_INVALID."""
    from paddle_tpu_torch.ops.flash_attention import LSE_INVALID

    _, s, hq, _, d = shape
    b = 4
    shape = (b, s, hq, shape[3], d)
    ql = [s, 0, s // 2 + 3, 65]
    kl = [s, s // 3, 1, s - 7]
    lens = torch.tensor([ql, kl], dtype=torch.int32, device=cuda)
    mask = (_branch_mask("key padding", b, s, hq, np.random.RandomState(3),
                         cuda) if with_mask else None)
    out, lse, grads = _check_branches(cuda, dtype, shape, causal, mask=mask,
                                      lens=lens, seed=4)
    for i, n in enumerate(ql):
        assert torch.count_nonzero(out[i, n:]) == 0
        assert (lse[i, :, n:] == LSE_INVALID).all()
        assert torch.count_nonzero(grads[0][i, n:]) == 0
        assert torch.count_nonzero(grads[1][i, kl[i]:]) == 0


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_unpadded_kernel_vs_plain(cuda, causal):
    """The varlen entry at BERT-base widths in bf16: the kernel route
    (scatter, flash with lengths, gather; one lens launch each way)
    against the segment-masked plain version on the same values in fp32,
    the output per row as the bf16 kernels are, the gradients as
    ``_assert_varlen_grad_close`` holds them."""
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    from paddle_tpu_torch.nn.functional.attention import _unpadded_ref

    lens = [512, 77, 300, 1, 129]
    cu = torch.tensor(np.cumsum([0] + lens), device=cuda)
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (sum(lens), 12, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
        for _ in range(4))
    grads = {}
    for route in ("kernel", "plain"):
        # the plain version on the same values in fp32 (in bf16 it would
        # round every score before the softmax)
        args = [(x if route == "kernel" else x.float()).clone()
                .requires_grad_() for x in (q, k, v)]
        n = (flash_attention_fwd.lens_launches,
             flash_attention_bwd.lens_launches)
        if route == "kernel":
            out = flash_attn_unpadded(*args, cu, cu, 512, 512,
                                      causal=causal)[0]
        else:
            out = _unpadded_ref(*args, cu, cu, causal=causal)
        out.backward(do if route == "kernel" else do.float())
        torch.cuda.synchronize()
        assert (flash_attention_fwd.lens_launches,
                flash_attention_bwd.lens_launches) == tuple(
            x + (route == "kernel") for x in n)
        grads[route] = (out.detach(), *(a.grad for a in args))
    _assert_close(grads["kernel"][0], grads["plain"][0], torch.bfloat16)
    for name, g, w in zip(("dq", "dk", "dv"), grads["kernel"][1:],
                          grads["plain"][1:]):
        _assert_varlen_grad_close(name, g, w, lens)


def _assert_varlen_grad_close(name, got, want, lens):
    """One packed bf16 gradient ``[total, h, d]`` against the fp32 plain
    one, per sequence: each sequence's rows over that sequence's max
    ``|want|`` to ``BF16_ROW_TOL`` (the kernels form delta from the bf16
    output, and a query that sees a few keys cancels in ``dp - delta``, so
    a row's own scale does not bound its error against exact gradients;
    the sequence's does). dq and dk of a length-1 sequence are zero in
    exact arithmetic (``p = 1``, so ``ds = 0``): held as an fp32 gradient
    over the tensor's max ``|want|`` to ``BWD_FP32_TOL``."""
    scale = want.abs().max().item()
    start = 0
    for n in lens:
        g, w = got[start:start + n].float(), want[start:start + n]
        start += n
        err = (g - w).abs().max().item()
        if n == 1 and name != "dv":
            assert err / scale <= BWD_FP32_TOL, (name, n, err / scale)
        else:
            held = err / w.abs().max().item()
            assert held <= BF16_ROW_TOL, (name, n, held)


def test_eager_bert_gradients_flash_vs_plain(cuda):
    """A 2-layer BERT-base-width model in fp32 with a padded attention
    mask: the loss's gradients through the masked kernels (2 + 2 masked
    launches) equal plain attention's, every parameter, none ``None``."""
    from dataclasses import replace

    from paddle_tpu_torch.models.bert import BERT_CONFIGS
    from paddle_tpu_torch.models.convert import (bert_from_jax_numpy,
                                                 random_bert_state)
    from paddle_tpu_torch.nn.functional.attention import plain_attention

    cfg = replace(BERT_CONFIGS["bert-base"], num_layers=2,
                  hidden_dropout=0.0, attn_dropout=0.0)
    rng = np.random.RandomState(6)
    b, s = 2, 384
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(cuda)
    am = torch.ones(b, s, device=cuda)
    am[1, 200:] = 0
    labels = torch.where(torch.from_numpy(rng.rand(b, s) < 0.2).to(cuda),
                         ids, -100)
    nsp = torch.tensor([0, 1], device=cuda)
    model = bert_from_jax_numpy(random_bert_state(cfg, 0), cfg, device=cuda)
    grads = {}
    for flash in (True, False):
        model.zero_grad(set_to_none=True)
        n = (flash_attention_fwd.mask_launches,
             flash_attention_bwd.mask_launches)
        with contextlib.nullcontext() if flash else plain_attention():
            model(ids, attention_mask=am, masked_lm_labels=labels,
                  next_sentence_label=nsp).backward()
        torch.cuda.synchronize()
        assert (flash_attention_fwd.mask_launches - n[0],
                flash_attention_bwd.mask_launches - n[1]) == (
            (2, 2) if flash else (0, 0))
        grads[flash] = {k: p.grad for k, p in model.named_parameters()}
    for name, want in grads[False].items():
        got = grads[True][name]
        assert got is not None and want is not None, name
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= GRAD_TOL, (name, err.item())


# -- the captured serving step ------------------------------------------------

CAPTURE_FORMS = {
    "fp32": (dict(), dict(), torch.float32),
    "bf16": (dict(), dict(), torch.bfloat16),
    "fp16": (dict(), dict(), torch.float16),
    "int8_int8kv": (dict(weight_dtype="int8"), dict(kv_cache_dtype="int8"),
                    torch.bfloat16),
    "int4_int8kv": (dict(weight_dtype="int4", weight_quant_group_size=64),
                    dict(kv_cache_dtype="int8"), torch.bfloat16),
    "mega": (dict(), dict(mega_decode=True), torch.bfloat16),
    "moe": (dict(moe_experts=4, moe_capacity_factor=1.25), dict(),
            torch.bfloat16),
}


class _EagerStep:
    """A predictor's unified step run op by op on every call."""

    def __init__(self, sp):
        self.step = sp._unified
        sp._unified = self

    @property
    def trace_count(self):
        return self.step.trace_count

    def __call__(self, *args):
        return self.step.eager(*args)


@pytest.mark.parametrize("form", sorted(CAPTURE_FORMS))
def test_captured_step_one_capture_replays_bitwise_and_counts(cuda, form):
    """A two-layer model (head_dim 64) served on the captured step with the
    async engine: one capture over a churn with preemption and copy-on-write;
    the streams of the synchronous engine on the eager step; every step's
    launches counted once; then one more replay of the capture against the
    eager step on copies of the pools — next tokens, logits and pools
    bitwise equal — adding exactly what the capture recorded to the
    counters, as many launches of each kernel as the profiler sees the
    replay run; a call on other tensors than the bound ones raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import ops
    from paddle_tpu_torch.inference import ServingPredictor
    from paddle_tpu_torch.models.gpt import GPTConfig

    over, fields, dtype = CAPTURE_FORMS[form]
    cfg = GPTConfig(vocab_size=97, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=96, initializer_range=0.5,
                    **over)
    model = state_from_jax_numpy(random_state(cfg, 3), cfg, device=cuda)
    model.eval()
    rng = np.random.RandomState(11)
    p0 = [int(x) for x in rng.randint(0, 97, 30)]
    prompts = [p0, [int(x) for x in rng.randint(0, 97, 9)], list(p0),
               p0[:20] + [1, 2, 3], [int(x) for x in rng.randint(0, 97, 17)]]
    kw = dict(max_batch=3, page_size=8, chunk=8, num_pages=10, device=cuda,
              dtype=dtype, **fields)
    eager = ServingPredictor(model, async_engine=False, **kw)
    _EagerStep(eager)
    want = eager.generate(prompts, max_new_tokens=12)
    assert eager.decode_trace_count == 0
    before = ops.counters()
    routes = ops.twin_routes()
    sp = ServingPredictor(model, **kw)
    assert sp.async_engine
    got = sp.generate(prompts, max_new_tokens=12)
    torch.cuda.synchronize()
    assert got == want and all(len(s) == 12 for s in got)
    assert sp.decode_trace_count == 1 and sp.steps == eager.steps
    tel = sp.telemetry()
    assert tel["serving_preemptions"] > 0 and tel["kv_cow_copies"] > 0
    assert 0 < sp.hard_syncs < sp.steps
    ran = ops.counters()
    n = sp.steps * cfg.num_layers
    key = (("mega_attn_layer", "launches", None) if sp.mega_decode
           else ("ragged_paged_attention", "launches", None))
    assert ran[key] - before[key] == n
    assert ops.twin_routes() == routes
    step = sp._unified
    (prog,) = step._programs.values()
    args = list(prog.args)
    n_pool = len(sp.cache.pools())
    args[11:11 + n_pool] = [p.clone() for p in args[11:11 + n_pool]]
    want_out = step.eager(*args)
    torch.cuda.synchronize()
    mid = ops.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        got_out = step(*prog.args)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    after = ops.counters()
    delta = step.replay_counts[0]
    assert {k: v - mid[k] for k, v in after.items() if v != mid[k]} == delta
    assert delta[key] == cfg.num_layers
    assert step.trace_count == 1
    for g, w in zip(got_out, want_out):
        assert torch.equal(g, w)
    # the counters' replay launches are the kernels the replay ran
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == DeviceType.CUDA]
    for mark, wrapper in (("ragged_split_kernel", "ragged_paged_attention"),
                          ("mega_attn_kernel", "mega_attn_layer"),
                          ("mega_mlp_kernel", "mega_mlp"),
                          ("qmm_", "quant_matmul_fwd"),
                          ("gmm_", "grouped_matmul_fwd")):
        assert sum(mark in n for n in names) == sum(
            n for (w, attr, _), n in delta.items()
            if w == wrapper and attr == "launches"), (mark, names)
    # a captured step runs on the tensors its capture bound, and no others
    foreign = list(prog.args)
    foreign[1] = foreign[1].clone()
    with pytest.raises(ValueError, match="capture bound"):
        step(*foreign)


def test_moe_ffn_with_stats_captures_bitwise(cuda):
    """``moe_ffn`` reads no device value on the host (expert counts by a
    scatter-add, the router stats' one-hot and pair count on the device):
    captured in a CUDA graph, with and without its stats, a replay is
    bitwise equal to the eager call."""
    from paddle_tpu_torch.models.moe import moe_ffn

    rng = np.random.RandomState(5)
    n, d, f, e = 40, 128, 256, 4
    x = _rand(rng, (n, d), cuda, torch.bfloat16)
    gate = _rand(rng, (d, e), cuda, torch.bfloat16)
    w1 = _rand(rng, (e, d, f), cuda, torch.bfloat16, 0.05)
    w2 = _rand(rng, (e, f, d), cuda, torch.bfloat16, 0.05)
    b1 = _rand(rng, (e, f), cuda, torch.bfloat16)
    b2 = _rand(rng, (e, d), cuda, torch.bfloat16)
    valid = torch.arange(n, device=cuda) < n - 3
    for stats in (False, True):
        def run():
            return moe_ffn(x, gate, w1, b1, w2, b2, top_k=2,
                           capacity_factor=1.25, valid=valid,
                           with_stats=stats)

        with torch.no_grad():
            want = run()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = run()
            graph.replay()
            torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if stats:
            assert torch.equal(got[2]["load"], want[2]["load"])
            assert torch.equal(got[2]["drop_rate"], want[2]["drop_rate"])


# -- the captured step's params binding and speculation -----------------------


def _tiny_served(cuda, **over):
    """A two-layer model at head_dim 64 and motif prompts that repeat."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=97, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=96, initializer_range=0.5,
                    **over)
    model = state_from_jax_numpy(random_state(cfg, 3), cfg, device=cuda)
    rng = np.random.RandomState(2)
    prompts = [np.tile(rng.randint(0, 97, 3), n // 3 + 1)[:n].tolist()
               for n in (9, 30, 5, 17, 12)]
    return model.eval(), prompts


def _replay_held(prog_owner, prog, run):
    """``run()`` replays ``prog`` (a capture of ``prog_owner``) once under
    the profiler: the counters gain exactly the capture's delta, as many
    launches of each kernel as the profiler sees, and no capture is
    added."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import ops

    n_prog = prog_owner.trace_count
    torch.cuda.synchronize()
    mid = ops.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        run()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    after = ops.counters()
    assert {k: v - mid[k] for k, v in after.items()
            if v != mid[k]} == prog.delta
    assert prog_owner.trace_count == n_prog
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == DeviceType.CUDA]
    for mark, wrapper in (("ragged_split_kernel", "ragged_paged_attention"),
                          ("mega_attn_kernel", "mega_attn_layer"),
                          ("mega_mlp_kernel", "mega_mlp"),
                          ("qmm_", "quant_matmul_fwd")):
        assert sum(mark in n for n in names) == sum(
            n for (w, attr, _), n in prog.delta.items()
            if w == wrapper and attr == "launches"), (mark, names)


def test_captured_step_binds_params_by_leaf(cuda):
    """The captured step binds the params by their leaves: a new dict of
    the same tensors replays the one capture (bitwise the same outputs),
    and a leaf replaced in the bound dict raises instead of replaying the
    old weights."""
    from paddle_tpu_torch.inference import ServingPredictor

    model, prompts = _tiny_served(cuda)
    sp = ServingPredictor(model, max_batch=3, page_size=8, chunk=8,
                          device=cuda)
    sp.generate(prompts, max_new_tokens=6)
    step = sp._unified
    assert step.trace_count == 1
    (prog,) = step._programs.values()
    n_pool = len(sp.cache.pools())
    pools = prog.args[11:11 + n_pool]
    saved = [p.clone() for p in pools]
    outs = []
    for params in (sp.params, {k: (dict(v) if isinstance(v, dict) else v)
                               for k, v in sp.params.items()}):
        for p, s in zip(pools, saved):
            p.copy_(s)
        outs.append(step(params, *prog.args[1:]))
        torch.cuda.synchronize()
        assert step.trace_count == 1
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert torch.equal(a, b)
    w1 = sp.params["layers"]["w1"]
    sp.params["layers"]["w1"] = w1 * 2
    try:
        with pytest.raises(ValueError, match="capture bound"):
            step(*prog.args)
    finally:
        sp.params["layers"]["w1"] = w1
    assert step.trace_count == 1


@pytest.mark.parametrize("form", ["per-op", "mega", "int8_int8kv"])
@pytest.mark.parametrize("source", ["ngram", "model"])
def test_spec_serving_captures_once_and_counts(cuda, form, source):
    """Speculative serving on the captured step with the async engine: the
    spec-off streams, the verify step captured once, every model draft
    program once (the catch-up step, one chain a length), no twin route;
    a replay of each capture adds its recorded launches, as many as the
    profiler sees."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.inference import ServingPredictor

    over = (dict(weight_dtype="int8", weight_quant_group_size=64)
            if form == "int8_int8kv" else {})
    model, prompts = _tiny_served(cuda, **over)
    routes = ops.twin_routes()
    kw = dict(max_batch=3, page_size=8, chunk=8, device=cuda,
              dtype=torch.bfloat16, mega_decode=form == "mega",
              kv_cache_dtype="int8" if over else None)
    want = ServingPredictor(model, **kw).generate(prompts, 12)
    extra = (dict(draft_source="model", draft_layers=1)
             if source == "model" else {})
    sp = ServingPredictor(model, spec_decode_k=4, **extra, **kw)
    got = sp.generate(prompts, 12)
    torch.cuda.synchronize()
    assert got == want and sp.spec_proposed > 0
    assert sp.decode_trace_count == 1 and ops.twin_routes() == routes
    assert sp.cache.available_page_count == sp.cache.num_pages
    step = sp._unified
    (prog,) = step._programs.values()
    _replay_held(step, prog, lambda: step(*prog.args))
    eng = sp._draft_engine
    if eng is None:
        assert sp.draft_trace_count == 0
        return
    owners = [eng._catchup] + list(eng._chains.values())
    assert all(o.trace_count <= 1 for o in owners)
    assert sp.draft_trace_count == sum(o.trace_count for o in owners) >= 2
    assert len(eng.replay_counts) == sp.draft_trace_count
    for owner in owners:
        for p in owner._programs.values():
            _replay_held(owner, p, lambda: owner(*p.args))


def test_capture_holds_off_cyclic_gc(cuda):
    """A dead reference cycle holding a captured CUDA graph (a dropped
    predictor) is not collected during a capture: freeing a graph
    mid-capture invalidates the capture. With a collection due at every
    allocation, the capture still succeeds and replays, and the cycle is
    collected after it."""
    import gc
    import weakref

    from paddle_tpu_torch.models.gpt import _Captured

    x = torch.ones(4, device=cuda)

    class Holder:
        pass

    held = Holder()
    held.cycle = held
    held.capture = _Captured(lambda params, t: (t * 2,), ({}, x))
    dead = weakref.ref(held)
    del held
    saved = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        cap = _Captured(lambda params, t: tuple(t + i for i in range(50)),
                        ({}, x))
    finally:
        gc.set_threshold(*saved)
    assert gc.isenabled()
    gc.collect()
    assert dead() is None
    out = cap.replay(({}, x))
    torch.cuda.synchronize()
    assert torch.equal(out[3], x + 3)
