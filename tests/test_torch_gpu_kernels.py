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
error is held to ``1e-2`` of the row's max ``|want|``. The dq row of a
query that sees one key is zero in exact arithmetic (``ds = p (dp -
delta)`` with ``p = 1`` and ``dp = delta``): both sides return fp32
rounding noise there (the bf16 tensor-core kernel sums ``dp`` in another
rounding than the plain GEMM and ``delta``), so such a row has no scale
of its own and is held as an fp32 gradient, its max abs error over the
tensor's max ``|want|``, to ``1e-5``. Whole-model
gradients (flash vs plain attention, fp32, TF32 off): each parameter's max
abs error over its max ``|grad|``, to ``1e-5`` (seen: <= 2e-6). The
weight-only GEMM splits its fp32 sums across blocks in another order than
cuBLAS: fp32 outputs and dx are held as the max abs error over the
tensor's max ``|want|``, to ``1e-5``; in bf16 both sides dequantize with
the same rounding and round one fp32 sum, held per row as above. The
fused LayerNorm and GELU kernels sum rows in another order than the plain
versions and use ``rsqrtf`` / ``tanhf``: fp32 outputs, and the fp32
dgamma / dbeta / dbias sums in both types, held as the max abs error over
the tensor's max ``|want|``, to ``1e-5``; bf16 outputs per row as above.
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
bf16 per row); attention routed to plain ``_sdpa_ref`` (head_dim 96, fp16)
runs the same function as the reference path on the same device and is
held to ``atol/rtol 1e-6`` in fp32 and exactly in fp16. The paged decode
kernel is held like the ragged kernel (fp32 ``FP32_TOL``, bf16 per row),
against its plain version and against the ragged kernel at chunk 1 on the
same pools.
"""
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
    ln_bwd_reference, ln_fwd, ln_fwd_reference)
from paddle_tpu_torch.ops.mega_decode import (
    mega_attn_layer, mega_attn_layer_reference, mega_mlp, mega_mlp_reference)
from paddle_tpu_torch.ops.quant_matmul import (
    quant_matmul, quant_matmul_bwd, quant_matmul_dx_reference,
    quant_matmul_fwd, quant_matmul_reference)
from paddle_tpu_torch.ops.grouped_matmul import (
    grouped_matmul, grouped_matmul_bwd, grouped_matmul_dx_reference,
    grouped_matmul_fwd, grouped_matmul_reference)

pytestmark = pytest.mark.gpu

FP32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_ROW_TOL = 1e-2
BWD_FP32_TOL = 1e-5
GRAD_TOL = 1e-5
QMM_FP32_TOL = 1e-5


def _assert_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **FP32_TOL)
        return
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    worst = (diff / scale).max().item()
    assert worst <= BF16_ROW_TOL, (
        f"bf16 row error {worst:.3e} of the row's max |want| > "
        f"{BF16_ROW_TOL}")


def _assert_bwd_close(got, want, zero_rows=None):
    """A bf16 gradient ``[b, s, h, d]``: rows per ``_assert_close``; the
    ``zero_rows`` (``[s]`` bool: dq of the queries that see one key) to
    ``BWD_FP32_TOL`` of the tensor's max ``|want|``."""
    if zero_rows is None or not zero_rows.any():
        _assert_close(got, want, torch.bfloat16)
        return
    zero = zero_rows.view(1, -1, 1).expand(got.shape[:-1])
    _assert_close(got[~zero], want[~zero], torch.bfloat16)
    err = ((got[zero].float() - want[zero].float()).abs().max()
           / want.float().abs().max())
    assert err.item() <= BWD_FP32_TOL, err.item()


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 512, 512, 12, 12, 64, True),
                                   (2, 200, 200, 8, 2, 64, True),
                                   (2, 64, 300, 4, 4, 128, True),
                                   (2, 300, 100, 4, 1, 64, True),
                                   (2, 130, 77, 6, 3, 64, False)])
def test_flash_kernel_matches_plain(cuda, dtype, shape):
    _check_flash_fwd(cuda, dtype, shape, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


# bf16 only (fp32 is built for d 64 / 128): every head dim the reference's
# configs use, with sq < sk (causal offset) and GQA, ragged tails, rows
# that see no key (sq > sk causal), non-causal, GQA 8 with ragged tails on
# both sides, and one query row
TC_SHAPES = [(2, 200, 456, 12, 4, 32, True),
             (2, 333, 333, 8, 8, 80, True),
             (1, 300, 100, 6, 2, 96, True),
             (2, 130, 77, 4, 4, 96, False),
             (1, 257, 515, 16, 2, 128, True),
             (2, 64, 300, 4, 1, 80, False),
             (1, 1, 129, 4, 4, 64, True)]


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_flash_tc_kernel_matches_plain_at_every_head_dim(cuda, shape):
    _check_flash_fwd(cuda, torch.bfloat16, shape, 4)


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_flash_tc_bwd_kernel_matches_plain_at_every_head_dim(cuda, shape):
    _check_flash_bwd(cuda, torch.bfloat16, shape, 5)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 1536), (2048, 768), (77, 200),
                                   (9, 1001), (16, MAX_H)])
@pytest.mark.parametrize("res", [False, True])
def test_ln_kernels_match_plain(cuda, dtype, shape, res):
    """LN forward (with and without the residual) and backward (with and
    without ``dso``) against their plain versions: the flagship and GPT-125M
    shapes, a ragged row, a width that takes no 16-byte vectors, the widest
    row."""
    rows, h = shape
    rng = np.random.RandomState(8)
    x, r, dy, dso = (_rand(rng, shape, cuda, dtype) for _ in range(4))
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 6144), (2048, 3072), (77, 200),
                                   (9, 1001)])
@pytest.mark.parametrize("has_bias", [False, True])
def test_gelu_kernels_match_plain(cuda, dtype, shape, has_bias):
    rows, n = shape
    rng = np.random.RandomState(9)
    x = _rand(rng, shape, cuda, dtype, 2.0)
    dy = _rand(rng, shape, cuda, dtype)
    bias = _rand(rng, (n,), cuda, dtype, 0.5) if has_bias else None
    f0, b0 = gelu_fwd.launches, gelu_bwd.launches
    y = gelu_fwd(x, bias)
    torch.cuda.synchronize()
    assert gelu_fwd.launches == f0 + 1
    _fused_err(y, gelu_fwd_reference(x, bias), dtype)
    dx, db = gelu_bwd(dy, x, bias)
    torch.cuda.synchronize()
    assert gelu_bwd.launches == b0 + 1
    want_dx, want_db = gelu_bwd_reference(dy, x, bias)
    _fused_err(dx, want_dx, dtype)
    assert (db is None) == (not has_bias)
    if has_bias:
        _fused_err(db, want_db, torch.float32)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 768, 3072, 128), (15, 200, 640, 40)])
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
# one expert empty), a prefill-sized skewed split, and an odd shape with an
# empty and a 1-row expert
GMM_SHAPES = {
    "serving_w1": (768, 3072, [30, 0, 11, 7], 128),
    "serving_w2": (3072, 768, [30, 0, 11, 7], 128),
    "prefill": (768, 3072, [2400, 900, 0, 796], 128),
    "odd": (136, 72, [5, 0, 1, 9, 3], 8),
}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(GMM_SHAPES))
@pytest.mark.parametrize("weights", ["fp", "int8", "int8g", "int4g"])
def test_grouped_matmul_kernels_match_plain(cuda, dtype, shape, weights):
    """Forward and dx of the ragged grouped GEMM against their plain
    versions; the empty expert's NaN weights never reach the output (its
    tiles read nothing). int4 dx is the plain contraction on both sides."""
    x, w, scales, offs = _gmm_inputs(shape, weights, dtype, cuda)
    name = "fp" if weights == "fp" else weights[:4]
    before = dict(grouped_matmul_fwd.launches)
    got = grouped_matmul_fwd(x, w, offs, scales)
    torch.cuda.synchronize()
    assert grouped_matmul_fwd.launches[name] == before[name] + 1
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


def test_grouped_matmul_grad_wiring(cuda):
    """dx by the backward kernel and fp dw by the per-expert segment
    products equal the plain version's autograd gradients (fp32); int8
    weights take no gradient."""
    rng = np.random.RandomState(9)
    counts = [7, 0, 40, 1]
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=cuda)
    x = _rand(rng, (48, 96), cuda, torch.float32).requires_grad_()
    w = _rand(rng, (4, 96, 80), cuda, torch.float32, 0.1).requires_grad_()
    r = _rand(rng, (48, 80), cuda, torch.float32)
    (grouped_matmul(x, w, offs) * r).sum().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    (grouped_matmul(x, w, offs, use_kernel=False) * r).sum().backward()
    _qmm_err(gx, x.grad, torch.float32)
    _qmm_err(gw, w.grad, torch.float32)
    qw = quantize_weight(w.detach(), "int8", 32)
    x.grad = None
    before = grouped_matmul_bwd.launches["int8"]
    (grouped_matmul(x, qw["q"], offs, qw["s"]) * r).sum().backward()
    assert grouped_matmul_bwd.launches["int8"] == before + 1
    assert grouped_matmul(x.detach(), qw["q"], offs, qw["s"]).grad_fn is None


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
    """head_dim 96 and fp16 attention run plain ``_sdpa_ref`` on the card
    instead of raising, equal to it; a d 96 ``gpt_spmd`` step runs."""
    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.nn.functional import attention as A

    rng = np.random.RandomState(13)
    for d, dtype in ((96, torch.float32), (64, torch.float16)):
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
# MQA and the other head dims
DECODE_GEOMS = [(8, 12, 12, 64, 64, 16), (5, 16, 2, 128, 16, 9),
                (5, 12, 4, 96, 16, 9), (4, 8, 1, 80, 16, 9),
                (4, 4, 4, 32, 16, 9)]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", DECODE_GEOMS)
def test_paged_decode_kernel_matches_plain(cuda, dtype, geom):
    args = _decode_inputs(np.random.RandomState(3), *geom, cuda, dtype)
    before = paged_attention.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_reference(*args)
    _assert_close(got[1:].float(), want[1:].float(), dtype)
    assert torch.count_nonzero(got[0]) == 0           # the empty slot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", DECODE_GEOMS[:3])
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


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
