"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: on a machine without CUDA every test skips with a reason
(decided inside the ``cuda`` fixture, never at import). On the card run

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_kernels.py -q

(``--noconftest``: the suite's conftest imports JAX, which a CUDA machine
need not have; this file imports only torch and the port.)

Tolerances: fp32 kernels sum in another order than the plain version and
use ``expf`` — ``atol 2e-5, rtol 1e-4`` on outputs of magnitude <= ~3.
In bf16 both sides round an fp32 result to 8 mantissa bits once, so an
element may differ by one bf16 step (<= 2^-7 of it): each row's (last
axis) max abs error is held to ``1e-2`` of the row's max ``|want|``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                  flash_attention_reference)
from paddle_tpu_torch.ops.paged_attention import (
    ragged_paged_attention, ragged_paged_attention_reference)

pytestmark = pytest.mark.gpu

FP32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_ROW_TOL = 1e-2


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 512, 512, 12, 12, 64, True),
                                   (2, 200, 200, 8, 2, 64, True),
                                   (2, 64, 300, 4, 4, 128, True),
                                   (2, 300, 100, 4, 1, 64, True),
                                   (2, 130, 77, 6, 3, 64, False)])
def test_flash_kernel_matches_plain(cuda, dtype, shape):
    b, sq, sk, hq, hkv, d, causal = shape
    rng = np.random.RandomState(1)
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
