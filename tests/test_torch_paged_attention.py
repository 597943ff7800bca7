"""Port ragged paged attention (plain path, CPU) against the JAX package's
jnp ``ragged_paged_attention_reference`` on the same seeded inputs.

Only valid rows (``row < q_lens[b]``) are compared: past ``q_lens`` the
TPU kernel leaves garbage and both references write zeros. fp32,
``atol 1e-5`` (both gather and reduce in fp32, in different orders).
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


def test_int8_scales_raise():
    arrs = [torch.from_numpy(a) for a in _inputs(0, 2, 4, 4, 4, 8, 8, 2)]
    scales = torch.ones(arrs[1].shape[:3])
    with pytest.raises(NotImplementedError, match="quantized-KV"):
        ragged_paged_attention(*arrs, k_scales=scales, v_scales=scales)
