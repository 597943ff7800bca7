"""Which activation dtypes each kernel family of the port takes.

Every family (ragged / decode attention, fused LN / GELU, weight-only GEMM,
grouped GEMM, mega) has one pure predicate, ``kernel_takes(dtype)``,
decided from the dtype before any launch: the kernels are built for fp32,
bf16 and fp16 (C dtype codes 0, 1, 2); a CUDA tensor of another dtype (fp64)
runs the family's plain twin on the card, and the wrapper counts that
route in ``.twin_routes`` (the card checks are in
``test_torch_gpu_kernels.py``). Flash attention decides by dtype and head
dim (``HEAD_DIMS``). The CPU path runs the plain versions whatever the
dtype and counts no route.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import (_build, flash_attention, fused_mlp,
                                  grouped_matmul, mega_decode,
                                  paged_attention, quant_matmul)

FAMILIES = {
    "paged_attention": (paged_attention, ("ragged_paged_attention",
                                          "paged_attention")),
    "fused_mlp": (fused_mlp, ("ln_fwd", "ln_bwd", "gelu_fwd", "gelu_bwd")),
    "quant_matmul": (quant_matmul, ("quant_matmul_fwd", "quant_matmul_bwd")),
    "grouped_matmul": (grouped_matmul, ("grouped_matmul_fwd",
                                        "grouped_matmul_bwd")),
    "mega_decode": (mega_decode, ("mega_attn_layer", "mega_mlp")),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("dtype,takes", [
    (torch.float32, True), (torch.bfloat16, True), (torch.float16, True),
    (torch.float64, False), (torch.int8, False)])
def test_kernel_takes_is_decided_by_dtype(family, dtype, takes):
    module, _ = FAMILIES[family]
    assert module.kernel_takes(dtype) is takes


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_wrappers_count_twin_routes(family):
    """fp64 still routes to the twins on the card: every wrapper keeps its
    integer ``.twin_routes`` count for it."""
    module, wrappers = FAMILIES[family]
    assert not module.kernel_takes(torch.float64)
    for name in wrappers:
        assert isinstance(getattr(module, name).twin_routes, int), name


@pytest.mark.parametrize("dtype,code", [
    (torch.float32, 0), (torch.bfloat16, 1), (torch.float16, 2)])
def test_dtype_codes_of_the_c_entries(dtype, code):
    assert _build.dtype_code(dtype, "test") == code


def test_dtype_code_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError, match="float16"):
        _build.dtype_code(torch.float64, "test")


def test_flash_head_dims_take_fp16_as_bf16():
    """The fp16 flash kernels are the bf16 templates' fp16 instances: the
    same head dims, and no CPU tensor is taken whatever its dtype."""
    dims = flash_attention.HEAD_DIMS
    assert dims[torch.float16] == dims[torch.bfloat16] == (32, 64, 80, 96,
                                                           128)
    q = torch.zeros(1, 4, 2, 64, dtype=torch.float16)
    assert not flash_attention.kernel_takes(q, q)


def test_fp16_takes_the_tensor_core_gemm_routes():
    """fp16 goes where bf16 goes: the weight-only GEMM's and the grouped
    GEMM's tensor-core routes, never the fp32 CUDA-core kernels."""
    for dtype in (torch.bfloat16, torch.float16):
        assert quant_matmul.qmm_plan(24, 768, 2304, 1, dtype, False, False,
                                     True, 132).route == "tc"
        assert grouped_matmul._plan(48, 4, 768, 3072, 8, False, dtype, True,
                                    132).route == "sk"
        assert grouped_matmul._plan(48, 4, 768, 3072, 0, False, dtype, True,
                                    132).route == "tc"
    assert quant_matmul.qmm_plan(24, 768, 2304, 1, torch.float32, False,
                                 False, True, 132).route == "cc"


def test_cpu_fp16_runs_the_plain_versions_without_a_route():
    """On the CPU every dtype takes the plain version (no kernel, no
    route): an fp16 ragged call equals the fp32 plain version's result
    rounded to fp16."""
    rng = np.random.RandomState(0)
    b, chunk, h, d, ps, pps = 2, 3, 2, 16, 4, 3
    q = torch.from_numpy(rng.randn(b, chunk, h, d).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.randn(b * pps, ps, h, d).astype(
        np.float32)) for _ in range(2))
    pt = torch.arange(b * pps, dtype=torch.int32).reshape(b, pps)
    kv_lens = torch.tensor([7, 12], dtype=torch.int32)
    q_lens = torch.tensor([2, 3], dtype=torch.int32)
    fn = paged_attention.ragged_paged_attention
    before = fn.twin_routes, fn.launches
    got = fn(q.half(), kp.half(), vp.half(), pt, kv_lens, q_lens)
    want = fn(q.half().float(), kp.half().float(), vp.half().float(), pt,
              kv_lens, q_lens)
    assert got.dtype == torch.float16
    torch.testing.assert_close(got, want.half())
    assert (fn.twin_routes, fn.launches) == before
