"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout. Phases (each failure ends the run non-zero):

1. device: the card's name and power limit;
2. build: the eight kernel sources from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, started together), with ``ptxas -v``
   registers and spills;
3. ragged paged attention vs its plain version at the serving shapes
   (b 8, chunk 16, 12 heads, d 64, page 64, 16 pages per sequence),
   fp32 and bf16, with kernel / plain / bound times;
4. flash attention forward vs its plain version at the full-forward
   shape [4, 512, 12, 64] causal, plus ``sq != sk`` and a ragged tail, fp32
   and bf16; the bf16 tensor-core kernel at head_dim 32 / 80 / 96 / 128
   (``FLASH_TC_CASES``: GQA, the causal offset, ragged tails, rows that see
   no key, non-causal) and at [1, 4096, 16, 128] causal; times with the
   achieved TFLOP/s and share of the bound beside plain and SDPA;
5. full forward: GPT-125M logits on ids [4, 512] with the flash kernel
   against the same model with plain attention;
6. serving: ``ServingPredictor`` on GPT-125M in fp32 (TF32 off), 8
   requests of 5-300 prompt tokens and 32 new tokens, two sharing a
   prefix past one page (one of them forcing a copy-on-write); every
   greedy token and the step's logits row behind it are checked against
   the full forward over the served context, the streams must hold at
   least ``MIN_DISTINCT`` distinct tokens, and every step must run the
   ragged kernel once per layer. Then the same requests in bf16, timed
   (median of 5 runs);
7. train: the flash backward kernel vs its plain version at the training
   shape [8, 1024, 12, 128] causal and at odd shapes (``sq != sk``, GQA,
   ragged tails, non-causal), fp32 and bf16, the bf16 kernel at
   ``FLASH_TC_CASES`` and [1, 4096, 16, 128], with kernel / plain / bound
   times, TFLOP/s and SDPA's backward as the library yardstick, and the
   forward kernel vs its plain version at the training shape; the eager
   GPT-125M forward and backward with flash vs plain attention (every parameter
   gets the same gradient, none is ``None``); ``build_spmd_train_step`` in
   fp32 (TF32 off) at gpt3-760m's width and 2 layers, flash vs plain
   attention for the loss, every gradient leaf and 3 steps' losses; the
   same in bf16 at 12 heads of 128 and at 16 heads of 96 (2 layers, loss
   and every leaf, 2 + 2 flash launches); then the flagship training
   configuration (``bench.py``'s gpt3-760m: h 1536,
   24 layers, 12 heads, vocab 50304, batch 8, seq 1024, bf16, recompute
   with the flash outputs saved, num_micro 1, momentum SGD at lr 1e-4),
   timed: step ms, tokens/s and MFU, with 24 forward and 24 backward flash
   launches per step.
8. quantized serving (run between phases 6 and 7, while the GPT-125M
   model is on the card): the weight-only GEMM kernels (int8 per channel,
   int8 and int4 with groups of 128) forward and dx vs their plain
   versions at the four serving shapes [24, K] x [K, N] and an odd shape,
   fp32 and bf16, with kernel / plain / bound times, ``_weight_int8pack_mm``
   as the int8 yardstick where the card's torch has it, and cuBLAS on a
   pre-dequantized weight logged beside them; the ragged kernel's int8-KV
   branch vs its plain version; then ``ServingPredictor`` on GPT-125M with
   (a) int8 weights, (b) int4 weights in groups of 128, (c) int8 weights
   and an int8 KV cache, the phase-6 requests in fp32: every greedy token
   and its logits row against a plain quantized forward over the served
   context (the same quantized params through the plain GEMM; in (c) K
   and V through the int8 write's quantize-dequantize), 12 ragged and 48
   weight-only GEMM launches per step; the gradient of a loss with respect
   to the input embeddings through the 12 quantized layers (the backward
   kernels) vs the plain versions; token agreement with phase 6, weight
   and KV bytes, and the bf16 step time of (a) and (c).
9. fused MLP (its steps run beside their phase-7 twins): the LN forward
   (with and without the residual), LN backward (with and without dso),
   GELU forward and backward (with and without the bias) kernels vs their
   plain versions at the flagship shapes LN [8192, 1536] and GELU
   [8192, 6144], GPT-125M's [2048, 768] / [2048, 3072] and an odd
   [77, 200], fp32 and bf16, with kernel / plain / bound times and
   ``F.layer_norm``, ``native_layer_norm_backward``, ``F.gelu`` and
   ``gelu_backward`` as the yardsticks of the variants they compute; the
   eager GPT-125M with ``fused_mlp`` on ids [4, 512] against the same
   weights unfused (logits and every gradient, fp32); the fp32 760M-width
   2-layer step with recompute, fused with and without ``remat_save_ln``
   against unfused (loss, every gradient leaf, 3 steps' losses); then the
   flagship bf16 step with ``fused_mlp=True``, timed beside phase 7's
   unfused step, with 96 LN forward, 48 LN backward, 48 GELU forward and
   24 GELU backward launches a step, and one profiled step.

10. mega serving (run after phase 8, while GPT-125M is on the card): the
   mega attention and mega MLP kernels vs their plain versions at the
   serving shapes (8 lanes of chunk 16 with an idle lane, a first chunk
   and contexts to 1024 tokens, h 768, 12 heads of 64, page 64; MLP 128 x
   768 x 3072) and an odd shape (5 lanes of chunk 3, 4 heads, ffn 640,
   int8 in groups of 64), fp32 and bf16, fp / int8 per channel / int8 g128
   weights, fp / int8 KV, with and without the fused epilogue (int8
   payloads one step apart counted and held under 1%), with kernel /
   plain / bound times and the one-layer per-op step on the same inputs;
   then ``ServingPredictor(mega_decode=True)`` with the phase-6 requests
   in fp32: (i) fp weights against phase 6's streams and the full-forward
   oracle, (ii) int8 weights and (iii) int8 g128 weights with an int8 KV
   cache against their per-op streams and the plain quantized forward,
   12 launches of each mega kernel a step and none of the ragged kernel
   or the weight-only GEMM; bf16 step times of (i) and (iii) beside their
   per-op twins (median of 5 runs each, in turns) and one profiled run of
   each.

11. MoE serving (run after phase 10): the five grouped-GEMM kernels
   (fp, int8 per channel, int8 and int4 in groups of 128; forward and dx)
   vs their plain versions at (a) the serving rows (48 over 4 experts, one
   empty; w1 768 x 3072, w2 3072 x 768), (b) the prefill rows (4,096,
   skewed, one empty) and (c) an odd shape (5 experts, K 136, N 72, groups
   of 8, an empty and a 1-row expert), fp32 and bf16, the empty experts'
   weights NaN; kernel / plain / bound times at (a) and (b) with
   ``torch._grouped_mm`` as the yardstick of bf16 fp weights; then
   ``ServingPredictor`` on GPT-125M with 4 experts, top-2, and the phase-6
   requests in fp32: (i) capacity factor 4.0 against the full-forward
   oracle, (ii) 1.25 against the same step with the plain grouped GEMM
   (router flips of one step counted), (iii) int8 and (iv) int4 g128
   weights at 4.0 against the full forward over the dequantized weights;
   24 grouped-GEMM and 12 ragged launches a step (and 24 weight-only GEMM
   launches with (iii) / (iv)), none of the mega kernels; the router's
   load imbalance and drop rate on an eager probe; the bf16 MoE step
   beside phase 6's dense step, one profiled run, and the weight bytes;
   the eager 2-layer MoE model's gradients, kernel vs plain (4 dx
   launches), and an input gradient through int8 expert stacks; last, the
   attention routing: a 2-layer gpt3-760m-width model (head_dim 96) and
   an fp16 GPT-125M forward equal to the plain path's logits with no flash
   launch, and one d 96 ``gpt_spmd`` training step.

12. legacy serving (run after phase 11): (a) the paged decode kernel vs
   its plain version and vs the ragged kernel at chunk 1 on the same pools,
   at phase 3's serving pools (8 slots, 12 heads of 64, page 64, lengths
   0, 1, 64, 65 and up to 1,024, -1 entries past each context) and at GQA
   16/2 and 12/4, MQA 8/1, page 16, head dims 32 / 80 / 96 / 128, fp32
   and bf16, with kernel / plain / bound times at the serving pools; (b)
   the ragged kernel vs its plain version at head dims 32 / 80 / 96 with
   fp and int8 KV; (c) ``ServingPredictor(unified=False)`` on GPT-125M
   with the phase-6 requests in fp32: (i) fp weights against the
   full-forward oracle and phase 6's unified streams, (ii) int8 weights
   against the plain quantized forward and phase 8 (a)'s streams, 12
   decode-kernel launches a decode step and none of the ragged kernel (48
   weight-only GEMM launches a program run in (ii)); bf16 legacy and
   unified runs in turns (medians of 5: the generate wall and the mean
   step) and one profiled legacy run; (d) gpt3-760m's width at 2 layers
   (16 heads of 96) served fp32 through the per-op unified step and the
   legacy path, both against the full forward.

Kernel times are device times: the calls are captured in a CUDA graph and
the graph is replayed between CUDA events.

Weights are random, drawn from a numpy seed. The last three lines are the
per-kernel JSON summary, the ``nvidia-smi`` card line and ``{"ok": true,
"device": ...}``. Without a
CUDA device, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import copy
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12,     # fp32 outside the tensor cores
            torch.bfloat16: 989e12}   # dense bf16 tensor cores
RAGGED_GEOM = dict(b=8, chunk=16, hq=12, hkv=12, d=64, ps=64, pps=16)
FLASH_SHAPE = (4, 512, 12, 64)
# phases 4 and 7: the bf16 tensor-core kernels at every head dim of the
# reference's configs, (b, sq, sk, hq, hkv, d, causal): d 32 with sq < sk
# (causal offset) and GQA 3, d 80 with a ragged tail, gpt3-760m's 16 heads
# of 96, rows that see no key (sq > sk causal), d 128 with GQA 8 and ragged
# tails, non-causal with sq > sk; then a long sequence, [b, s, heads, d]
FLASH_TC_CASES = ((2, 200, 456, 12, 4, 32, True),
                  (2, 333, 333, 8, 8, 80, True),
                  (2, 1024, 1024, 16, 16, 96, True),
                  (1, 300, 100, 6, 2, 96, True),
                  (2, 515, 515, 16, 2, 128, True),
                  (2, 130, 77, 4, 4, 80, False))
FLASH_LONG = (1, 4096, 16, 128)
# fp32: another summation order and expf, held as max abs error. bf16: both
# sides round an fp32 result to 8 mantissa bits once, so an element may
# differ by one bf16 step (<= 2^-7 of it); held as each row's max abs error
# over the row's max |value|, so a row of small values is held to its scale.
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
LOGIT_TOL = 1e-3      # fp32 logits after 12 layers, flash vs plain
TIE_MARGIN = 1e-4     # greedy mismatches allowed only below this margin
MAX_NEW = 32
# served fp32 streams must vary: at least this many distinct tokens among
# the 256 (8 constant streams give at most 8), and no constant stream
MIN_DISTINCT = 32
BF16_RUNS = 5
# phase 7. The flagship training configuration (bench.py's gpt3-760m leg)
TRAIN = dict(vocab_size=50304, hidden_size=1536, num_layers=24, num_heads=12,
             max_seq_len=1024, recompute=True, remat_save_attn=True)
TRAIN_BATCH, TRAIN_STEPS = 8, 4          # one warm-up step, three timed
BWD_SHAPE = (8, 1024, 12, 128)           # its attention: [b, s, heads, d]
# backward kernel vs plain: fp32 held as max abs error over the tensor's
# max |value| (atomics and another summation order; seen <= 1.2e-6). bf16
# per row as in KERNEL_TOL: dq, dk, dv each round an fp32 sum to bf16 once,
# so a row may differ by one bf16 step of its max (<= 2^-7, seen 7.7e-3);
# 1e-2 admits one step and not two
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# flash vs plain attention through whole models in fp32: per gradient leaf,
# max abs error over the leaf's max |value| (seen <= 1.8e-6); losses
# relative (seen 0)
GRAD_TOL = 1e-5
LOSS_TOL = 1e-6
# flash vs plain attention through the bf16 training step (2 layers, b 2,
# s 1024): the kernels round P and dS to bf16 per tile, the plain path its
# scores, probabilities and products where cuBLAS and softmax return them,
# and every gradient leaf is rounded to bf16 (one step <= 2^-7 of it): per
# leaf, max abs error over the leaf's max |grad|; the loss relative
BF16_GRAD_TOL = 2e-2
BF16_LOSS_TOL = 1e-2
# phase 8. The weight-only GEMM splits its fp32 sums across blocks in
# another order than cuBLAS: fp32 held as max abs error over the tensor's
# max |value| (as BWD_TOL); bf16 per row as in KERNEL_TOL (both sides
# dequantize with the same rounding, then round one fp32 sum).
QMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
QMM_SHAPES = {"wqkv": (768, 2304), "wo": (768, 768), "w1": (768, 3072),
              "w2": (3072, 768)}          # GPT-125M's [K, N] projections
QMM_ROWS = 24                             # the serving token budget
QMM_CONFIGS = (("int8", -1), ("int8", 128), ("int4", 128))
# (label, config fields, logits tolerance). Served logits vs the plain
# quantized forward in fp32: the GEMMs sum in another order (seen 4.3e-6);
# with int8 KV the step quantizes K and V computed by the kernel and the
# oracle those computed by the plain GEMM, so an entry at a rounding
# boundary may land one int8 step (1/127 of its row's absmax) apart, and
# a few such entries move the logits by more (seen 4.5e-3)
# phase 9. The fused LN / GELU kernels vs their plain versions: fp32 held
# as max abs error over the tensor's max |value| (another summation order,
# rsqrtf / tanhf), bf16 per row as in KERNEL_TOL (one rounding of an fp32
# result each side); the fp32 parameter sums as fp32.
FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FUSED_LN_SHAPES = ((8192, 1536), (2048, 768), (77, 200))   # flagship,
FUSED_GELU_SHAPES = ((8192, 6144), (2048, 3072), (77, 200))  # 125M, odd
# operations an element: LN forward 8 (+1 with the residual), backward 14
# (+1 with dso), GELU forward 20 and backward 32, a tanh counted as 10;
# all fp32 on the CUDA cores (PEAK_OPS[float32]), whatever the input type
FUSED_OPS = {"ln_fwd": 8, "ln_bwd": 14, "gelu_fwd": 20, "gelu_bwd": 32}
# fused vs unfused fp32 training: the fused LN takes its variance by the
# two-pass formula, the unfused by torch.var, so activations differ in the
# last bits and three SGD steps carry that into the losses
FUSED_LOSS_TOL = 1e-5
# phase 10. The mega kernels keep every rounding of their plain versions
# and sum in another order (heads and ffn tiles in a fixed order, not
# cuBLAS's): fp32 held as max abs error over the tensor's max |value|, bf16
# per row as in KERNEL_TOL, on the rows each lane feeds. An int8 K / V
# payload may land one step apart where its fp32 row sits on a rounding
# boundary (allowed in under MEGA_FLIP_FRAC of the entries); what attends
# it then moves, and the fp32 outputs are held to MEGA_KV_TOL instead.
MEGA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
MEGA_KV_TOL = 1e-3
MEGA_FLIP_FRAC = 0.01
# (b, chunk, h, heads, head_dim, page, pages a lane, ffn), q_lens, and the
# contexts already in the pool: an idle lane, a first full chunk (ctx 0), a
# full chunk on a context, decode rows and ragged chunks up to 1024 tokens
MEGA_SERVING = ((8, 16, 768, 12, 64, 64, 16, 3072),
                [0, 1, 16, 7, 1, 16, 12, 1],
                [0, 1008, 984, 326, 63, 0, 688, 516])
MEGA_ODD = ((5, 3, 256, 4, 64, 16, 4, 640), [0, 3, 2, 1, 3],
            [0, 0, 37, 50, 12])
MEGA_WEIGHTS = ((None, -1), ("int8", -1), ("int8", 128))
MEGA_SERVE = (("i fp", {}, None),
              ("ii int8", dict(weight_dtype="int8"), 1e-4),
              ("iii int8 g128 + int8 KV",
               dict(weight_dtype="int8", weight_quant_group_size=128,
                    kv_cache_dtype="int8"), 2e-2))
# phase 11. MoE serving: GPT-125M with 4 experts, top-2 (the reference's
# bench_serving_moe_ab). The grouped GEMM is the weight-only GEMM per
# expert (the same tiles, dequantization and split sums): held as QMM_TOL.
MOE = dict(moe_experts=4, moe_top_k=2)
GMM_TOL = QMM_TOL
GMM_SHAPES = {"w1": (768, 3072), "w2": (3072, 768)}   # an expert's [K, N]
GMM_ROWS = [30, 0, 11, 7]          # (a) 24 tokens x top-2, one expert empty
GMM_PREFILL = [2400, 0, 900, 796]  # (b) 2 x 4 x 512 rows, skewed
GMM_ODD = (136, 72, [5, 0, 1, 9, 3], 8)   # (c) K, N, rows, scale group
GMM_WEIGHTS = (("fp", None, -1), ("int8", "int8", -1),
               ("int8 g128", "int8", 128), ("int4 g128", "int4", 128))
# (label, capacity factor, quantization): cf 4.0 drops nothing, so the
# full forward is an exact oracle; 1.25 is the reference's production
# setting, held against the same step with the plain grouped GEMM
MOE_SERVE = (("i cf 4.0", 4.0, {}), ("ii cf 1.25", 1.25, {}),
             ("iii int8 cf 4.0", 4.0, dict(weight_dtype="int8")),
             ("iv int4 g128 cf 4.0", 4.0,
              dict(weight_dtype="int4", weight_quant_group_size=128)))
QUANT_SERVE = (("a int8", dict(weight_dtype="int8"), 1e-4),
               ("b int4 g128", dict(weight_dtype="int4",
                                    weight_quant_group_size=128), 1e-4),
               ("c int8 + int8 KV", dict(weight_dtype="int8",
                                         kv_cache_dtype="int8"), 2e-2))
# phase 12. The paged decode kernel (row 4) and the legacy two-program path.
# ((b, hq, hkv, d, page, pages a slot), the slots' lengths): phase 3's
# serving pools with an empty slot, one token, one page, one past it and
# 1,024 tokens; then GQA 16/2 and 12/4 and MQA 8/1 at page 16, across the
# head dims the reference's configs use. Held as KERNEL_TOL, against the
# plain version and against the ragged kernel at chunk 1 (another kernel
# summing in another order: the same tolerance)
DECODE_SERVING = ((8, 12, 12, 64, 64, 16), [0, 1, 64, 65, 1024, 1000, 700,
                                            517])
DECODE_ODD = (((5, 16, 2, 128, 16, 9), [0, 1, 16, 17, 144]),
              ((5, 12, 4, 96, 16, 9), [0, 1, 16, 17, 140]),
              ((4, 8, 1, 80, 16, 9), [0, 1, 33, 144]),
              ((4, 4, 4, 32, 16, 9), [0, 7, 16, 130]))
# the ragged kernel at gpt3-tiny's, gpt3-2.7b's and gpt3-760m's head dims:
# phase 3's lanes with gpt3-760m's 16 heads
RAGGED_DIMS = (32, 80, 96)
# served through both paths at d 96: gpt3-760m's width at 2 layers
LEGACY_D96_LAYERS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters=50, replays=4) -> float:
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's launch cost is not in the figure (warm L2, as inside a serving
    step)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def kernel_error(got, want, dtype):
    """(max abs error, the error held against ``KERNEL_TOL[dtype]``): the
    max abs error in fp32; in bf16 the largest over rows (the last axis) of
    the row's max abs error over its max |want|."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if dtype == torch.float32:
        return err, err
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    return err, (diff.amax(-1) / scale).max().item()


def bound_ms(nbytes: float, ops: float, dtype) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])


def ptxas_summary(name: str, text: str):
    """One line per compiled instantiation (kernel, element type, first
    template value: head_dim or a flag) with its registers and spills, from
    the ``ptxas -v`` report."""
    inst, spills = None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '.*?\d([a-z_]+_kernel)I"
                      r"(13__nv_bfloat16|f)(?:L[ib](\d+))?", line)
        if m:
            inst = (m.group(1), "bf16" if m.group(2) != "f" else "fp32",
                    m.group(3) or "-")
        elif "spill stores" in line:
            spills = line.strip()
        elif "registers" in line and inst:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            yield (f"{name} {inst[0]}<{inst[1]}, {inst[2]}>: {regs} "
                   f"registers, {spills}")
            inst = None


# -- phase 3 ----------------------------------------------------------------


def ragged_inputs(dtype, dev, g=RAGGED_GEOM):
    b, chunk, hq, hkv, d, ps, pps = (g[k] for k in
                                     ("b", "chunk", "hq", "hkv", "d", "ps",
                                      "pps"))
    rng = np.random.RandomState(SEED)
    num_pages = b * pps + 1
    q = rng.standard_normal((b, chunk, hq, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    q_lens = np.array([0, 1, 16, 7, 1, 16, 12, 1], np.int32)
    kv_lens = np.array([0, 1024, 1000, 333, 64, 16, 700, 517], np.int32)
    for i in range(b):                 # unallocated past each context
        pt[i, (kv_lens[i] + ps - 1) // ps:] = -1
    to = lambda a, t: torch.from_numpy(a).to(dev, t)  # noqa: E731
    return (to(q, dtype), to(kp, dtype), to(vp, dtype), to(pt, torch.int32),
            to(kv_lens, torch.int32), to(q_lens, torch.int32))


def ragged_work(args):
    """(bytes, ops) the function needs on these inputs: the valid q rows
    read, every output row written (rows past q_len as zeros), the K and V
    rows of each lane that has queries read once, the page-table entries
    that cover those contexts and both length vectors read; 2 x 2 x d ops
    per (valid row, visible key)."""
    q, k_pages, _, _, kv_lens, q_lens = args
    b, chunk, hq, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    elt = q.element_size()
    # int8 pools: one byte a value and one fp32 scale a (row, head)
    kv_row_bytes = hkv * (d * k_pages.element_size()
                          + (4 if k_pages.dtype == torch.int8 else 0))
    lanes = [(kv, ql) for kv, ql in zip(kv_lens.tolist(), q_lens.tolist())
             if ql > 0]
    kv_rows = sum(kv for kv, _ in lanes)
    pages = sum(-(-kv // ps) for kv, _ in lanes)
    nbytes = ((sum(ql for _, ql in lanes) + b * chunk) * hq * d * elt
              + 2 * kv_rows * kv_row_bytes + 4 * (pages + 2 * b))
    pairs = sum(min(kv - ql + i + 1, kv) for kv, ql in lanes
                for i in range(ql))
    return nbytes, 4.0 * d * pairs * hq


def phase_ragged(dev):
    from paddle_tpu_torch.ops.paged_attention import (
        ragged_paged_attention as kern,
        ragged_paged_attention_reference as plain)

    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = ragged_inputs(dtype, dev)
        got = kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        q_lens = args[5]
        valid = (torch.arange(got.shape[1], device=dev)[None]
                 < q_lens[:, None])
        err, held = kernel_error(got[valid], want[valid], dtype)
        if not held <= KERNEL_TOL[dtype]:
            raise AssertionError(f"ragged kernel {dtype}: error {held} > "
                                 f"{KERNEL_TOL[dtype]} (max abs {err})")
        if torch.count_nonzero(got[~valid]).item():
            raise AssertionError("ragged kernel: rows past q_len not zero")
        nbytes, nops = ragged_work(args)
        s = dict(max_abs_err=err, ms=time_ms(lambda: kern(*args)),
                 plain_ms=time_ms(lambda: plain(*args), iters=5),
                 bound_ms=bound_ms(nbytes, nops, dtype), library_ms=None,
                 bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                 >= nops / PEAK_OPS[dtype] else "operations")
        stats[dtype] = s
        log(f"[ragged] {str(dtype)[6:]}: max_abs_err {err:.3e}, held "
            f"{held:.3e} (tol {KERNEL_TOL[dtype]}) kernel {s['ms']:.4f} ms, plain "
            f"{s['plain_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
            f"({s['bound_by']}: {nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} "
            "GFLOP), library_ms null (no single PyTorch call reads a paged "
            "pool)")
    return stats


# -- phase 4 ----------------------------------------------------------------


def flash_work(b, sq, sk, hq, hkv, d, causal, elt):
    pairs = sum(min(max(r + sk - sq + 1, 0), sk) for r in range(sq)) \
        if causal else sq * sk
    nbytes = (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * elt \
        + 4 * b * hq * sq
    return nbytes, 4.0 * d * pairs * b * hq


def flash_rate(ms, nbytes, nops, dtype) -> str:
    """Achieved TFLOP/s of a call of ``ms`` and the share of the bound it
    reaches."""
    return (f"{nops / ms / 1e9:.1f} TFLOP/s, "
            f"{bound_ms(nbytes, nops, dtype) / ms:.3f} of the bound")


def flash_inputs(shape, dtype, dev, seed):
    """q, k, v of one ``(b, sq, sk, hq, hkv, d, causal)`` case, drawn from
    a numpy seed."""
    b, sq, sk, hq, hkv, d, _ = shape
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev, dtype) for s in
        ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))


def check_flash_fwd(args, shape, dtype, tag):
    """The forward kernel vs its plain version on one case: out held as
    ``KERNEL_TOL``, lse to 1e-3. Returns the max abs error of out."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_fwd as kern, flash_attention_reference as plain)

    b, sq, sk, hq, hkv, d, causal = shape
    out, lse = kern(*args, causal=causal)
    torch.cuda.synchronize()
    want, want_lse = plain(*args, causal=causal)
    err, held = kernel_error(out, want, dtype)
    lse_err = (lse - want_lse).abs().max().item()
    label = (f"{str(dtype)[6:]} b{b} sq{sq} sk{sk} hq{hq} hkv{hkv} d{d} "
             f"{'causal' if causal else 'non-causal'}")
    if not (held <= KERNEL_TOL[dtype] and lse_err <= 1e-3):
        raise AssertionError(
            f"flash kernel {label}: error {held} (tol {KERNEL_TOL[dtype]}, "
            f"max abs {err}), lse err {lse_err}")
    log(f"{tag} flash fwd {label}: max_abs_err {err:.3e}, held {held:.3e} "
        f"(tol {KERNEL_TOL[dtype]}), lse err {lse_err:.3e}")
    return err


def flash_fwd_times(args, shape, dtype, err, tag, iters, replays,
                    plain_iters, plain_replays):
    """Kernel, plain and SDPA times of one case with its bound, logged with
    the achieved rates; returns the kernels-line fields."""
    import torch.nn.functional as tnf

    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_fwd as kern, flash_attention_reference as plain)

    b, sq, sk, hq, hkv, d, causal = shape
    q = args[0]
    nbytes, nops = flash_work(*shape, q.element_size())
    qt, kt, vt = (x.transpose(1, 2) for x in args)
    st = dict(max_abs_err=err,
              ms=time_ms(lambda: kern(*args, causal=causal), iters=iters,
                         replays=replays),
              plain_ms=time_ms(lambda: plain(*args, causal=causal),
                               iters=plain_iters, replays=plain_replays),
              library_ms=time_ms(lambda: tnf.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=causal), iters=iters,
                  replays=replays),
              bound_ms=bound_ms(nbytes, nops, dtype),
              bound_by="bytes" if nbytes / HBM_BYTES_PER_S
              >= nops / PEAK_OPS[dtype] else "operations")
    log(f"{tag} flash fwd {str(dtype)[6:]} {[b, sq, hq, d]} "
        f"{'causal' if causal else 'non-causal'}: kernel {st['ms']:.4f} ms "
        f"({flash_rate(st['ms'], nbytes, nops, dtype)}), plain "
        f"{st['plain_ms']:.4f} ms, library (torch sdpa) "
        f"{st['library_ms']:.4f} ms "
        f"({flash_rate(st['library_ms'], nbytes, nops, dtype)}), bound "
        f"{st['bound_ms']:.4f} ms ({st['bound_by']}: {nbytes / 1e6:.2f} MB, "
        f"{nops / 1e9:.3f} GFLOP)")
    return st


def phase_flash(dev):
    """The forward kernel vs its plain version: the full-forward shape
    (timed), ``sq != sk`` with GQA and a ragged tail in fp32 and bf16; the
    bf16 tensor-core kernel at every head dim of ``FLASH_TC_CASES`` and at
    ``FLASH_LONG`` (timed)."""
    stats = {}
    cases = [(*FLASH_SHAPE[:2], FLASH_SHAPE[1], FLASH_SHAPE[2],
              FLASH_SHAPE[2], FLASH_SHAPE[3], True),
             (2, 200, 456, 12, 4, 64, True),      # sq != sk, GQA
             (2, 333, 333, 12, 12, 64, True)]     # tail not a tile multiple
    for dtype in (torch.float32, torch.bfloat16):
        for ci, shape in enumerate(cases):
            args = flash_inputs(shape, dtype, dev, SEED + ci)
            err = check_flash_fwd(args, shape, dtype, "[flash]")
            if not ci:
                stats[dtype] = flash_fwd_times(args, shape, dtype, err,
                                               "[flash]", 50, 4, 5, 4)
    for ci, shape in enumerate(FLASH_TC_CASES):
        check_flash_fwd(flash_inputs(shape, torch.bfloat16, dev,
                                     SEED + 10 + ci), shape, torch.bfloat16,
                        "[flash]")
    b, s, h, d = FLASH_LONG
    shape = (b, s, s, h, h, d, True)
    args = flash_inputs(shape, torch.bfloat16, dev, SEED)
    err = check_flash_fwd(args, shape, torch.bfloat16, "[flash]")
    stats["long"] = flash_fwd_times(args, shape, torch.bfloat16, err,
                                    "[flash]", 10, 2, 2, 2)
    return stats


# -- phases 5 and 6 ---------------------------------------------------------


def reset_counts():
    from paddle_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                      flash_attention_fwd)
    from paddle_tpu_torch.ops.paged_attention import (paged_attention,
                                                      ragged_paged_attention)
    from paddle_tpu_torch.ops.quant_matmul import (quant_matmul_bwd,
                                                   quant_matmul_fwd)

    from paddle_tpu_torch.ops import fused_mlp, grouped_matmul, mega_decode

    grouped_matmul.grouped_matmul_fwd.launches = {"fp": 0, "int8": 0,
                                                  "int4": 0}
    grouped_matmul.grouped_matmul_bwd.launches = {"fp": 0, "int8": 0}
    mega_decode.mega_attn_layer.launches = 0
    mega_decode.mega_mlp.launches = 0
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    ragged_paged_attention.launches = 0
    paged_attention.launches = 0
    for fn in (quant_matmul_fwd, quant_matmul_bwd):
        fn.launches = {"int8": 0, "int4": 0}
    for fn in (fused_mlp.ln_fwd, fused_mlp.ln_bwd, fused_mlp.gelu_fwd,
               fused_mlp.gelu_bwd):
        fn.launches = 0


def fused_counts():
    """(LN forward, LN backward, GELU forward, GELU backward) launches
    since :func:`reset_counts`."""
    from paddle_tpu_torch.ops import fused_mlp

    return (fused_mlp.ln_fwd.launches, fused_mlp.ln_bwd.launches,
            fused_mlp.gelu_fwd.launches, fused_mlp.gelu_bwd.launches)


def qmm_counts() -> dict:
    """Weight-only GEMM launches since :func:`reset_counts`, by kernel."""
    from paddle_tpu_torch.ops.quant_matmul import (quant_matmul_bwd,
                                                   quant_matmul_fwd)

    out = dict(quant_matmul_fwd.launches)
    out.update({f"{k}_bwd": v for k, v in quant_matmul_bwd.launches.items()})
    return out


def read_counts():
    """(flash forward, ragged) launches since :func:`reset_counts`."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.ops.paged_attention import ragged_paged_attention

    return flash_attention_fwd.launches, ragged_paged_attention.launches


def bwd_count():
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bwd

    return flash_attention_bwd.launches


def phase_forward(model, cfg, dev):
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (4, 512))).to(dev)
    with torch.no_grad():
        reset_counts()
        logits = model(ids)
        torch.cuda.synchronize()
        flash_n, ragged_n = read_counts()
        cfg.use_flash_attention = False
        plain = model(ids)
        cfg.use_flash_attention = True
    err = (logits - plain).abs().max().item()
    log(f"[forward] GPT-125M ids [4, 512]: logits {tuple(logits.shape)}, "
        f"flash vs plain attention max_abs_err {err:.3e} (tol {LOGIT_TOL}); "
        f"flash launches {flash_n}, ragged launches {ragged_n}")
    if not torch.isfinite(logits).all() or not err <= LOGIT_TOL:
        raise AssertionError(f"full forward: flash vs plain err {err}")
    if flash_n != cfg.num_layers or ragged_n or bwd_count() or any(
            qmm_counts().values()):
        raise AssertionError(f"full forward ran flash {flash_n} times "
                             f"(want {cfg.num_layers}), ragged {ragged_n}, "
                             f"flash backward {bwd_count()}")
    return flash_n


def requests(cfg):
    """Eight prompts of 5-300 tokens. ``late`` ones arrive once the first
    prompt has emitted: ``a + 20 tokens`` attaches all of ``a``'s pages and
    writes into its shared partial page (copy-on-write); the other shares
    ``a``'s first full page, then diverges."""
    rng = np.random.RandomState(SEED + 1)
    draw = lambda n: [int(t) for t in rng.randint(0, cfg.vocab_size, n)]  # noqa: E731
    a = draw(100)
    early = [a, draw(5), draw(37), draw(150), draw(300), draw(64)]
    late = [a + draw(20), a[:80] + draw(40)]
    return early, late


def serve(sp, early, late):
    from paddle_tpu_torch.inference.serving import FAILED, FINISHED

    reqs = [sp.add_request(p, MAX_NEW) for p in early]
    first = reqs[0]
    pending = list(late)
    for _ in range(10_000):
        if pending and first.output_ids:
            reqs += [sp.add_request(p, MAX_NEW) for p in pending]
            pending = []
        if not pending and all(r.state in (FINISHED, FAILED) for r in reqs):
            break
        sp.step()
    else:
        raise AssertionError("serving did not finish")
    failed = [r.error for r in reqs if r.state == FAILED]
    if failed:
        raise AssertionError(f"requests failed: {failed}")
    return reqs


class StepLogits:
    """Stands in for a predictor's unified step and keeps, for every lane
    that emits a token, the logits row the step returned for it, keyed by
    ``(req_id, index of the token in output_ids)``."""

    def __init__(self, sp):
        self.sp, self.step, self.rows = sp, sp._unified, {}
        self.emit_at = inspect.signature(self.step.__call__).parameters
        self.emit_at = list(self.emit_at).index("emit_mask")
        sp._unified = self

    def __call__(self, *args, **kw):
        out = self.step(*args, **kw)
        emit = args[self.emit_at].tolist()
        for slot, req in self.sp.running.items():
            if emit[slot]:
                self.rows[(req.req_id, len(req.output_ids))] = \
                    out[1][slot].clone()
        return out


def check_against_oracle(model, reqs, rows, dev):
    """Teacher-forced greedy oracle: one full forward over prompt + served
    tokens. The step's logits row for each served token must match the
    forward's at that position within ``LOGIT_TOL``, and the token must be
    the argmax there unless the top-2 margin is below ``TIE_MARGIN``.
    Returns (near ties, max abs logit error)."""
    near_ties, logit_err = 0, 0.0
    with torch.no_grad():
        for i, r in enumerate(reqs):
            p, o = list(r.prompt_ids), list(r.output_ids)
            if len(o) != MAX_NEW:
                raise AssertionError(f"request {i}: {len(o)} tokens")
            ids = torch.tensor([p + o[:-1]], device=dev)
            logits = model(ids)[0, len(p) - 1:].float()
            served = torch.stack([rows[(r.req_id, j)] for j in range(len(o))])
            logit_err = max(logit_err,
                            (served - logits).abs().max().item())
            top2 = logits.topk(2, dim=-1)
            want = top2.indices[:, 0].tolist()
            margin = (top2.values[:, 0] - top2.values[:, 1]).tolist()
            for j, (w, g) in enumerate(zip(want, o)):
                if w == g:
                    continue
                if margin[j] < TIE_MARGIN:
                    near_ties += 1
                    log(f"[serve] request {i} token {j}: served {g}, oracle "
                        f"{w}, top-2 margin {margin[j]:.2e} < {TIE_MARGIN}")
                    continue
                raise AssertionError(
                    f"request {i} token {j}: served {g}, oracle {w} "
                    f"(margin {margin[j]:.3e})")
    if not logit_err <= LOGIT_TOL:
        raise AssertionError(f"served logits differ from the full forward's "
                             f"by {logit_err} > {LOGIT_TOL}")
    return near_ties, logit_err


def phase_serve(model, cfg, dev, card):
    from paddle_tpu_torch.inference import ServingPredictor

    early, late = requests(cfg)
    sp = ServingPredictor(model, max_batch=8, device=dev)
    served_logits = StepLogits(sp)
    reset_counts()
    t0 = time.perf_counter()
    reqs = serve(sp, early, late)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash_n, ragged_n = read_counts()
    tel = sp.telemetry()
    steps = sp.steps
    outs = [list(r.output_ids) for r in reqs]
    log(f"[serve] fp32: {len(outs)} requests, {steps} steps, ragged "
        f"launches {ragged_n} (= steps x {cfg.num_layers}: "
        f"{ragged_n == steps * cfg.num_layers}), flash launches {flash_n}, "
        f"prefix-hit tokens {tel['kv_prefix_hit_tokens']:.0f}, CoW copies "
        f"{tel['kv_cow_copies']:.0f}, preemptions "
        f"{tel['serving_preemptions']:.0f}, {wall:.3f} s wall")
    if ragged_n != steps * cfg.num_layers or ragged_n == 0:
        raise AssertionError(f"ragged launches {ragged_n} != steps {steps} "
                             f"x {cfg.num_layers}")
    if tel["kv_cow_copies"] < 1 or tel["kv_prefix_hit_tokens"] < 1:
        raise AssertionError("the shared-prefix requests hit no prefix page "
                             "or made no copy-on-write copy")
    ties, logit_err = check_against_oracle(model, reqs, served_logits.rows,
                                           dev)
    distinct = len({t for o in outs for t in o})
    log(f"[serve] fp32 greedy streams match the full-forward oracle "
        f"({sum(map(len, outs))} tokens, {ties} near-tie positions); served "
        f"logits vs the forward's: max_abs_err {logit_err:.3e} (tol "
        f"{LOGIT_TOL}); {distinct} distinct tokens (floor {MIN_DISTINCT}), "
        f"per request {[len(set(o)) for o in outs]}")
    if distinct < MIN_DISTINCT or min(len(set(o)) for o in outs) < 2:
        raise AssertionError(f"served streams hold only {distinct} distinct "
                             f"tokens (< {MIN_DISTINCT}): too uniform to "
                             "test the step's plumbing")
    # the same requests in bf16: one warm-up run, then BF16_RUNS timed
    # runs (the step is host-bound, so its time varies between runs)
    walls = []
    for run in range(1 + BF16_RUNS):
        sp16 = ServingPredictor(model, max_batch=8, device=dev,
                                dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs16 = [list(r.output_ids) for r in serve(sp16, early, late)]
        torch.cuda.synchronize()
        if run:
            walls.append(time.perf_counter() - t0)
    ntok = sum(map(len, outs16))
    if ntok != MAX_NEW * len(outs16) or not all(
            0 <= t < cfg.vocab_size for o in outs16 for t in o):
        raise AssertionError("bf16 serving produced malformed streams")
    wall = sorted(walls)[len(walls) // 2]
    log(f"[serve] bf16: {ntok} tokens, {sp16.steps} steps per run; median "
        f"of {BF16_RUNS} runs {wall:.3f} s = {ntok / wall:.1f} tokens/s, "
        f"mean step {1e3 * wall / sp16.steps:.3f} ms (runs: "
        f"{', '.join(f'{w:.3f}' for w in walls)} s) ({card})")
    return ragged_n, outs, 1e3 * wall / sp16.steps


# -- phase 8 ----------------------------------------------------------------


def qmm_work(m, k, n, bits, groups, elt):
    """(bytes, ops) of one weight-only GEMM, forward or dx (the same
    traffic): the activations read and the output written once in their
    type, the int8 / packed int4 weight and its fp32 scales read once;
    2 m k n operations."""
    nbytes = (m * k + m * n) * elt + k * n * bits // 8 + 4 * groups * n
    return nbytes, 2.0 * m * k * n


def qmm_case(m, k, n, weight_dtype, gs, dtype, dev, seed):
    """Seeded x [m, k], dy [m, n] and a quantized [k, n] weight (N(0, 0.05)
    cast to ``dtype`` first, as a served model's are)."""
    from paddle_tpu_torch.inference.quantize import quantize_weight

    rng = np.random.RandomState(seed)
    w = torch.from_numpy(0.05 * rng.standard_normal((k, n)).astype(
        np.float32)).to(dev, dtype)
    qw = quantize_weight(w, weight_dtype, gs)
    x, dy = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(
        dev, dtype) for sh in ((m, k), (m, n)))
    return x, dy, qw["q"], qw["s"]


def int8pack_ms(x, q, s):
    """``torch._weight_int8pack_mm`` (int8 per channel, weight [N, K]) on
    the same values, timed and never used; None where the card's torch has
    no CUDA kernel for it."""
    wt = q.t().contiguous()
    sc = s.reshape(-1).to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, wt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, str(e).splitlines()[0][:120]
    return time_ms(lambda: torch._weight_int8pack_mm(x, wt, sc)), None


def phase_qmm(dev):
    """The four weight-only GEMM kernels vs their plain versions; per
    (config, dtype) the summed times of the four serving shapes."""
    from paddle_tpu_torch.ops.quant_matmul import (
        dequantize_weight, quant_matmul_bwd, quant_matmul_dx_reference,
        quant_matmul_fwd, quant_matmul_reference)

    stats = {}
    for wd, gs in QMM_CONFIGS:
        bits = int(wd[3:])
        for dtype in (torch.float32, torch.bfloat16):
            tot = {key: 0.0 for key in ("ms", "plain_ms", "bwd_ms",
                                        "bwd_plain_ms", "bound_ms",
                                        "cublas_ms", "library_ms")}
            errs, lib_note, work = [0.0, 0.0], None, [0.0, 0.0]
            cases = [(QMM_ROWS, *QMM_SHAPES[name], name)
                     for name in QMM_SHAPES] + [(5, 200, 130, "odd")]
            for ci, (m, k, n, name) in enumerate(cases):
                g = gs if name != "odd" or gs < 0 else 40
                x, dy, q, sc = qmm_case(m, k, n, wd, g, dtype, dev,
                                        SEED + ci)
                got = quant_matmul_fwd(x, q, sc)
                dx = quant_matmul_bwd(dy, q, sc, k, dtype)
                torch.cuda.synchronize()
                want = quant_matmul_reference(x, q, sc)
                want_dx = quant_matmul_dx_reference(dy, q, sc, k, dtype)
                held = []
                for i, (a, b) in enumerate(((got, want), (dx, want_dx))):
                    err, h = kernel_error(a, b, dtype)
                    if dtype == torch.float32:
                        h = err / b.abs().max().item()
                    errs[i] = max(errs[i], err)
                    held.append(h)
                if not max(held) <= QMM_TOL[dtype]:
                    raise AssertionError(
                        f"quant_matmul {wd} g{g} {dtype} {name} [{m}, {k}] x "
                        f"[{k}, {n}]: held errors fwd {held[0]}, dx {held[1]} "
                        f"> {QMM_TOL[dtype]}")
                if name == "odd":
                    log(f"[quant] qmm {wd} g{g} {str(dtype)[6:]} odd [5, 200] "
                        f"x [200, 130]: held fwd {held[0]:.3e}, dx "
                        f"{held[1]:.3e} (tol {QMM_TOL[dtype]})")
                    continue
                nbytes, nops = qmm_work(m, k, n, bits, sc.shape[0],
                                        x.element_size())
                work = [work[0] + nbytes, work[1] + nops]
                w_fp = dequantize_weight(q, sc, k=k, out_dtype=dtype)
                t = dict(ms=time_ms(lambda: quant_matmul_fwd(x, q, sc)),
                         plain_ms=time_ms(lambda: quant_matmul_reference(
                             x, q, sc), iters=10),
                         bwd_ms=time_ms(lambda: quant_matmul_bwd(
                             dy, q, sc, k, dtype)),
                         bwd_plain_ms=time_ms(
                             lambda: quant_matmul_dx_reference(
                                 dy, q, sc, k, dtype), iters=10),
                         bound_ms=bound_ms(nbytes, nops, dtype),
                         cublas_ms=time_ms(lambda: x @ w_fp))
                lib = None
                if wd == "int8" and gs < 0:
                    lib, lib_note = int8pack_ms(x, q, sc)
                t["library_ms"] = lib
                for key, v in t.items():
                    tot[key] = None if v is None or tot[key] is None \
                        else tot[key] + v
                log(f"[quant] qmm {wd} g{g} {str(dtype)[6:]} {name} [{m}, {k}]"
                    f" x [{k}, {n}]: held fwd {held[0]:.3e}, dx "
                    f"{held[1]:.3e}; kernel {t['ms']:.4f} ms (dx "
                    f"{t['bwd_ms']:.4f}), plain {t['plain_ms']:.4f} (dx "
                    f"{t['bwd_plain_ms']:.4f}), bound {t['bound_ms']:.4f} "
                    f"({nbytes / 1e6:.3f} MB, {nops / 1e9:.4f} GFLOP), cuBLAS "
                    f"on the pre-dequantized weight (the fp product this "
                    f"replaces) {t['cublas_ms']:.4f}, library "
                    + (f"{lib:.4f}" if lib is not None else "null"))
            tot["bound_by"] = ("bytes" if work[0] / HBM_BYTES_PER_S
                               >= work[1] / PEAK_OPS[dtype] else "operations")
            tot["max_abs_err"], tot["bwd_max_abs_err"] = errs
            stats[(wd, gs, dtype)] = tot
            log(f"[quant] qmm {wd} g{gs} {str(dtype)[6:]}, one layer's four "
                f"GEMMs at M {QMM_ROWS}: kernel {tot['ms']:.4f} ms (dx "
                f"{tot['bwd_ms']:.4f}), plain {tot['plain_ms']:.4f} (dx "
                f"{tot['bwd_plain_ms']:.4f}), bound {tot['bound_ms']:.4f} "
                f"({tot['bound_by']}: {work[0] / 1e6:.2f} MB, "
                f"{work[1] / 1e9:.3f} GFLOP), cuBLAS "
                f"fp product replaced {tot['cublas_ms']:.4f}, library "
                + (f"(torch._weight_int8pack_mm) {tot['library_ms']:.4f}"
                   if tot["library_ms"] is not None else
                   f"null ({lib_note or 'no PyTorch call computes it'})"))
    return stats


def phase_ragged_int8(dev):
    """The ragged kernel's int8-KV branch at the phase-3 geometry: pages
    quantized by the KV write's formula."""
    from paddle_tpu_torch.inference.kv_cache import quantize_kv_rows
    from paddle_tpu_torch.ops.paged_attention import (
        ragged_paged_attention as kern,
        ragged_paged_attention_reference as plain)

    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, pt, kv_lens, q_lens = ragged_inputs(torch.float32, dev)
        hkv, d = kp.shape[2], kp.shape[3]
        (kq, ks), (vq, vs) = (quantize_kv_rows(t.reshape(-1, hkv, d))
                              for t in (kp, vp))
        args = (q.to(dtype), kq.reshape(kp.shape), vq.reshape(vp.shape), pt,
                kv_lens, q_lens)
        sc = dict(k_scales=ks.reshape(kp.shape[:3]),
                  v_scales=vs.reshape(vp.shape[:3]))
        got = kern(*args, **sc)
        torch.cuda.synchronize()
        want = plain(*args, **sc)
        valid = (torch.arange(got.shape[1], device=dev)[None]
                 < q_lens[:, None])
        err, held = kernel_error(got[valid], want[valid], dtype)
        if not held <= KERNEL_TOL[dtype] or torch.count_nonzero(
                got[~valid]).item():
            raise AssertionError(f"ragged int8-KV kernel {dtype}: error "
                                 f"{held} > {KERNEL_TOL[dtype]} or rows past "
                                 "q_len not zero")
        nbytes, nops = ragged_work(args)
        st = dict(max_abs_err=err, ms=time_ms(lambda: kern(*args, **sc)),
                  plain_ms=time_ms(lambda: plain(*args, **sc), iters=5),
                  bound_ms=bound_ms(nbytes, nops, dtype))
        stats[dtype] = st
        log(f"[quant] ragged int8 KV {str(dtype)[6:]}: max_abs_err {err:.3e},"
            f" held {held:.3e} (tol {KERNEL_TOL[dtype]}); kernel "
            f"{st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, bound "
            f"{st['bound_ms']:.4f} ms (bytes: {nbytes / 1e6:.2f} MB, "
            f"{nops / 1e9:.3f} GFLOP)")
    return stats


def quant_forward(params, x, cfg, kv_int8, mm):
    """Plain forward of the serving params over one sequence's embedded
    tokens ``x [s, h]`` -> logits ``[s, vocab]``: ``mm(y, q, s)`` for the
    quantized projections, the serving step's association of the bias
    adds, plain causal attention in fp32, and with ``kv_int8`` K and V
    through the int8 KV write's quantize and dequantize."""
    import torch.nn.functional as tnf

    from paddle_tpu_torch.inference.kv_cache import quantize_kv_rows

    s, nh, hd = x.shape[0], cfg.num_heads, cfg.head_dim
    eps = cfg.layer_norm_eps

    def ln(v, g, b):
        return tnf.layer_norm(v.float(), v.shape[-1:], g.float(), b.float(),
                              eps).to(v.dtype)

    def mm_(y, w):
        return mm(y, w["q"], w["s"]) if isinstance(w, dict) else y @ w

    def deq(t):
        qv, sv = quantize_kv_rows(t)
        return qv.float() * sv[..., None]

    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    lay = params["layers"]
    for i in range(cfg.num_layers):
        p = {k: ({n: t[i] for n, t in w.items()} if isinstance(w, dict)
                 else w[i]) for k, w in lay.items()}
        qkv = (mm_(ln(x, p["ln1_g"], p["ln1_b"]), p["wqkv"]) + p["bqkv"]
               ).reshape(s, 3, nh, hd)
        q, k, v = qkv[:, 0].float(), qkv[:, 1].float(), qkv[:, 2].float()
        if kv_int8:
            k, v = deq(k), deq(v)
        sc = torch.einsum("qhd,khd->hqk", q, k) / float(np.sqrt(hd))
        pr = torch.softmax(sc.masked_fill(~causal, -1e30), dim=-1)
        a = torch.einsum("hqk,khd->qhd", pr, v).to(x.dtype).reshape(s, -1)
        x = x + mm_(a, p["wo"]) + p["bo"]
        hid = tnf.gelu(mm_(ln(x, p["ln2_g"], p["ln2_b"]), p["w1"]) + p["b1"],
                       approximate="tanh")
        x = x + (mm_(hid, p["w2"]) + p["b2"])
    x = ln(x, params["lnf_g"], params["lnf_b"])
    return x @ params["tok_emb"].T


def embed(params, ids):
    return params["tok_emb"][ids] + params["pos_emb"][:ids.shape[0]]


def check_quant_oracle(sp, cfg, reqs, rows, kv_int8, tol):
    """Every served token and its logits row against the plain quantized
    forward over the served context. Returns (near ties, max abs logit
    error)."""
    from paddle_tpu_torch.ops.quant_matmul import quant_matmul_reference

    near_ties, logit_err = 0, 0.0
    with torch.no_grad():
        for i, r in enumerate(reqs):
            p, o = list(r.prompt_ids), list(r.output_ids)
            if len(o) != MAX_NEW:
                raise AssertionError(f"request {i}: {len(o)} tokens")
            ids = torch.tensor(p + o[:-1], device=sp.device)
            logits = quant_forward(sp.params, embed(sp.params, ids), cfg,
                                   kv_int8, quant_matmul_reference)
            logits = logits[len(p) - 1:].float()
            served = torch.stack([rows[(r.req_id, j)] for j in range(len(o))])
            logit_err = max(logit_err, (served - logits).abs().max().item())
            top2 = logits.topk(2, dim=-1)
            margin = (top2.values[:, 0] - top2.values[:, 1]).tolist()
            for j, (w, g) in enumerate(zip(top2.indices[:, 0].tolist(), o)):
                if w == g:
                    continue
                if margin[j] < TIE_MARGIN:
                    near_ties += 1
                    continue
                raise AssertionError(
                    f"request {i} token {j}: served {g}, quantized oracle {w}"
                    f" (margin {margin[j]:.3e})")
    if not logit_err <= tol:
        raise AssertionError(f"served logits differ from the quantized "
                             f"forward's by {logit_err} > {tol}")
    return near_ties, logit_err


def quant_predictor(model, cfg, quant, dev, dtype=None, mega_decode=None,
                    unified=None):
    """A ServingPredictor of ``model`` with the config fields ``quant`` set
    while it is built (it quantizes at construction)."""
    from paddle_tpu_torch.inference import ServingPredictor

    saved = {k: getattr(cfg, k) for k in quant}
    for k, v in quant.items():
        setattr(cfg, k, v)
    try:
        return ServingPredictor(model, max_batch=8, device=dev, dtype=dtype,
                                mega_decode=mega_decode, unified=unified)
    finally:
        for k, v in saved.items():
            setattr(cfg, k, v)


def phase_quant_grad(params, cfg, dev, bits):
    """d(loss)/d(input embeddings) through the 12 quantized layers (frozen
    weights), the weight-only GEMM op against the same forward with the
    plain GEMM: runs the backward kernels, 48 per backward."""
    from paddle_tpu_torch.ops.quant_matmul import (quant_matmul,
                                                   quant_matmul_reference)

    ids = torch.from_numpy(np.random.RandomState(SEED + 3).randint(
        0, cfg.vocab_size, 257)).to(dev)
    grads, counts = {}, None
    for name, mm in (("kernel", quant_matmul),
                     ("plain", quant_matmul_reference)):
        x = embed(params, ids[:-1]).detach().requires_grad_()
        reset_counts()
        logits = quant_forward(params, x, cfg, False, mm)
        torch.nn.functional.cross_entropy(logits.float(), ids[1:]).backward()
        torch.cuda.synchronize()
        if name == "kernel":
            counts = qmm_counts()
        grads[name] = x.grad
    err = ((grads["kernel"] - grads["plain"]).abs().max()
           / grads["plain"].abs().max()).item()
    want = cfg.num_layers * 4
    log(f"[quant] int{bits} gradient wrt the input embeddings ([256, 768], "
        f"fp32) through {cfg.num_layers} quantized layers: kernel vs plain "
        f"{err:.3e} of its max |grad| (tol {GRAD_TOL}); launches {counts}")
    if not err <= GRAD_TOL:
        raise AssertionError(f"int{bits} input gradient: kernel vs plain "
                             f"{err} > {GRAD_TOL}")
    if counts[f"int{bits}"] != want or counts[f"int{bits}_bwd"] != want:
        raise AssertionError(f"int{bits} gradient drive launched {counts} "
                             f"(want {want} forward and backward)")
    return counts[f"int{bits}_bwd"]


def phase_quant_serve(model, cfg, dev, card, fp_outs, fp16_step_ms):
    """Quantized serving on GPT-125M: three configurations in fp32 against
    the plain quantized forward, the gradient drive through the backward
    kernels, then bf16 step times."""
    from paddle_tpu_torch.inference.quantize import serving_weight_bytes
    from paddle_tpu_torch.models.gpt import serving_params

    early, late = requests(cfg)
    launches = {"ragged": 0, "int8": 0, "int4": 0, "int8_bwd": 0,
                "int4_bwd": 0}
    preds, streams = {}, {}
    for label, quant, tol in QUANT_SERVE:
        sp = quant_predictor(model, cfg, quant, dev)
        preds[label] = sp
        served_logits = StepLogits(sp)
        reset_counts()
        t0 = time.perf_counter()
        reqs = serve(sp, early, late)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ragged_n, counts = read_counts()[1], qmm_counts()
        tel, steps = sp.telemetry(), sp.steps
        bits = quant["weight_dtype"]
        kv_int8 = quant.get("kv_cache_dtype") == "int8"
        outs = [list(r.output_ids) for r in reqs]
        streams[label] = outs
        log(f"[quant] serve ({label}) fp32: {steps} steps, ragged launches "
            f"{ragged_n}, weight-only GEMM launches {counts}, prefix-hit "
            f"tokens {tel['kv_prefix_hit_tokens']:.0f}, CoW copies "
            f"{tel['kv_cow_copies']:.0f}, KV pool {sp.cache.k_pool.dtype}, "
            f"{wall:.3f} s wall")
        others = sum(v for k, v in counts.items() if k != bits)
        if (ragged_n != steps * cfg.num_layers or steps == 0
                or counts[bits] != 4 * steps * cfg.num_layers or others):
            raise AssertionError(f"({label}) launches: ragged {ragged_n}, "
                                 f"GEMM {counts} over {steps} steps")
        if tel["kv_cow_copies"] < 1 or tel["kv_prefix_hit_tokens"] < 1:
            raise AssertionError(f"({label}) no prefix hit or CoW copy")
        if kv_int8 != (sp.cache.k_pool.dtype == torch.int8):
            raise AssertionError(f"({label}) KV pool {sp.cache.k_pool.dtype}")
        launches["ragged"] += ragged_n
        launches[bits] += counts[bits]
        ties, logit_err = check_quant_oracle(sp, cfg, reqs,
                                             served_logits.rows, kv_int8, tol)
        agree = np.mean([a == b for o, f in zip(outs, fp_outs)
                         for a, b in zip(o, f)])
        log(f"[quant] serve ({label}) fp32: greedy streams match the plain "
            f"quantized forward ({sum(map(len, outs))} tokens, {ties} near "
            f"ties); logits max_abs_err {logit_err:.3e} (tol {tol}); token "
            "agreement with the fp32 streams of "
            f"phase 6: {agree:.4f}; {len({t for o in outs for t in o})} "
            "distinct tokens")
    for label, bits in (("a int8", 8), ("b int4 g128", 4)):
        launches[f"int{bits}_bwd"] += phase_quant_grad(
            preds[label].params, cfg, dev, bits)
    fp_bytes = serving_weight_bytes(serving_params(model))
    kv = {label: sum(t.numel() * t.element_size()
                     for t in preds[label].cache.pools())
          for label in ("a int8", "c int8 + int8 KV")}
    log(f"[quant] serving_weight_bytes fp32 {fp_bytes / 1e6:.2f} MB, int8 "
        f"{serving_weight_bytes(preds['a int8'].params) / 1e6:.2f} MB, int4 "
        f"g128 {serving_weight_bytes(preds['b int4 g128'].params) / 1e6:.2f}"
        f" MB; KV pools fp32 {kv['a int8'] / 1e6:.2f} MB, int8 + scales "
        f"{kv['c int8 + int8 KV'] / 1e6:.2f} MB")
    del preds
    for label, quant, _ in (QUANT_SERVE[0], QUANT_SERVE[2]):
        walls = []
        for run in range(1 + BF16_RUNS):
            sp16 = quant_predictor(model, cfg, quant, dev,
                                   dtype=torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs16 = [list(r.output_ids) for r in serve(sp16, early, late)]
            torch.cuda.synchronize()
            if run:
                walls.append(time.perf_counter() - t0)
        ntok = sum(map(len, outs16))
        if ntok != MAX_NEW * len(outs16):
            raise AssertionError(f"bf16 ({label}) malformed streams")
        wall = sorted(walls)[len(walls) // 2]
        log(f"[quant] serve ({label}) bf16: {ntok} tokens, {sp16.steps} steps"
            f" per run; median of {BF16_RUNS} runs {wall:.3f} s = "
            f"{ntok / wall:.1f} tokens/s, mean step "
            f"{1e3 * wall / sp16.steps:.3f} ms (fp bf16 step of phase 6: "
            f"{fp16_step_ms:.3f} ms; runs: "
            f"{', '.join(f'{w:.3f}' for w in walls)} s) ({card})")
    return launches, streams


# -- phase 10 ---------------------------------------------------------------


def mega_inputs(case, weights, group, kv_int8, dtype, dev, seed=SEED):
    """One layer's lane blocks ``xb``, weights (``weights`` None or "int8"
    in groups of ``group``), pools (fp, or int8 through the KV write's
    quantizer), page table, contexts and q_lens of a ``MEGA_*`` case, plus
    the MLP's inputs on the ``b * chunk`` rows."""
    from paddle_tpu_torch.inference.kv_cache import quantize_kv_rows
    from paddle_tpu_torch.inference.quantize import quantize_weight

    (b, chunk, h, nh, d, ps, pps, f), q_lens, ctx = case
    rng = np.random.RandomState(seed)
    hq = nh * d

    def to(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    p = {"ln1_g": to(1 + 0.1 * rng.randn(h)), "ln1_b": to(0.1 * rng.randn(h)),
         "ln2_g": to(1 + 0.1 * rng.randn(h)), "ln2_b": to(0.1 * rng.randn(h)),
         "bqkv": to(0.1 * rng.randn(3 * hq)), "bo": to(0.1 * rng.randn(h)),
         "b1": to(0.1 * rng.randn(f)), "b2": to(0.1 * rng.randn(h))}
    for name, (k, n) in (("wqkv", (h, 3 * hq)), ("wo", (hq, h)),
                         ("w1", (h, f)), ("w2", (f, h))):
        w = to(rng.randn(k, n) / np.sqrt(k), torch.float32)
        p[name] = (quantize_weight(w, weights, group) if weights
                   else w.to(dtype))
    num_pages = b * pps + 1
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    for i in range(b):                 # unallocated past each context
        pt[i, (ctx[i] + q_lens[i] + ps - 1) // ps:] = -1
    kp, vp = (rng.standard_normal((num_pages, ps, nh, d)) for _ in range(2))
    pools = dict(k_pages=to(kp), v_pages=to(vp))
    if kv_int8:
        (kq, ks), (vq, vs) = (quantize_kv_rows(to(t, torch.float32))
                              for t in (kp, vp))
        pools = dict(k_pages=kq, v_pages=vq, k_scales=ks, v_scales=vs)

    def ints(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    mlp = (to(rng.randn(b * chunk, h)), to(rng.randn(b * chunk, h)))
    return (to(rng.randn(b, chunk, h)), p, pools, ints(pt), ints(ctx),
            ints(q_lens)), mlp


def mega_held(got, want, q_lens, dtype, flips):
    """(max abs error, held error, tolerance) of one fp output on the rows
    each lane feeds (``q_lens`` None: every row)."""
    if q_lens is not None:
        valid = (torch.arange(got.shape[1], device=got.device)[None]
                 < q_lens[:, None].long())
        got, want = got[valid], want[valid]
    err, held = kernel_error(got, want, dtype)
    if dtype == torch.float32:
        held = err / max(want.abs().max().item(), 1e-30)
    tol = MEGA_KV_TOL if flips and dtype == torch.float32 else MEGA_TOL[dtype]
    return err, held, tol


def mega_check_attn(got, want, q_lens, dtype, label):
    """Hold one attention call against its plain version: the int8
    payloads by steps, then every other output. Returns (max abs error,
    payload flips, payloads compared)."""
    assert len(got) == len(want), label
    valid = (torch.arange(got[0].shape[1], device=got[0].device)[None]
             < q_lens[:, None].long())
    flips = total = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}: {g.dtype} {tuple(g.shape)} vs "
                                 f"{w.dtype} {tuple(w.shape)}")
        if g.dtype == torch.int8:
            diff = (g[valid].int() - w[valid].int()).abs()
            if diff.numel() and diff.max().item() > 1:
                raise AssertionError(f"{label}: an int8 payload "
                                     f"{diff.max().item()} steps off")
            flips += int((diff > 0).sum())
            total += diff.numel()
    if total and flips > MEGA_FLIP_FRAC * total:
        raise AssertionError(f"{label}: {flips} of {total} int8 payloads "
                             f"one step off (> {MEGA_FLIP_FRAC})")
    worst = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.int8:
            continue
        err, held, tol = mega_held(g, w, q_lens, dtype, flips)
        if not held <= tol:
            raise AssertionError(f"{label}: error {held} > {tol} (max abs "
                                 f"{err}, {flips} payload flips)")
        worst = max(worst, err)
    if torch.count_nonzero(got[0][0]).item():
        raise AssertionError(f"{label}: the idle lane's rows are not zero")
    return worst, flips, total


def mega_attn_work(args, fuse):
    """(bytes, ops) of one attention call on these inputs: x's valid rows,
    the vectors and both weights (int8 with their scales) read once, the
    K and V rows of each active lane's context read once, every output row
    written once; operations of the QKV product, the attention over each
    valid row's keys and the output projection."""
    xb, p, pools, pt, ctx, q_lens = args
    b, chunk, h = xb.shape
    _, ps, nh, d = pools["k_pages"].shape
    elt, hq = xb.element_size(), nh * d

    def wbytes(w):
        if isinstance(w, dict):
            return w["q"].numel() + 4 * w["s"].numel()
        return w.numel() * w.element_size()

    kv_int8 = "k_scales" in pools
    kv_row = nh * (d * (1 if kv_int8 else elt) + (4 if kv_int8 else 0))
    lanes = [(c, q) for c, q in zip(ctx.tolist(), q_lens.tolist()) if q]
    rows = sum(q for _, q in lanes)
    nbytes = (rows * h * elt + (5 * h + 3 * hq) * elt + wbytes(p["wqkv"])
              + wbytes(p["wo"]) + 2 * kv_row * sum(c for c, _ in lanes)
              + b * chunk * h * elt * (2 if fuse else 1)
              + 2 * b * chunk * kv_row
              + 4 * (sum(-(-(c + q) // ps) for c, q in lanes) + 2 * b))
    keys = sum(c + r + 1 for c, q in lanes for r in range(q))
    nops = 2 * rows * h * 3 * hq + 4 * d * nh * keys + 2 * rows * hq * h
    return nbytes, float(nops)


def mega_mlp_work(y2, p, fuse):
    t, h = y2.shape
    elt = y2.element_size()
    f = p["b1"].shape[0]
    w = sum((p[k]["q"].numel() + 4 * p[k]["s"].numel())
            if isinstance(p[k], dict) else p[k].numel() * elt
            for k in ("w1", "w2"))
    nbytes = t * h * elt * (3 if fuse else 2) + w + (f + h) * elt
    return nbytes, 4.0 * t * h * f


def one_layer_step(case, p, pools, pt, ctx, q_lens, mega):
    """A one-layer ``UnifiedStep`` on the case's lanes, its stacked params
    and ``[1, pages + 1, ...]`` pools (spare page last), and the packed
    plumbing the step computes for them: its ``_mega_layers`` /
    ``_per_op_layers`` is the layer the pair replaces, through the port's
    own code. Returns (a callable running the layer on packed rows, the
    packed rows)."""
    import dataclasses

    from paddle_tpu_torch.inference.kv_cache import packed_dest
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, UnifiedStep

    (b, chunk, h, nh, d, ps, pps, f), ql, cx = case
    kv_int8 = "k_scales" in pools
    cfg = dataclasses.replace(GPT_CONFIGS["gpt3-125m"], num_layers=1,
                              hidden_size=h, num_heads=nh,
                              intermediate_size=f)
    step = UnifiedStep(cfg, ps, chunk, kv_quant=kv_int8, mega=mega)
    params = {"layers": {k: ({n: t[None] for n, t in v.items()}
                             if isinstance(v, dict) else v[None])
                         for k, v in p.items()}}
    ext = [torch.cat([t, t[:1]])[None] for t in
           [pools[k] for k in ("k_pages", "v_pages", "k_scales", "v_scales")
            if k in pools]]
    slot = torch.tensor([i for i, q in enumerate(ql) for _ in range(q)],
                        device=pt.device)
    pos = torch.tensor([c + r for c, q in zip(cx, ql) for r in range(q)],
                       device=pt.device)
    off = pos - ctx[slot].long()
    rows = slot * chunk + off
    dest = packed_dest(pt, slot, pos, ps, ext[0].shape[1] - 1)
    layers = step._mega_layers if mega else step._per_op_layers

    def run(x):
        return layers(params, x, ext, pt, q_lens, ctx, rows, rows, dest)

    return run, rows


def phase_mega_kernels(dev, card):
    """Both mega kernels vs their plain versions at the serving shapes and
    an odd shape, fp32 and bf16, fp / int8 weights, fp / int8 KV, with and
    without the fused epilogue; kernel / plain / bound times of both, and
    the per-op layer they replace, on the same inputs."""
    from paddle_tpu_torch.ops.mega_decode import (
        mega_attn_layer, mega_attn_layer_reference, mega_mlp,
        mega_mlp_reference)

    stats = {}
    for cname, case, weight_list in (("serving", MEGA_SERVING, MEGA_WEIGHTS),
                                     ("odd", MEGA_ODD, (("int8", 64),))):
        for dtype in (torch.float32, torch.bfloat16):
            for wd, gs in weight_list:
                for kv_int8 in (False, True):
                    args, (y2, s_res) = mega_inputs(case, wd, gs, kv_int8,
                                                    dtype, dev)
                    xb, p, pools, pt, ctx, q_lens = args
                    pos = (xb, p, pools["k_pages"], pools["v_pages"], pt,
                           ctx, q_lens)
                    label = (f"{cname} {str(dtype)[6:]} weights "
                             f"{wd or 'fp'}{'' if gs < 0 else f' g{gs}'}, "
                             f"{'int8' if kv_int8 else 'fp'} KV")
                    errs, flips = [], []
                    for fuse in (True, False):
                        kw = dict(k_scales=pools.get("k_scales"),
                                  v_scales=pools.get("v_scales"),
                                  fuse_epilogue=fuse)
                        got = mega_attn_layer(*pos, **kw)
                        torch.cuda.synchronize()
                        want = mega_attn_layer_reference(*pos, **kw)
                        err, n, total = mega_check_attn(
                            got, want, q_lens, dtype,
                            f"mega attention {label} fuse {fuse}")
                        errs.append(err)
                        flips.append(f"{n}/{total}")
                        got = mega_mlp(y2, s_res if fuse else None, p,
                                       fuse_epilogue=fuse)
                        torch.cuda.synchronize()
                        want = mega_mlp_reference(y2, s_res, p,
                                                  fuse_epilogue=fuse)
                        err, held, tol = mega_held(got, want, None, dtype, 0)
                        if not held <= tol:
                            raise AssertionError(
                                f"mega MLP {label} fuse {fuse}: error {held}"
                                f" > {tol} (max abs {err})")
                        errs.append(err)
                    log(f"[mega] {label}: attention max_abs_err fused "
                        f"{errs[0]:.3e} / partial {errs[2]:.3e} (int8 "
                        f"payloads one step off: {', '.join(flips)}), MLP "
                        f"{errs[1]:.3e} / {errs[3]:.3e} (tol "
                        f"{MEGA_TOL[dtype]}; {MEGA_KV_TOL} fp32 after a "
                        "payload flip)")
                    if cname != "serving" or (wd, kv_int8) not in (
                            (None, False), ("int8", True)) or (
                            wd and gs < 0):
                        continue
                    stats[(wd, kv_int8, dtype)] = mega_times(
                        case, args, (y2, s_res), max(errs[0], errs[2]),
                        max(errs[1], errs[3]), dtype, label, card)
    return stats


def mega_times(case, args, mlp_args, attn_err, mlp_err, dtype, label, card):
    """Kernel, plain and bound times of both kernels on these inputs, and
    device times of the one-layer mega step against the per-op layer."""
    from paddle_tpu_torch.ops.mega_decode import (
        mega_attn_layer, mega_attn_layer_reference, mega_mlp,
        mega_mlp_reference)

    xb, p, pools, pt, ctx, q_lens = args
    y2, s_res = mlp_args
    pos = (xb, p, pools["k_pages"], pools["v_pages"], pt, ctx, q_lens)
    kw = dict(k_scales=pools.get("k_scales"), v_scales=pools.get("v_scales"))
    out = {}
    for name, kern, plain, work, err in (
            ("attn", lambda: mega_attn_layer(*pos, **kw),
             lambda: mega_attn_layer_reference(*pos, **kw),
             mega_attn_work(args, True), attn_err),
            ("mlp", lambda: mega_mlp(y2, s_res, p),
             lambda: mega_mlp_reference(y2, s_res, p),
             mega_mlp_work(y2, p, True), mlp_err)):
        nbytes, nops = work
        out[name] = dict(
            max_abs_err=err, ms=time_ms(kern), plain_ms=time_ms(plain,
                                                                iters=5),
            bound_ms=bound_ms(nbytes, nops, dtype), library_ms=None,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S
            >= nops / PEAK_OPS[dtype] else "operations",
            mb=nbytes / 1e6, gflop=nops / 1e9)
    layer = {}
    for mega in (True, False):
        run, rows = one_layer_step(case, p, pools, pt, ctx, q_lens, mega)
        x = xb.reshape(-1, xb.shape[-1])[rows]
        layer[mega] = time_ms(lambda: run(x), iters=10)
    out["layer_ms"], out["per_op_layer_ms"] = layer[True], layer[False]
    a, m = out["attn"], out["mlp"]
    log(f"[mega] {label} times: attention kernel {a['ms']:.4f} ms, plain "
        f"{a['plain_ms']:.4f}, bound {a['bound_ms']:.6f} ({a['bound_by']}: "
        f"{a['mb']:.2f} MB, {a['gflop']:.3f} GFLOP); MLP [{y2.shape[0]}, "
        f"{y2.shape[1]}] x {p['b1'].shape[0]} kernel {m['ms']:.4f} ms, plain "
        f"{m['plain_ms']:.4f}, bound {m['bound_ms']:.6f} ({m['bound_by']}: "
        f"{m['mb']:.2f} MB, {m['gflop']:.3f} GFLOP); library null (no "
        "PyTorch call computes either); one mega layer (both kernels and the "
        f"K / V scatters) {out['layer_ms']:.4f} ms vs the per-op layer it "
        f"replaces {out['per_op_layer_ms']:.4f} ms on the same "
        f"{int(q_lens.sum())} rows (device time, {card})")
    return out


def mega_counts():
    """(mega attention, mega MLP) launches since :func:`reset_counts`."""
    from paddle_tpu_torch.ops.mega_decode import mega_attn_layer, mega_mlp

    return mega_attn_layer.launches, mega_mlp.launches


def profile_serve(sp, early, late, card, tag):
    """One served bf16 run under ``torch.profiler``: device busy and idle
    share of its wall time, and device time by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(sp, early, late)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    groups = {"mega kernels": ("mega_attn", "mega_mlp"),
              "ragged kernel": ("ragged",),
              "paged decode kernel": ("paged_decode",),
              "weight-only GEMM": ("qmm_kernel",),
              "grouped GEMM": ("gmm_kernel",),
              "cuBLAS": ("gemm", "nvjet", "cutlass")}
    times = {name: 0.0 for name in groups}
    times["other PyTorch kernels"] = 0.0
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    for ev in kernels:
        key = ev.key.lower()
        name = next((n for n, marks in groups.items()
                     if any(m in key for m in marks)),
                    "other PyTorch kernels")
        times[name] += ev.self_device_time_total
    busy = sum(times.values())
    if busy <= 0:
        log(f"{tag} profiler: no device time in the trace (not measured)")
        return
    log(f"{tag} profiled bf16 run: {sp.steps} steps, wall {wall_us / 1e3:.1f}"
        f" ms under the profiler, device busy {busy / 1e3:.1f} ms = "
        f"{busy / wall_us:.3f}, idle {1 - busy / wall_us:.3f}; "
        f"{sum(ev.count for ev in kernels)} kernels; " + ", ".join(
            f"{n} {t / 1e3:.1f} ms ({t / busy:.3f})"
            for n, t in times.items() if t) + f" ({card})")


def phase_mega_serve(model, cfg, dev, card, fp_outs, quant_streams):
    """``ServingPredictor(mega_decode=True)`` on GPT-125M with the phase-6
    requests in fp32: (i) fp weights against phase 6's per-op streams and
    the full-forward oracle, (ii) int8 weights against phase 8's per-op
    streams of the same config and the plain quantized forward, (iii) int8
    g128 weights with an int8 KV cache against a per-op run of the same
    config and the plain quantized forward; then bf16 step times of (i)
    and (iii) beside their per-op twins, and one profiled run of each.
    Returns the fp32 runs' (attention, MLP) launches."""
    early, late = requests(cfg)
    total = [0, 0]
    for label, quant, tol in MEGA_SERVE:
        if not quant:
            want = fp_outs
        elif label.startswith("ii "):
            want = quant_streams["a int8"]      # the same config
        else:
            want = [list(r.output_ids) for r in serve(
                quant_predictor(model, cfg, quant, dev), early, late)]
        sp = quant_predictor(model, cfg, quant, dev, mega_decode=True)
        served_logits = StepLogits(sp)
        reset_counts()
        t0 = time.perf_counter()
        reqs = serve(sp, early, late)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        attn_n, mlp_n = mega_counts()
        ragged_n, qmm = read_counts()[1], qmm_counts()
        steps, tel = sp.steps, sp.telemetry()
        outs = [list(r.output_ids) for r in reqs]
        kv_int8 = quant.get("kv_cache_dtype") == "int8"
        log(f"[mega] serve ({label}) fp32: {steps} steps, mega launches "
            f"attention {attn_n} / MLP {mlp_n} (steps x {cfg.num_layers} = "
            f"{steps * cfg.num_layers}), ragged {ragged_n}, weight-only GEMM "
            f"{qmm}, prefix-hit tokens {tel['kv_prefix_hit_tokens']:.0f}, CoW "
            f"copies {tel['kv_cow_copies']:.0f}, KV pool "
            f"{sp.cache.k_pool.dtype}, {wall:.3f} s wall")
        if not (attn_n == mlp_n == steps * cfg.num_layers and steps
                and ragged_n == 0 and not any(qmm.values())):
            raise AssertionError(f"({label}) launches: mega {attn_n} / "
                                 f"{mlp_n}, ragged {ragged_n}, GEMM {qmm} "
                                 f"over {steps} steps")
        if tel["kv_cow_copies"] < 1 or tel["kv_prefix_hit_tokens"] < 1:
            raise AssertionError(f"({label}) no prefix hit or CoW copy")
        if kv_int8 != (sp.cache.k_pool.dtype == torch.int8):
            raise AssertionError(f"({label}) KV pool {sp.cache.k_pool.dtype}")
        if tol is None:
            ties, logit_err = check_against_oracle(model, reqs,
                                                   served_logits.rows, dev)
            oracle = "the full forward"
        else:
            ties, logit_err = check_quant_oracle(
                sp, cfg, reqs, served_logits.rows, kv_int8, tol)
            oracle = "the plain quantized forward"
        same = sum(a == b for o, w in zip(outs, want) for a, b in zip(o, w))
        log(f"[mega] serve ({label}) fp32: greedy streams match {oracle} "
            f"({sum(map(len, outs))} tokens, {ties} near ties), logits "
            f"max_abs_err {logit_err:.3e} (tol {tol or LOGIT_TOL}); equal to "
            f"the per-op streams in {same} of {sum(map(len, want))} tokens")
        if outs != want:
            raise AssertionError(f"({label}) mega streams differ from the "
                                 "per-op streams")
        total[0] += attn_n
        total[1] += mlp_n
    # bf16 step times, mega beside per-op in turns (the step is host-bound
    # and its time moves between runs: median of BF16_RUNS each)
    for label, quant, _ in (MEGA_SERVE[0], MEGA_SERVE[2]):
        walls = {False: [], True: []}
        for run in range(1 + BF16_RUNS):
            for mega in ((False, True) if run % 2 else (True, False)):
                sp16 = quant_predictor(model, cfg, quant, dev,
                                       dtype=torch.bfloat16, mega_decode=mega)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs16 = [list(r.output_ids) for r in serve(sp16, early,
                                                            late)]
                torch.cuda.synchronize()
                if run:
                    walls[mega].append((time.perf_counter() - t0,
                                        sp16.steps))
                if sum(map(len, outs16)) != MAX_NEW * len(outs16):
                    raise AssertionError(f"bf16 ({label}) malformed streams")
        ms = {}
        for mega, runs in walls.items():
            wall, steps = sorted(runs)[len(runs) // 2]
            ms[mega] = 1e3 * wall / steps
            log(f"[mega] serve ({label}) bf16 {'mega' if mega else 'per-op'}"
                f": {steps} steps per run; median of {BF16_RUNS} runs "
                f"{wall:.3f} s, mean step {ms[mega]:.3f} ms (runs: "
                f"{', '.join(f'{w:.3f}' for w, _ in runs)} s) ({card})")
        log(f"[mega] serve ({label}) bf16 mean step mega {ms[True]:.3f} ms "
            f"vs per-op {ms[False]:.3f} ms: {ms[False] / ms[True]:.2f}x "
            f"({card})")
        for mega in (True, False):
            profile_serve(
                quant_predictor(model, cfg, quant, dev, dtype=torch.bfloat16,
                                mega_decode=mega), early, late,
                card, f"[mega] ({label}, {'mega' if mega else 'per-op'})")
    return total


# -- phase 11 ---------------------------------------------------------------


def gmm_counts() -> dict:
    """Grouped-GEMM launches since :func:`reset_counts`, by kernel."""
    from paddle_tpu_torch.ops.grouped_matmul import (grouped_matmul_bwd,
                                                     grouped_matmul_fwd)

    out = dict(grouped_matmul_fwd.launches)
    out.update({f"{k}_bwd": v for k, v in grouped_matmul_bwd.launches.items()})
    return out


@contextlib.contextmanager
def moe_twins():
    """Every grouped GEMM the MoE FFN runs takes its plain version (on the
    card) while the block is open: the same step or model built from the
    twins, for the comparisons; their launches are not counted."""
    from paddle_tpu_torch.models import moe

    kernel_mm = moe._grouped_mm
    moe._grouped_mm = lambda xs, w, offs, use_kernel: kernel_mm(
        xs, w, offs, False)
    try:
        yield
    finally:
        moe._grouped_mm = kernel_mm


@contextlib.contextmanager
def record_routes():
    """The router's expert choices ``idx [N, k]`` of every MoE layer run
    while the block is open, in order."""
    from paddle_tpu_torch.models import moe

    route, seen = moe.route_topk, []

    def recording(logits, top_k):
        out = route(logits, top_k)
        seen.append(out[1])
        return out

    moe.route_topk = recording
    try:
        yield seen
    finally:
        moe.route_topk = route


def gmm_case(counts, k, n, weights, gs, dtype, dev, seed):
    """Seeded x [M, K], dy [M, N], an expert stack (N(0, 0.05), cast to
    ``dtype`` first, quantized per expert) whose EMPTY experts hold NaN
    weights (fp) or NaN scales, its scales or None, and the offsets."""
    from paddle_tpu_torch.inference.quantize import quantize_weight

    rng = np.random.RandomState(seed)
    m, e = sum(counts), len(counts)
    x, dy = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(
        dev, dtype) for sh in ((m, k), (m, n)))
    w = torch.from_numpy(0.05 * rng.standard_normal((e, k, n)).astype(
        np.float32)).to(dev, dtype)
    empty = [i for i, c in enumerate(counts) if c == 0]
    scales = None
    if weights is None:
        w[empty] = float("nan")
    else:
        qw = quantize_weight(w, weights, gs)
        w, scales = qw["q"], qw["s"]
        scales[empty] = float("nan")
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=dev)
    return x, dy, w, scales, offs


def gmm_work(counts, k, n, bits, groups, elt):
    """(bytes, ops) of one grouped GEMM, forward or dx (the same traffic):
    the activations read and the output written once in their type, the
    weights (and fp32 scales) of the NON-EMPTY experts read once, the
    offsets; 2 M K N operations."""
    m, live = sum(counts), sum(1 for c in counts if c)
    wbytes = k * n * (elt if bits == 0 else bits / 8) + 4 * groups * n
    nbytes = (m * k + m * n) * elt + live * wbytes + 4 * (len(counts) + 1)
    return nbytes, 2.0 * m * k * n


def grouped_mm_ms(a, b, offs, want):
    """``torch._grouped_mm`` on the same values (bf16, ``b`` as given or in
    column-major layout), timed and never used: (ms, None), or (None, why)
    where the card's torch refuses both layouts or disagrees with
    ``want``."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "this torch has no torch._grouped_mm"
    ends = offs[1:].contiguous()
    why = None
    for mat in (b.contiguous(),
                b.transpose(-2, -1).contiguous().transpose(-2, -1)):
        try:
            got = fn(a, mat, offs=ends)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError) as e:
            why = str(e).splitlines()[0][:120]
            continue
        err = kernel_error(got, want, torch.bfloat16)[1]
        if not err <= GMM_TOL[torch.bfloat16]:
            return None, f"torch._grouped_mm disagrees ({err:.3e})"
        return time_ms(lambda: fn(a, mat, offs=ends)), None
    return None, why


def phase_gmm(dev, card):
    """The five grouped-GEMM kernels vs their plain versions at the three
    shapes; per (kernel, dtype, shape set) the summed times of w1 and w2
    (one MoE layer's two GEMMs) at (a) the serving and (b) the prefill
    rows."""
    from paddle_tpu_torch.ops.grouped_matmul import (
        grouped_matmul_bwd, grouped_matmul_dx_reference, grouped_matmul_fwd,
        grouped_matmul_reference)

    stats, notes = {}, {}
    for label, wd, gs in GMM_WEIGHTS:
        bits = int(wd[3:]) if wd else 0
        fwd_name = {0: "gmm", 8: "gmm_q", 4: "gmm_q4"}[bits]
        bwd_name = {0: "gmm_bwd", 8: "gmm_q_bwd"}.get(bits)
        for dtype in (torch.float32, torch.bfloat16):
            k_odd, n_odd, c_odd, g_odd = GMM_ODD
            cases = [(c, *GMM_SHAPES[name], name, rows, gs)
                     for rows, c in (("a", GMM_ROWS), ("b", GMM_PREFILL))
                     for name in GMM_SHAPES]
            cases.append((c_odd, k_odd, n_odd, "odd", "c",
                          g_odd if gs > 0 else -1))
            for ci, (counts, k, n, name, rows, g) in enumerate(cases):
                x, dy, w, sc, offs = gmm_case(counts, k, n, wd, g, dtype,
                                              dev, SEED + ci)
                pairs = [(grouped_matmul_fwd(x, w, offs, sc),
                          grouped_matmul_reference(x, w, offs, sc))]
                if bwd_name:
                    pairs.append((
                        grouped_matmul_bwd(dy, w, offs, sc, k, dtype),
                        grouped_matmul_dx_reference(dy, w, offs, sc, k,
                                                    dtype)))
                torch.cuda.synchronize()
                held, errs = [], []
                for got, want in pairs:
                    err, h = kernel_error(got, want, dtype)
                    if dtype == torch.float32:
                        h = err / want.abs().max().item()
                    if not bool(torch.isfinite(got).all()):
                        h = float("inf")   # an empty expert's NaN was read
                    held.append(h)
                    errs.append(err)
                tag = (f"[moe] {fwd_name} {label} {str(dtype)[6:]} {name} "
                       f"({rows}) M {sum(counts)} {counts} x [{k}, {n}] g{g}")
                if not max(held) <= GMM_TOL[dtype]:
                    raise AssertionError(f"{tag}: held errors {held} > "
                                         f"{GMM_TOL[dtype]}")
                if rows == "c":
                    log(f"{tag}: held fwd / dx {held} (tol "
                        f"{GMM_TOL[dtype]}); NaN weights of the empty expert"
                        " absent from the output")
                    continue
                nbytes, nops = gmm_work(counts, k, n, bits,
                                        1 if sc is None else sc.shape[1],
                                        x.element_size())
                it = 50 if rows == "a" else 10
                t = {fwd_name: dict(
                    ms=time_ms(lambda: grouped_matmul_fwd(x, w, offs, sc),
                               iters=it),
                    plain_ms=time_ms(lambda: grouped_matmul_reference(
                        x, w, offs, sc), iters=10),
                    max_abs_err=errs[0])}
                lib, why = (grouped_mm_ms(x, w, offs, pairs[0][1])
                            if bits == 0 and dtype == torch.bfloat16
                            else (None, "no PyTorch call takes this type"
                                  if bits == 0 else "no PyTorch call takes "
                                  "quantized expert stacks"))
                t[fwd_name]["library_ms"] = lib
                notes[(fwd_name, dtype)] = why
                if bwd_name:
                    wt = w.transpose(1, 2)
                    lib, why = (grouped_mm_ms(dy, wt, offs, pairs[1][1])
                                if bits == 0 and dtype == torch.bfloat16
                                else (None, notes[(fwd_name, dtype)]))
                    t[bwd_name] = dict(
                        ms=time_ms(lambda: grouped_matmul_bwd(
                            dy, w, offs, sc, k, dtype), iters=it),
                        plain_ms=time_ms(lambda: grouped_matmul_dx_reference(
                            dy, w, offs, sc, k, dtype), iters=10),
                        max_abs_err=errs[1], library_ms=lib)
                    notes[(bwd_name, dtype)] = why
                for kname, st in t.items():
                    key = (kname, label, dtype, rows)
                    tot = stats.setdefault(key, dict(
                        ms=0.0, plain_ms=0.0, library_ms=0.0, max_abs_err=0.0,
                        work=[0.0, 0.0]))
                    for f in ("ms", "plain_ms", "library_ms"):
                        tot[f] = (None if tot[f] is None or st[f] is None
                                  else tot[f] + st[f])
                    tot["max_abs_err"] = max(tot["max_abs_err"],
                                             st["max_abs_err"])
                    tot["work"] = [tot["work"][0] + nbytes,
                                   tot["work"][1] + nops]
                    log(f"[moe] {kname} {label} {str(dtype)[6:]} {name} "
                        f"({rows}) M {sum(counts)} x [{k}, {n}]: held "
                        f"{held[0 if kname == fwd_name else 1]:.3e}; kernel "
                        f"{st['ms']:.4f} ms, plain {st['plain_ms']:.4f}, "
                        f"bound {bound_ms(nbytes, nops, dtype):.6f} "
                        f"({nbytes / 1e6:.3f} MB, {nops / 1e9:.4f} GFLOP), "
                        "library (torch._grouped_mm) " + (
                            f"{st['library_ms']:.4f}"
                            if st["library_ms"] is not None else
                            f"null ({notes[(kname, dtype)]})"))
    for key, tot in stats.items():
        nbytes, nops = tot.pop("work")
        dtype = key[2]
        tot["bound_ms"] = bound_ms(nbytes, nops, dtype)
        tot["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                           >= nops / PEAK_OPS[dtype] else "operations")
        tot["library_note"] = notes[(key[0], dtype)]
        log(f"[moe] {key[0]} {key[1]} {str(dtype)[6:]} ({key[3]}: w1 + w2, "
            f"{'serving' if key[3] == 'a' else 'prefill'} rows): kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, bound "
            f"{tot['bound_ms']:.6f} ({tot['bound_by']}: {nbytes / 1e6:.2f} MB"
            f", {nops / 1e9:.3f} GFLOP), library "
            + (f"{tot['library_ms']:.4f}" if tot["library_ms"] is not None
               else f"null ({tot['library_note']})") + f" ({card})")
    return stats


def moe_model(cfg, dev, dtype=torch.float32):
    """``cfg``'s model on the card with numpy-seeded weights, in eval."""
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)

    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev,
                                 dtype=dtype)
    model.eval()
    return model


def dequantized_clone(model, weight_dtype, group_size):
    """The reference's ``_dequantized_clone``: a copy of ``model`` whose
    stacks the serving conversion quantizes (qkv and output projections,
    the expert stacks) hold their quantize -> dequantize image, so its
    full forward computes what the quantized step computes."""
    from paddle_tpu_torch.inference.quantize import quantize_weight
    from paddle_tpu_torch.ops.grouped_matmul import dequantize_grouped_weight
    from paddle_tpu_torch.ops.quant_matmul import dequantize_weight

    clone = copy.deepcopy(model)
    with torch.no_grad():
        for layer in clone.gpt.layers:
            for p in (layer.attn.qkv_proj.weight, layer.attn.out_proj.weight):
                qw = quantize_weight(p, weight_dtype, group_size)
                p.copy_(dequantize_weight(qw["q"], qw["s"], k=p.shape[0]))
            for p in (layer.mlp.w1, layer.mlp.w2):
                qw = quantize_weight(p, weight_dtype, group_size)
                p.copy_(dequantize_grouped_weight(qw["q"], qw["s"],
                                                  k=p.shape[1]))
    return clone


class RouterFlips:
    """Stands in for a predictor's unified step. At call ``at`` it runs the
    step once more with the plain grouped GEMMs on copies of the pools
    first, and counts the router choices (valid token, choice, layer) in
    which the kernel run and the twin run differ."""

    def __init__(self, sp, at):
        self.sp, self.step, self.at, self.calls = sp, sp._unified, at, 0
        self.flips = self.choices = None
        sp._unified = self

    def __call__(self, *args, **kw):
        self.calls += 1
        if self.calls != self.at:
            return self.step(*args, **kw)
        from paddle_tpu_torch.ops import paged_attention

        n_pool = 4 if self.sp.kv_quant else 2
        twin_args = list(args)
        twin_args[11:11 + n_pool] = [p.clone() for p in args[11:11 + n_pool]]
        ragged = paged_attention.ragged_paged_attention
        before = ragged.launches
        with record_routes() as twin, moe_twins():
            self.step(*twin_args, **kw)
        ragged.launches = before       # the comparison's launches
        with record_routes() as kern:
            out = self.step(*args, **kw)
        valid = (args[2] >= 0)[:, None]
        self.flips = sum(int(((a != b) & valid).sum()) for a, b in
                         zip(kern, twin))
        self.choices = int(valid.sum()) * kern[0].shape[1] * len(kern)
        return out


def phase_moe_serve(cfg, dev, card, dense_step_ms):
    """``ServingPredictor`` on GPT-125M with 4 experts, top-2, the phase-6
    requests in fp32: (i) cf 4.0 against the full-forward oracle, (ii) cf
    1.25 against the same step built from the plain grouped GEMM (router
    flips of one step counted), (iii) int8 and (iv) int4 g128 weights (the
    expert stacks and the qkv / output projections) at cf 4.0 against the
    full forward over the dequantized weights; launches a step; the router
    stats of one eager probe; then bf16 step times beside phase 6's dense
    step, one profiled run, and the weight bytes. Returns the served runs'
    grouped-GEMM launches by weight type."""
    from paddle_tpu_torch.inference.quantize import serving_weight_bytes
    from paddle_tpu_torch.models.gpt import serving_params

    early, late = requests(cfg)
    model = moe_model(cfg, dev)
    mcfg = model.config
    launches = {"fp": 0, "int8": 0, "int4": 0}
    for label, cf, quant in MOE_SERVE:
        mcfg.moe_capacity_factor = cf
        sp = quant_predictor(model, mcfg, quant, dev)
        served_logits = StepLogits(sp)
        flips = RouterFlips(sp, at=20) if label.startswith("ii ") else None
        reset_counts()
        t0 = time.perf_counter()
        reqs = serve(sp, early, late)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ragged_n, qmm, gmm = read_counts()[1], qmm_counts(), gmm_counts()
        mega_n = sum(mega_counts())
        steps = sp.steps
        bits = quant.get("weight_dtype", "fp")
        outs = [list(r.output_ids) for r in reqs]
        log(f"[moe] serve ({label}) fp32: {steps} steps, grouped-GEMM "
            f"launches {gmm}, ragged {ragged_n}, weight-only GEMM {qmm}, mega"
            f" {mega_n}, {wall:.3f} s wall")
        per_step = 2 * cfg.num_layers
        want_qmm = per_step * steps if quant else 0
        if not (steps and gmm[bits] == per_step * steps
                and sum(gmm.values()) == gmm[bits]
                and ragged_n == steps * cfg.num_layers and mega_n == 0
                and sum(qmm.values()) == want_qmm
                and (not quant or qmm[bits] == want_qmm)):
            raise AssertionError(f"({label}) launches: grouped {gmm}, ragged "
                                 f"{ragged_n}, GEMM {qmm}, mega {mega_n} "
                                 f"over {steps} steps")
        launches[bits] += gmm[bits]
        if flips is not None:
            with moe_twins():
                want = [list(r.output_ids) for r in serve(
                    quant_predictor(model, mcfg, quant, dev), early, late)]
            same = sum(a == b for o, w in zip(outs, want)
                       for a, b in zip(o, w))
            log(f"[moe] serve ({label}) fp32: equal to the streams of the "
                f"step built from the plain grouped GEMM in {same} of "
                f"{sum(map(len, want))} tokens; router choices of step "
                f"{flips.at}, kernel vs plain: {flips.flips} flips in "
                f"{flips.choices}")
            if outs != want:
                raise AssertionError(f"({label}) kernel streams differ from "
                                     "the plain grouped GEMM's")
            continue
        oracle = (dequantized_clone(model, quant["weight_dtype"],
                                    quant.get("weight_quant_group_size", -1))
                  if quant else model)
        ties, logit_err = check_against_oracle(oracle, reqs,
                                               served_logits.rows, dev)
        log(f"[moe] serve ({label}) fp32: greedy streams match the full "
            f"forward{' over the dequantized weights' if quant else ''} "
            f"({sum(map(len, outs))} tokens, {ties} near ties), logits "
            f"max_abs_err {logit_err:.3e} (tol {LOGIT_TOL}); "
            f"{len({t for o in outs for t in o})} distinct tokens")
        del oracle
    # the router's stats on one eager probe (request 0's prompt)
    ids = torch.tensor([early[0]], device=dev)
    for cf in (4.0, 1.25):
        mcfg.moe_capacity_factor = cf
        with torch.no_grad():
            model(ids)
        st = [layer.mlp.router_stats for layer in model.gpt.layers]
        log(f"[moe] router stats, eager probe on {ids.shape[1]} tokens at cf "
            f"{cf}: load imbalance (largest expert share x E) per layer "
            f"{[round(float(s['load'].max()) * 4, 3) for s in st]}, drop "
            f"rate per layer {[round(float(s['drop_rate']), 4) for s in st]}")
    # bf16 at cf 1.25: the MoE step beside phase 6's dense step, one
    # profiled run, and the weight bytes per configuration
    walls = []
    for run in range(1 + BF16_RUNS):
        sp16 = quant_predictor(model, mcfg, {}, dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs16 = [list(r.output_ids) for r in serve(sp16, early, late)]
        torch.cuda.synchronize()
        if run:
            walls.append(time.perf_counter() - t0)
        if sum(map(len, outs16)) != MAX_NEW * len(outs16):
            raise AssertionError("bf16 MoE serving: malformed streams")
    wall = sorted(walls)[len(walls) // 2]
    log(f"[moe] serve (cf 1.25) bf16: {sp16.steps} steps per run; median of "
        f"{BF16_RUNS} runs {wall:.3f} s, mean step "
        f"{1e3 * wall / sp16.steps:.3f} ms beside the dense GPT-125M bf16 "
        f"step of phase 6, {dense_step_ms:.3f} ms (runs: "
        f"{', '.join(f'{w:.3f}' for w in walls)} s) ({card})")
    profile_serve(quant_predictor(model, mcfg, {}, dev, dtype=torch.bfloat16),
                  early, late, card, "[moe] (cf 1.25)")
    sizes = {"fp32": serving_weight_bytes(serving_params(model)),
             "bf16": serving_weight_bytes(sp16.params)}
    del sp16
    for name, quant in (("int8", dict(weight_dtype="int8")),
                        ("int4 g128", dict(weight_dtype="int4",
                                           weight_quant_group_size=128))):
        sizes[name] = serving_weight_bytes(quant_predictor(
            model, mcfg, quant, dev).params)
    log("[moe] serving_weight_bytes: " + ", ".join(
        f"{k} {v / 1e6:.2f} MB" for k, v in sizes.items())
        + f" ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        "parameters)")
    return launches


def phase_moe_grads(cfg, dev):
    """``loss.backward()`` through a 2-layer GPT-125M-width MoE model in
    fp32, the grouped-GEMM kernels against the plain versions for every
    gradient leaf (4 backward launches: two GEMMs a layer); then the input
    gradient through the two layers' MoE FFNs with int8 expert stacks
    (``ptt_gmm_q_bwd``). Returns (fp, int8) backward launches."""
    from dataclasses import replace

    from paddle_tpu_torch.inference.quantize import quantize_weight
    from paddle_tpu_torch.models.moe import moe_ffn

    mcfg = replace(cfg, num_layers=2)
    model = moe_model(mcfg, dev)
    model.train()
    ids = torch.from_numpy(np.random.RandomState(SEED + 4).randint(
        0, cfg.vocab_size, (2, 129))).to(dev)
    grads, counts = {}, None
    for kernel in (True, False):
        model.zero_grad(set_to_none=True)
        reset_counts()
        with contextlib.ExitStack() as stack:
            if not kernel:
                stack.enter_context(moe_twins())
            loss = _lm_loss(model, ids)
            loss.backward()
        torch.cuda.synchronize()
        if kernel:
            counts = gmm_counts()
        grads[kernel] = {n: p.grad for n, p in model.named_parameters()}
    errs = _grad_errors(grads[True], grads[False])
    worst = max(errs, key=errs.get)
    log(f"[moe] eager 2-layer GPT-125M-width MoE, ids [2, 128], fp32: "
        f"grouped-GEMM launches {counts}; kernel vs plain gradients: "
        f"{len(errs)} leaves, none None, worst {worst} {errs[worst]:.3e} of "
        f"its max |grad| (tol {GRAD_TOL}); expert w1 of layer 0 "
        f"{errs['gpt.layers.0.mlp.w1']:.3e}")
    if counts["fp_bwd"] != 4 or counts["fp"] != 4 or not errs[worst] <= \
            GRAD_TOL:
        raise AssertionError(f"MoE eager gradients: launches {counts}, "
                             f"worst error {errs[worst]}")
    layers = [layer.mlp for layer in model.gpt.layers]
    quant = [(quantize_weight(m.w1.detach(), "int8"),
              quantize_weight(m.w2.detach(), "int8")) for m in layers]
    x0 = model.gpt.embeddings(ids[:, :-1]).detach().reshape(
        -1, cfg.hidden_size)
    r = torch.from_numpy(np.random.RandomState(SEED + 5).standard_normal(
        x0.shape).astype(np.float32)).to(dev)
    dx = {}
    for use_kernel in (None, False):
        x = x0.clone().requires_grad_()
        y = x
        reset_counts()
        for m, (q1, q2) in zip(layers, quant):
            out, _ = moe_ffn(torch.nn.functional.layer_norm(y, y.shape[-1:]),
                             m.gate_weight.detach(), q1, m.b1.detach(), q2,
                             m.b2.detach(), top_k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity_factor,
                             use_kernel=use_kernel)
            y = y + out
        (y * r).sum().backward()
        torch.cuda.synchronize()
        if use_kernel is None:
            counts = gmm_counts()
        dx[use_kernel] = x.grad
    err = ((dx[None] - dx[False]).abs().max()
           / dx[False].abs().max()).item()
    log(f"[moe] input gradient through 2 layers of int8 expert stacks "
        f"({list(x0.shape)}, fp32): kernel vs plain {err:.3e} of its max "
        f"|grad| (tol {GRAD_TOL}); launches {counts}")
    if counts["int8_bwd"] != 4 or counts["int8"] != 4 or not err <= GRAD_TOL:
        raise AssertionError(f"int8 MoE input gradient: launches {counts}, "
                             f"error {err}")
    return 4, counts["int8_bwd"]


def phase_attention_routing(dev):
    """The repaired routing on the card: attention the flash kernels are
    not built for runs plain ``_sdpa_ref`` instead of raising — an eager
    2-layer model at gpt3-760m's width (16 heads of 96) and an fp16
    GPT-125M forward, each equal to the plain path's logits, with no flash
    launch; one d 96 ``gpt_spmd`` training step."""
    from dataclasses import replace

    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS

    ids = torch.from_numpy(np.random.RandomState(SEED + 6).randint(
        0, 50304, (2, 256))).to(dev)
    for label, cfg, dtype in (
            ("gpt3-760m width, 2 layers (d 96), fp32",
             replace(GPT_CONFIGS["gpt3-760m"], num_layers=2), torch.float32),
            ("GPT-125M fp16", GPT_CONFIGS["gpt3-125m"], torch.float16)):
        cfg = replace(cfg)
        model = moe_model(cfg, dev, dtype)
        with torch.no_grad():
            reset_counts()
            logits = model(ids)
            torch.cuda.synchronize()
            flash_n = read_counts()[0]
            cfg.use_flash_attention = False
            plain = model(ids)
        same = bool(torch.equal(logits, plain))
        log(f"[moe] routing: {label} eager forward on ids [2, 256]: logits "
            f"{tuple(logits.shape)} {logits.dtype}, finite "
            f"{bool(torch.isfinite(logits).all())}, equal to the plain "
            f"path's {same}, flash launches {flash_n}")
        if flash_n or not same or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"routing ({label}): flash {flash_n}, "
                                 f"equal {same}")
        del model
    cfg = replace(GPT_CONFIGS["gpt3-760m"], num_layers=2)
    step, params, mom, (sid, labels) = gpt_spmd.build_spmd_train_step(
        cfg, batch_size=2, seq_len=256, num_micro=1, lr=1e-3, device=dev)
    reset_counts()
    params, mom, loss = step(params, mom, sid, labels)
    torch.cuda.synchronize()
    log(f"[moe] routing: gpt_spmd step at gpt3-760m width (d 96), 2 layers, "
        f"b 2, s 256, fp32: loss {loss.item():.6f}, flash launches fwd/bwd "
        f"{read_counts()[0]}/{bwd_count()}")
    if not np.isfinite(loss.item()) or read_counts()[0] or bwd_count():
        raise AssertionError("d 96 training step did not run plain attention")


# -- phase 12 ---------------------------------------------------------------


def decode_inputs(geom, lengths, dtype, dev, seed):
    b, hq, hkv, d, ps, pps = geom
    rng = np.random.RandomState(seed)
    num_pages = b * pps + 1
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    lens = np.array(lengths, np.int32)
    for i in range(b):                 # unallocated past each context
        pt[i, (lens[i] + ps - 1) // ps:] = -1
    to = lambda a, t: torch.from_numpy(a).to(dev, t)  # noqa: E731
    return (to(q, dtype), to(kp, dtype), to(vp, dtype), to(pt, torch.int32),
            to(lens, torch.int32))


def decode_work(args):
    """(bytes, ops) the function needs on these inputs: the q rows of the
    slots with a context read, every output row written (empty slots as
    zeros), each slot's K and V rows read once, the page-table entries that
    cover the contexts and the lengths read; 2 x 2 x d ops per (q row,
    visible key)."""
    q, k_pages, _, pt, lengths = args
    b, hq, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    elt = q.element_size()
    lens = [min(max(n, 0), pt.shape[1] * ps) for n in lengths.tolist()]
    active = sum(1 for n in lens if n)
    nbytes = ((active + b) * hq * d * elt + 2 * sum(lens) * hkv * d * elt
              + 4 * (sum(-(-n // ps) for n in lens) + b))
    return nbytes, 4.0 * d * hq * sum(lens)


def phase_decode_kernel(dev):
    """(a) The decode kernel against its plain version and against the
    ragged kernel at chunk 1 on the same pools, at phase 3's serving pools
    and the odd shapes, fp32 and bf16; kernel / plain / bound times at the
    serving shape."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention as kern, paged_attention_reference as plain,
        ragged_paged_attention as ragged)

    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (geom, lengths) in enumerate((DECODE_SERVING,) + DECODE_ODD):
            args = decode_inputs(geom, lengths, dtype, dev, SEED + ci)
            lens = args[4]
            got = kern(*args)
            lane = ragged(args[0][:, None].contiguous(), *args[1:4], lens,
                          (lens > 0).to(torch.int32))[:, 0]
            torch.cuda.synchronize()
            want = plain(*args)
            active = lens > 0
            err, held = kernel_error(got[active], want[active], dtype)
            r_err, r_held = kernel_error(got[active], lane[active], dtype)
            b, hq, hkv, d, ps, pps = geom
            log(f"[legacy] decode kernel {str(dtype)[6:]} b{b} hq{hq} "
                f"hkv{hkv} d{d} page {ps} lengths {lengths}: vs plain "
                f"max_abs_err {err:.3e} (held {held:.3e}), vs the ragged "
                f"kernel at chunk 1 {r_err:.3e} (held {r_held:.3e}); tol "
                f"{KERNEL_TOL[dtype]}")
            if not (held <= KERNEL_TOL[dtype] and r_held <= KERNEL_TOL[dtype]):
                raise AssertionError(f"decode kernel {dtype} {geom}: error "
                                     f"{held} / vs ragged {r_held}")
            if torch.count_nonzero(got[~active]).item():
                raise AssertionError("decode kernel: an empty slot's rows "
                                     "are not zero")
            if ci:
                continue
            nbytes, nops = decode_work(args)
            st = dict(max_abs_err=err, ms=time_ms(lambda: kern(*args)),
                      plain_ms=time_ms(lambda: plain(*args), iters=5),
                      bound_ms=bound_ms(nbytes, nops, dtype), library_ms=None,
                      bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                      >= nops / PEAK_OPS[dtype] else "operations",
                      ragged_ms=time_ms(lambda: ragged(
                          args[0][:, None].contiguous(), *args[1:4], lens,
                          (lens > 0).to(torch.int32))))
            stats[dtype] = st
            log(f"[legacy] decode kernel {str(dtype)[6:]} at the serving "
                f"pools: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f}"
                f" ms, bound {st['bound_ms']:.6f} ms ({st['bound_by']}: "
                f"{nbytes / 1e6:.2f} MB, {nops / 1e9:.4f} GFLOP), the ragged "
                f"kernel at chunk 1 {st['ragged_ms']:.4f} ms, library_ms "
                "null (no single PyTorch call reads a paged pool)")
    return stats


def phase_ragged_dims(dev):
    """(b) The ragged kernel against its plain version at head dims 32, 80
    and 96 (phase 3's lanes, 16 heads), fp and int8 KV, fp32 and bf16."""
    from paddle_tpu_torch.inference.kv_cache import quantize_kv_rows
    from paddle_tpu_torch.ops.paged_attention import (
        ragged_paged_attention as kern,
        ragged_paged_attention_reference as plain, smem_bytes)

    for d in RAGGED_DIMS:
        g = dict(RAGGED_GEOM, hq=16, hkv=16, d=d)
        for dtype in (torch.float32, torch.bfloat16):
            for kv in ("fp", "int8"):
                q, kp, vp, pt, kv_lens, q_lens = ragged_inputs(
                    torch.float32, dev, g)
                sc = {}
                if kv == "int8":
                    (kp, ks), (vp, vs) = (quantize_kv_rows(
                        t.reshape(-1, 16, d)) for t in (kp, vp))
                    shape = (-1, g["ps"], 16)
                    kp, vp = kp.reshape(*shape, d), vp.reshape(*shape, d)
                    sc = dict(k_scales=ks.reshape(shape),
                              v_scales=vs.reshape(shape))
                else:
                    kp, vp = kp.to(dtype), vp.to(dtype)
                args = (q.to(dtype), kp, vp, pt, kv_lens, q_lens)
                got = kern(*args, **sc)
                torch.cuda.synchronize()
                want = plain(*args, **sc)
                valid = (torch.arange(got.shape[1], device=dev)[None]
                         < q_lens[:, None])
                err, held = kernel_error(got[valid], want[valid], dtype)
                log(f"[legacy] ragged kernel d {d} {str(dtype)[6:]} {kv} KV: "
                    f"max_abs_err {err:.3e}, held {held:.3e} (tol "
                    f"{KERNEL_TOL[dtype]}); shared memory "
                    f"{smem_bytes(g['chunk'], g['ps'], d)} B a block")
                if not held <= KERNEL_TOL[dtype] or torch.count_nonzero(
                        got[~valid]).item():
                    raise AssertionError(f"ragged kernel d {d} {dtype} {kv}:"
                                         f" error {held}")


class DecodeLogits:
    """Stands in for a legacy predictor's decode step and keeps, for every
    running slot, the logits row the step returned for the token it is
    about to emit, keyed by ``(req_id, index of the token in
    output_ids)``."""

    def __init__(self, sp):
        self.sp, self.step, self.rows = sp, sp._decode, {}
        sp._decode = self

    def __call__(self, *args):
        out = self.step(*args)
        for slot, req in self.sp.running.items():
            self.rows[(req.req_id, len(req.output_ids))] = \
                out[1][slot].clone()
        return out


def legacy_counts():
    """(decode kernel, ragged) launches since :func:`reset_counts`."""
    from paddle_tpu_torch.ops.paged_attention import paged_attention

    return paged_attention.launches, read_counts()[1]


def serve_legacy(sp, cfg, early, late, label, qmm_kind=None):
    """One fp32 served run of a legacy predictor: its launches (one decode
    kernel per layer and decode step, no ragged kernel; with ``qmm_kind``
    four weight-only GEMMs per layer and program run) and the logits rows
    behind its tokens. Returns (requests, rows)."""
    rows = DecodeLogits(sp)
    reset_counts()
    t0 = time.perf_counter()
    reqs = serve(sp, early, late)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode_n, ragged_n = legacy_counts()
    qmm = qmm_counts()
    steps, tel = sp.steps, sp.telemetry()
    prefills = int(tel["serving_requests_admitted"])
    L = cfg.num_layers
    want_qmm = {k: (4 * L * (steps + prefills) if k == qmm_kind else 0)
                for k in qmm}
    log(f"[legacy] serve ({label}) fp32: {steps} decode steps, {prefills} "
        f"prefills ({sp.prefill_trace_count} bucket shapes), decode-kernel "
        f"launches {decode_n} (steps x {L} = {steps * L}), ragged "
        f"{ragged_n}, weight-only GEMM {qmm}, preemptions "
        f"{tel['serving_preemptions']:.0f}, {wall:.3f} s wall")
    if decode_n != steps * L or not steps or ragged_n or qmm != want_qmm:
        raise AssertionError(f"({label}) launches: decode {decode_n}, ragged "
                             f"{ragged_n}, GEMM {qmm} (want {want_qmm}) over "
                             f"{steps} steps")
    return reqs, rows.rows


def phase_legacy_serve(model, cfg, dev, card, fp_outs, quant_streams,
                       fp16_step_ms):
    """(c) ``ServingPredictor(unified=False)`` on GPT-125M with the phase-6
    requests in fp32: (i) fp weights against the full-forward oracle and
    phase 6's unified streams, (ii) int8 weights against the plain
    quantized forward and phase 8 (a)'s streams; then bf16 legacy and
    unified runs in turns (medians of BF16_RUNS) and one profiled legacy
    run. Returns the fp32 runs' decode-kernel launches."""
    from paddle_tpu_torch.inference import ServingPredictor

    early, late = requests(cfg)
    total = 0
    for label, quant, want, kind in (
            ("i fp", {}, fp_outs, None),
            ("ii int8", dict(weight_dtype="int8"), quant_streams["a int8"],
             "int8")):
        sp = quant_predictor(model, cfg, quant, dev, unified=False)
        reqs, rows = serve_legacy(sp, cfg, early, late, label, kind)
        total += sp.steps * cfg.num_layers
        outs = [list(r.output_ids) for r in reqs]
        if kind is None:
            ties, logit_err = check_against_oracle(model, reqs, rows, dev)
            oracle, tol = "the full forward", LOGIT_TOL
        else:
            ties, logit_err = check_quant_oracle(sp, cfg, reqs, rows, False,
                                                 QUANT_SERVE[0][2])
            oracle, tol = "the plain quantized forward", QUANT_SERVE[0][2]
        same = sum(a == b for o, w in zip(outs, want) for a, b in zip(o, w))
        log(f"[legacy] serve ({label}) fp32: greedy streams match {oracle} "
            f"({sum(map(len, outs))} tokens, {ties} near ties), logits "
            f"max_abs_err {logit_err:.3e} (tol {tol}); equal to the unified "
            f"step's streams in {same} of {sum(map(len, want))} tokens")
        if outs != want:
            raise AssertionError(f"({label}) legacy streams differ from the "
                                 "unified step's")
    # bf16: the reference's legacy-two-jit / unified-step A/B, in turns
    runs = {False: [], True: []}
    for run in range(1 + BF16_RUNS):
        for unified in ((False, True) if run % 2 else (True, False)):
            sp16 = ServingPredictor(model, max_batch=8, device=dev,
                                    dtype=torch.bfloat16, unified=unified)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs16 = [list(r.output_ids) for r in serve(sp16, early, late)]
            torch.cuda.synchronize()
            if run:
                runs[unified].append((time.perf_counter() - t0, sp16.steps))
            if sum(map(len, outs16)) != MAX_NEW * len(outs16):
                raise AssertionError("bf16 legacy / unified: malformed "
                                     "streams")
    ms = {}
    for unified, rs in runs.items():
        wall, steps = sorted(rs)[len(rs) // 2]
        ms[unified] = (wall, 1e3 * wall / steps)
        log(f"[legacy] serve bf16 {'unified' if unified else 'legacy'}: "
            f"{steps} steps per run; median of {BF16_RUNS} runs {wall:.3f} s"
            f" = {MAX_NEW * 8 / wall:.1f} tokens/s, mean step "
            f"{ms[unified][1]:.3f} ms (runs: "
            f"{', '.join(f'{w:.3f}' for w, _ in rs)} s) ({card})")
    log(f"[legacy] serve bf16 generate wall legacy {ms[False][0]:.3f} s vs "
        f"unified {ms[True][0]:.3f} s; mean step legacy {ms[False][1]:.3f} "
        f"ms vs unified {ms[True][1]:.3f} ms (phase 6: {fp16_step_ms:.3f} "
        f"ms) ({card})")
    profile_serve(ServingPredictor(model, max_batch=8, device=dev,
                                   dtype=torch.bfloat16, unified=False),
                  early, late, card, "[legacy] (legacy)")
    return total


def phase_legacy_d96(dev):
    """(d) gpt3-760m's width at 2 layers (h 1536, 16 heads of 96), fp32,
    random weights: the per-op unified step (the ragged kernel at d 96) and
    the legacy path (the decode kernel at d 96) against the full forward.
    Returns the legacy run's decode-kernel launches."""
    from dataclasses import replace

    from paddle_tpu_torch.inference import ServingPredictor
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS

    cfg = replace(GPT_CONFIGS["gpt3-760m"], num_layers=LEGACY_D96_LAYERS)
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    early, late = requests(cfg)
    sp = ServingPredictor(model, max_batch=8, device=dev)
    rows = StepLogits(sp)
    reset_counts()
    reqs = serve(sp, early, late)
    torch.cuda.synchronize()
    ragged_n = read_counts()[1]
    ties, err = check_against_oracle(model, reqs, rows.rows, dev)
    unified = [list(r.output_ids) for r in reqs]
    log(f"[legacy] d 96 (gpt3-760m width, {cfg.num_layers} layers) unified "
        f"per-op fp32: {sp.steps} steps, ragged launches {ragged_n}; streams "
        f"match the full forward ({ties} near ties, logits max_abs_err "
        f"{err:.3e}); {len({t for o in unified for t in o})} distinct tokens")
    if ragged_n != sp.steps * cfg.num_layers or not ragged_n:
        raise AssertionError(f"d 96 unified: ragged launches {ragged_n}")
    leg = ServingPredictor(model, max_batch=8, device=dev, unified=False)
    reqs, rows = serve_legacy(leg, cfg, early, late, "d 96")
    ties, err = check_against_oracle(model, reqs, rows, dev)
    outs = [list(r.output_ids) for r in reqs]
    log(f"[legacy] d 96 legacy fp32: streams match the full forward ({ties} "
        f"near ties, logits max_abs_err {err:.3e}); equal to the unified "
        f"streams: {outs == unified}")
    if outs != unified:
        raise AssertionError("d 96: legacy and unified streams differ")
    return leg.steps * cfg.num_layers


# -- phase 7 ----------------------------------------------------------------


def bwd_work(b, sq, sk, hq, hkv, d, causal, elt):
    """(bytes, ops) of the backward on these shapes: q, k, v, do read and
    dq, dk, dv written once in the input type, lse and delta read in fp32;
    five products of 2 x d ops per visible (row, key) pair."""
    pairs = sum(min(max(r + sk - sq + 1, 0), sk) for r in range(sq)) \
        if causal else sq * sk
    nbytes = (3 * b * sq * hq * d + 4 * b * sk * hkv * d) * elt \
        + 8 * b * hq * sq
    return nbytes, 10.0 * d * pairs * b * hq


def bwd_inputs(shape, dtype, dev, seed):
    """q, k, v, do drawn from a numpy seed, and the plain forward's lse and
    delta = rowsum(do * out) on them (what the custom op hands the kernel)."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_reference

    b, sq, sk, hq, hkv, d, causal = shape
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev, dtype) for s in
        ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d)))
    out, lse = flash_attention_reference(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    return q, k, v, do, lse, delta.reshape(b * hq, 1, sq).contiguous()


def events_ms(fn, iters=10, repeats=5) -> float:
    """Device milliseconds per call from CUDA events around ``iters`` eager
    calls (for calls that run autograd, which a CUDA graph does not capture
    here), the least of ``repeats`` runs after 3 warm-up calls: a host
    stall can only add to a run."""
    for _ in range(3):
        fn()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return min(runs)


def sdpa_bwd_ms(q, k, v, do) -> float:
    """SDPA's backward (the aten backward PyTorch picks for these inputs)
    on the same tensors, timed, never used."""
    import torch.nn.functional as tnf

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = tnf.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    return events_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                 retain_graph=True))


def one_key_rows(sq, sk, causal, dev):
    """[sq] bool: the queries that see exactly one key. Their dq is zero in
    exact arithmetic (ds = p (dp - delta) with p = 1 and dp = delta)."""
    r = torch.arange(sq, device=dev)
    seen = (r + sk - sq + 1).clamp(0, sk) if causal else torch.full_like(
        r, sk)
    return seen == 1


def bwd_error(got, want, dtype, zero_rows=None):
    """(max abs error, held error, zero-row error) of one gradient
    ``[b, s, h, d]``. fp32: held over the tensor's max |want|. bf16: held
    per row as ``kernel_error``, except the ``zero_rows`` (dq of the
    queries that see one key), whose exact value is zero: both sides
    return fp32 rounding noise there (the tensor cores sum dp in another
    rounding than the plain GEMM and delta), so such a row has no scale of
    its own and is held as an fp32 gradient, over the tensor's max |want|,
    to ``BWD_TOL[float32]`` (the zero-row error; 0 where there is none)."""
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        err = (got - want).abs().max().item()
        return err, err / scale, 0.0
    if zero_rows is None or not zero_rows.any():
        return (*kernel_error(got, want, dtype), 0.0)
    zero = zero_rows.view(1, -1, 1).expand(got.shape[:-1])
    err, held = kernel_error(got[~zero], want[~zero], dtype)
    zero_err = (got[zero].float() - want[zero].float()).abs().max().item()
    return max(err, zero_err), held, zero_err / scale


def check_flash_bwd(args, shape, dtype, tag):
    """The backward kernel vs its plain version on one case, held as
    ``bwd_error``. Returns the max abs error over dq, dk, dv."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd as kern, flash_attention_bwd_reference as plain)

    b, sq, sk, hq, hkv, d, causal = shape
    got = kern(*args, causal=causal)
    torch.cuda.synchronize()
    want = plain(*args, causal=causal)
    zero_rows = one_key_rows(sq, sk, causal, got[0].device)
    errs = {name: bwd_error(g, w, dtype, zero_rows if name == "dq" else None)
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    worst = max(h for _, h, _ in errs.values())
    worst_zero = max(z for _, _, z in errs.values())
    label = (f"{str(dtype)[6:]} b{b} sq{sq} sk{sk} hq{hq} hkv{hkv} d{d} "
             f"{'causal' if causal else 'non-causal'}")
    log(f"{tag} flash bwd {label}: " + ", ".join(
        f"{n} max_abs_err {e:.3e} held {hd:.3e}"
        + (f" zero rows {z:.3e}" if z else "")
        for n, (e, hd, z) in errs.items())
        + f" (tol {BWD_TOL[dtype]}; zero rows {BWD_TOL[torch.float32]})")
    if not (worst <= BWD_TOL[dtype]
            and worst_zero <= BWD_TOL[torch.float32]):
        raise AssertionError(f"flash bwd kernel {label}: held error {worst} "
                             f"> {BWD_TOL[dtype]} or zero-row error "
                             f"{worst_zero} > {BWD_TOL[torch.float32]}")
    return max(e for e, _, _ in errs.values())


def flash_bwd_times(args, shape, dtype, err, tag, iters, plain_iters):
    """Kernel, plain and SDPA-backward times of one case with its bound,
    logged with the achieved rates; returns the kernels-line fields."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd as kern, flash_attention_bwd_reference as plain)

    b, sq, sk, hq, hkv, d, causal = shape
    nbytes, nops = bwd_work(*shape, args[0].element_size())
    st = dict(max_abs_err=err,
              ms=time_ms(lambda: kern(*args, causal=causal), iters=iters,
                         replays=2),
              plain_ms=time_ms(lambda: plain(*args, causal=causal),
                               iters=plain_iters, replays=2),
              library_ms=sdpa_bwd_ms(*args[:4]),
              bound_ms=bound_ms(nbytes, nops, dtype),
              bound_by="bytes" if nbytes / HBM_BYTES_PER_S
              >= nops / PEAK_OPS[dtype] else "operations")
    log(f"{tag} flash bwd {str(dtype)[6:]} {[b, sq, hq, d]} causal: kernel "
        f"{st['ms']:.4f} ms ({flash_rate(st['ms'], nbytes, nops, dtype)}), "
        f"plain {st['plain_ms']:.4f} ms, library (torch sdpa backward) "
        f"{st['library_ms']:.4f} ms "
        f"({flash_rate(st['library_ms'], nbytes, nops, dtype)}), bound "
        f"{st['bound_ms']:.4f} ms ({st['bound_by']}: {nbytes / 1e6:.2f} MB, "
        f"{nops / 1e9:.3f} GFLOP)")
    return st


def phase_flash_bwd(dev):
    """The backward kernel vs its plain version at the training shape
    (timed) and odd shapes in fp32 and bf16; the bf16 tensor-core kernel at
    every head dim of ``FLASH_TC_CASES`` and at ``FLASH_LONG`` (timed); the
    forward kernel at the training shape (timed: the kernels line's
    flash_attention_fwd row in bf16)."""
    b, s, h, d = BWD_SHAPE
    cases = [(b, s, s, h, h, d, True),
             (2, 200, 456, 12, 4, 64, True),      # sq != sk, GQA
             (2, 333, 333, 12, 12, 64, True),     # tail not a tile multiple
             (1, 300, 100, 4, 1, 128, True),      # rows that see no key
             (2, 130, 77, 6, 3, 64, False)]       # non-causal, sq > sk
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        for ci, shape in enumerate(cases):
            args = bwd_inputs(shape, dtype, dev, SEED + ci)
            err = check_flash_bwd(args, shape, dtype, "[train]")
            if not ci:
                stats[dtype] = flash_bwd_times(args, shape, dtype, err,
                                               "[train]", 10, 2)
    for ci, shape in enumerate(FLASH_TC_CASES):
        check_flash_bwd(bwd_inputs(shape, torch.bfloat16, dev,
                                   SEED + 10 + ci), shape, torch.bfloat16,
                        "[train]")
    bl, sl, hl, dl = FLASH_LONG
    shape = (bl, sl, sl, hl, hl, dl, True)
    args = bwd_inputs(shape, torch.bfloat16, dev, SEED)
    err = check_flash_bwd(args, shape, torch.bfloat16, "[train]")
    stats["long"] = flash_bwd_times(args, shape, torch.bfloat16, err,
                                    "[train]", 5, 1)
    del args
    # the forward kernel at the same shape: held against its plain version,
    # and timed for the step's breakdown and the kernels line
    for dtype in (torch.float32, torch.bfloat16):
        args = bwd_inputs(cases[0], dtype, dev, SEED)[:3]
        err = check_flash_fwd(args, cases[0], dtype, "[train]")
        fwd = flash_fwd_times(args, cases[0], dtype, err, "[train]", 10, 2,
                              2, 2)
        stats[dtype]["fwd"] = fwd
        stats[dtype]["fwd_ms"] = fwd["ms"]
    return stats


def _lm_loss(model, ids):
    logits = model(ids[:, :-1]).float()
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1))


def _grad_errors(got: dict, want: dict):
    """{name: max abs error over the leaf's max |want|}; raises when a
    gradient is missing on either side."""
    missing = sorted(n for n in want if got.get(n) is None
                     or want[n] is None)
    if missing or set(got) != set(want):
        raise AssertionError(f"gradients missing for {missing}")
    return {n: ((got[n].float() - want[n].float()).abs().max()
                / want[n].float().abs().max().clamp_min(1e-30)).item()
            for n in want}


def phase_eager_grads(model, cfg, dev):
    """The eager GPT's backward through the flash kernels: the regression
    test of the fault where flash attention had no gradient on the card."""
    ids = torch.from_numpy(np.random.RandomState(SEED + 2).randint(
        0, cfg.vocab_size, (2, 257))).to(dev)
    grads = {}
    for flash in (True, False):
        cfg.use_flash_attention = flash
        model.zero_grad(set_to_none=True)
        reset_counts()
        loss = _lm_loss(model, ids)
        loss.backward()
        torch.cuda.synchronize()
        fwd_n, bwd_n = read_counts()[0], bwd_count()
        grads[flash] = {n: p.grad for n, p in model.named_parameters()}
        log(f"[train] eager GPT-125M ids [2, 256] "
            f"{'flash' if flash else 'plain'} attention: loss "
            f"{loss.item():.6f}, flash launches fwd {fwd_n}"
            f" bwd {bwd_n}")
        want_n = cfg.num_layers if flash else 0
        if fwd_n != want_n or bwd_n != want_n:
            raise AssertionError(f"eager backward ran flash fwd {fwd_n}, bwd "
                                 f"{bwd_n} times (want {want_n})")
    cfg.use_flash_attention = True
    model.zero_grad(set_to_none=True)
    errs = _grad_errors(grads[True], grads[False])
    worst = max(errs, key=errs.get)
    log(f"[train] eager gradients, flash vs plain: {len(errs)} parameters, "
        f"none None; worst {worst} {errs[worst]:.3e} of its max |grad| (tol "
        f"{GRAD_TOL}); qkv_proj.weight of layer 0 "
        f"{errs['gpt.layers.0.attn.qkv_proj.weight']:.3e}")
    if not errs[worst] <= GRAD_TOL:
        raise AssertionError(f"eager gradient {worst}: flash vs plain "
                             f"{errs[worst]} > {GRAD_TOL}")


def phase_train_fp32(dev):
    """gpt3-760m's width at 2 layers in fp32 (TF32 off): flash vs plain
    attention for the first step's loss and every gradient leaf, and for
    three steps' losses at lr 0.05."""
    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.convert import random_train_params
    from paddle_tpu_torch.models.gpt import GPTConfig

    base = dict(TRAIN, num_layers=2)
    weights = random_train_params(GPTConfig(**base), SEED)
    runs = {}
    for flash in (True, False):
        cfg = GPTConfig(**base, use_flash_attention=flash)
        step, params, mom, (ids, labels) = gpt_spmd.build_spmd_train_step(
            cfg, batch_size=2, seq_len=1024, num_micro=1, lr=0.05,
            device=dev, params=weights)
        reset_counts()
        loss0, grads = gpt_spmd.value_and_grad(params, ids, labels, cfg, 1)
        torch.cuda.synchronize()
        counts = (read_counts()[0], bwd_count())
        grads = dict(gpt_spmd.leaves(grads))
        losses = []
        for _ in range(3):
            params, mom, loss = step(params, mom, ids, labels)
            losses.append(loss.item())
        runs[flash] = (loss0.item(), grads, losses, counts)
        log(f"[train] fp32 760M-width 2 layers b2 s1024 "
            f"{'flash' if flash else 'plain'}: first loss {loss0.item():.6f},"
            f" flash launches fwd/bwd {counts}, 3 steps at lr 0.05: "
            f"{', '.join(f'{x:.6f}' for x in losses)}")
        if not losses[2] < losses[0] or not np.isfinite(losses).all():
            raise AssertionError(f"fp32 training loss did not fall: {losses}")
        del step, params, mom, grads
    if runs[True][3] != (2, 2) or runs[False][3] != (0, 0):
        raise AssertionError(f"flash launches {runs[True][3]} / "
                             f"{runs[False][3]} (want (2, 2) / (0, 0))")
    errs = _grad_errors(runs[True][1], runs[False][1])
    worst = max(errs, key=errs.get)
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip([runs[True][0]] + runs[True][2],
                       [runs[False][0]] + runs[False][2]))
    log(f"[train] fp32 flash vs plain: {len(errs)} gradient leaves, worst "
        f"{worst} {errs[worst]:.3e} of its max |grad| (tol {GRAD_TOL}); "
        f"losses rel err {loss_err:.3e} (tol {LOSS_TOL})")
    if not (errs[worst] <= GRAD_TOL and loss_err <= LOSS_TOL):
        raise AssertionError("fp32 training: flash and plain disagree")


def phase_train_bf16_parity(dev):
    """bf16 ``build_spmd_train_step`` with flash vs plain attention at the
    flagship width (12 heads of 128) and at gpt3-760m's ``GPT_CONFIGS``
    width (16 heads of 96), both cut to 2 layers, b 2, s 1024, recompute
    with the flash outputs saved: the loss, every gradient leaf and the
    flash launches (2 forward and 2 backward a step; none on the plain
    path)."""
    from dataclasses import replace

    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.convert import random_train_params
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTConfig

    for label, base in (
            ("flagship width, 12 heads of 128",
             GPTConfig(**dict(TRAIN, num_layers=2))),
            ("gpt3-760m width, 16 heads of 96", replace(
                GPT_CONFIGS["gpt3-760m"], num_layers=2, recompute=True,
                remat_save_attn=True))):
        weights = random_train_params(base, SEED)
        runs = {}
        for flash in (True, False):
            cfg = replace(base, use_flash_attention=flash)
            step, params, mom, (ids, labels) = gpt_spmd.build_spmd_train_step(
                cfg, batch_size=2, seq_len=1024, num_micro=1, lr=0.05,
                device=dev, params=weights, dtype=torch.bfloat16)
            reset_counts()
            loss, grads = gpt_spmd.value_and_grad(params, ids, labels, cfg, 1)
            torch.cuda.synchronize()
            runs[flash] = (loss.item(), dict(gpt_spmd.leaves(grads)),
                           (read_counts()[0], bwd_count()))
            del step, params, mom, grads
        errs = _grad_errors(runs[True][1], runs[False][1])
        worst = max(errs, key=errs.get)
        loss_err = abs(runs[True][0] - runs[False][0]) / abs(runs[False][0])
        log(f"[train] bf16 {label}, 2 layers b2 s1024 recompute+save_attn, "
            f"flash vs plain: loss {runs[True][0]:.6f} vs "
            f"{runs[False][0]:.6f} (rel err {loss_err:.3e}, tol "
            f"{BF16_LOSS_TOL}); {len(errs)} gradient leaves, worst {worst} "
            f"{errs[worst]:.3e} of its max |grad| (tol {BF16_GRAD_TOL}); "
            f"flash launches fwd/bwd {runs[True][2]} / {runs[False][2]}")
        if runs[True][2] != (2, 2) or runs[False][2] != (0, 0):
            raise AssertionError(f"bf16 {label}: flash launches "
                                 f"{runs[True][2]} / {runs[False][2]} (want "
                                 "(2, 2) / (0, 0))")
        if not (errs[worst] <= BF16_GRAD_TOL and loss_err <= BF16_LOSS_TOL):
            raise AssertionError(f"bf16 training ({label}): flash and plain "
                                 "disagree")


def phase_train_bf16(dev, card, bwd_stats, fused=False, unfused=None):
    """The flagship configuration: full-width gpt3-760m, bf16, timed; with
    ``fused`` the ``fused_mlp`` step (phase 9), logged beside ``unfused``,
    the result of the unfused run of the same call."""
    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.convert import random_train_params
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(**TRAIN, fused_mlp=fused)
    tag = "[fused]" if fused else "[train]"
    label = "fused_mlp" if fused else "unfused"
    b, s, L = TRAIN_BATCH, cfg.max_seq_len, cfg.num_layers
    t0 = time.perf_counter()
    step, params, mom, (ids, labels) = gpt_spmd.build_spmd_train_step(
        cfg, batch_size=b, seq_len=s, num_micro=1, lr=1e-4, momentum=0.9,
        device=dev, params=random_train_params(cfg, SEED),
        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"{tag} bf16 gpt3-760m {label}: {cfg.num_params() / 1e6:.1f} M "
        f"params, set up in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, mom, loss = step(params, mom, ids, labels)
        losses.append(loss.item())          # synchronizes
        walls.append(time.perf_counter() - t0)
    fwd_n, bwd_n = read_counts()[0], bwd_count()
    fused_n = fused_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not np.isfinite(losses).all():
        raise AssertionError(f"bf16 training loss not finite: {losses}")
    if fwd_n != L * TRAIN_STEPS or bwd_n != L * TRAIN_STEPS:
        raise AssertionError(f"flash launches fwd {fwd_n}, bwd {bwd_n} over "
                             f"{TRAIN_STEPS} steps (want {L} each per step)")
    # a step: two LNs a layer, each run again by the recompute; one GELU a
    # layer, run again too; one backward each
    per_step = (4 * L, 2 * L, 2 * L, L) if fused else (0, 0, 0, 0)
    if fused_n != tuple(TRAIN_STEPS * n for n in per_step):
        raise AssertionError(f"fused launches {fused_n} over {TRAIN_STEPS} "
                             f"steps (want {per_step} per step)")
    timed = walls[1:]
    step_s = sum(timed) / len(timed)
    tps = b * s / step_s
    flops_per_token = 6 * cfg.num_params() + 6 * L * cfg.hidden_size * s
    mfu = tps * flops_per_token / PEAK_OPS[torch.bfloat16]
    attn_ms = L * (bwd_stats["ms"] + bwd_stats["fwd_ms"])
    log(f"{tag} bf16 gpt3-760m {label} b{b} s{s} recompute+save_attn: "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; flash launches fwd "
        f"{fwd_n} bwd {bwd_n} ({L} each per step); fused launches LN fwd/bwd"
        f", GELU fwd/bwd {fused_n} ({per_step} per step); step "
        f"{1e3 * step_s:.1f} ms (mean of {len(timed)} after 1 warm-up: "
        f"{', '.join(f'{1e3 * w:.1f}' for w in timed)}), {tps:.1f} tokens/s,"
        f" MFU {mfu:.4f} ({flops_per_token / 1e9:.3f} GFLOP/token over "
        f"989 TFLOP/s bf16); flash kernels alone {attn_ms:.1f} ms a step "
        f"({L} x (bwd {bwd_stats['ms']:.3f} + fwd {bwd_stats['fwd_ms']:.3f}) "
        f"ms, phase-7 kernel times); peak device memory {peak_gb:.2f} GB "
        f"({card})")
    result = dict(fwd_n=fwd_n, bwd_n=bwd_n, fused_n=fused_n,
                  step_ms=1e3 * step_s, tps=tps, mfu=mfu, peak_gb=peak_gb)
    if unfused is not None:
        log(f"{tag} bf16 gpt3-760m fused_mlp vs unfused, same call: step "
            f"{result['step_ms']:.1f} vs {unfused['step_ms']:.1f} ms, "
            f"tokens/s {tps:.1f} vs {unfused['tps']:.1f}, MFU {mfu:.4f} vs "
            f"{unfused['mfu']:.4f}, peak {peak_gb:.2f} vs "
            f"{unfused['peak_gb']:.2f} GB (one run each, not a benchmark)")
    profile_step(step, params, mom, ids, labels, card, tag)
    return result


# -- phase 9 ----------------------------------------------------------------


def fused_inputs(kind, shape, dtype, dev, seed):
    """The inputs of one fused kernel at ``shape``, drawn on the card from
    a seeded generator: LN ``x, r, dy, dso [rows, h]`` and ``g, b [h]``;
    GELU ``u`` (the GEMM output), ``dy [rows, n]`` and ``b [n]``."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shp, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shp, generator=gen, device=dev)
                ).to(dtype)

    h = shape[-1]
    if kind.startswith("ln"):
        return dict(x=draw(shape), r=draw(shape), dy=draw(shape),
                    dso=draw(shape), g=draw((h,), 0.1, 1.0),
                    b=draw((h,), 0.1))
    return dict(u=draw(shape, 2.0), dy=draw(shape), b=draw((h,), 0.5))


def fused_work(kind, variant, rows, h, elt):
    """(bytes, ops) of one call: every input read once and every output
    written once (the statistics and parameter sums in fp32), and
    ``FUSED_OPS`` operations an element (+1 for the residual, dso or
    bias)."""
    extra = variant != "plain"
    n = rows * h
    nbytes = {"ln_fwd": (2 + 2 * extra) * n * elt + 2 * h * elt + 8 * rows,
              "ln_bwd": (3 + extra) * n * elt + 8 * rows + h * elt + 8 * h,
              "gelu_fwd": 2 * n * elt + extra * h * elt,
              "gelu_bwd": 3 * n * elt + extra * (h * elt + 4 * h)}[kind]
    return nbytes, (FUSED_OPS[kind] + extra) * float(n)


def fused_held(got, want, dtype):
    """(max abs error, held error): fp32 tensors over the tensor's max
    |want|, bf16 tensors per row (``kernel_error``)."""
    if got.dtype == torch.float32:
        err = (got - want).abs().max().item()
        return err, err / max(want.abs().max().item(), 1e-30)
    return kernel_error(got, want, dtype)


def fused_calls(kind, variant, t):
    """(kernel, plain, library or None) callables of one case on the
    inputs ``t``; the library call computes the same function in one
    PyTorch call (only the variants without residual, dso or bias have
    one)."""
    import torch.nn.functional as tnf

    from paddle_tpu_torch.ops import fused_mlp as fm

    eps, extra = 1e-5, variant != "plain"
    if kind == "ln_fwd":
        r = t["r"] if extra else None
        args = (t["x"], r, t["g"], t["b"], eps)
        lib = (None if extra else lambda: tnf.layer_norm(
            t["x"], t["x"].shape[-1:], t["g"], t["b"], eps))
        return (lambda: fm.ln_fwd(*args), lambda: fm.ln_fwd_reference(*args),
                lib)
    if kind == "ln_bwd":
        # the statistics and s of the plain forward on the same inputs
        r = t["r"] if extra else None
        fwd = fm.ln_fwd_reference(t["x"], r, t["g"], t["b"], eps)
        s = fwd[1] if extra else t["x"]
        args = (t["dy"], t["dso"] if extra else None, s, fwd[-2], fwd[-1],
                t["g"])
        lib = None
        if not extra:
            h = t["x"].shape[-1]
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                t["x"], [h], t["g"], t["b"], eps)
            lib = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa
                t["dy"], t["x"], [h], mean, rstd, t["g"], t["b"],
                [True, True, True])
        return (lambda: fm.ln_bwd(*args), lambda: fm.ln_bwd_reference(*args),
                lib)
    bias = t["b"] if extra else None
    if kind == "gelu_fwd":
        lib = (None if extra else lambda: tnf.gelu(t["u"],
                                                   approximate="tanh"))
        return (lambda: fm.gelu_fwd(t["u"], bias),
                lambda: fm.gelu_fwd_reference(t["u"], bias), lib)
    lib = (None if extra else lambda: torch.ops.aten.gelu_backward(
        t["dy"], t["u"], approximate="tanh"))
    return (lambda: fm.gelu_bwd(t["dy"], t["u"], bias),
            lambda: fm.gelu_bwd_reference(t["dy"], t["u"], bias), lib)


FUSED_KINDS = (("ln_fwd", ("plain", "residual")),
               ("ln_bwd", ("plain", "dso")),
               ("gelu_fwd", ("plain", "bias")),
               ("gelu_bwd", ("plain", "bias")))


def phase_fused_kernels(dev):
    """Each fused kernel and variant against its plain version at the
    flagship, GPT-125M and an odd shape, fp32 and bf16; kernel / plain /
    library times and the bound at the flagship shape."""
    stats = {}
    for kind, variants in FUSED_KINDS:
        shapes = FUSED_LN_SHAPES if kind.startswith("ln") \
            else FUSED_GELU_SHAPES
        for dtype in (torch.float32, torch.bfloat16):
            for variant in variants:
                for si, shape in enumerate(shapes):
                    t = fused_inputs(kind, shape, dtype, dev, SEED + si)
                    kern, plain, lib = fused_calls(kind, variant, t)
                    got = kern()
                    torch.cuda.synchronize()
                    want = plain()
                    got = [g for g in (got if isinstance(got, tuple)
                                       else (got,)) if g is not None]
                    want = [w for w in (want if isinstance(want, tuple)
                                        else (want,)) if w is not None]
                    errs = [fused_held(g, w, dtype) for g, w in zip(got, want)]
                    max_err = max(e for e, _ in errs)
                    held = max(hd for _, hd in errs)
                    tol = FUSED_TOL[dtype]
                    log(f"[fused] {kind} {variant} {str(dtype)[6:]} "
                        f"{list(shape)}: {len(errs)} outputs, max_abs_err "
                        f"{max_err:.3e}, held {held:.3e} (tol {tol})")
                    if not (len(got) == len(want) and held <= tol):
                        raise AssertionError(
                            f"fused {kind} {variant} {dtype} {shape}: held "
                            f"error {held} > {tol}")
                    if kind == "ln_fwd" and variant == "residual" and \
                            not torch.equal(got[1], want[1]):
                        raise AssertionError("ln_fwd: s is not the plain "
                                             "version's rounding of x + r")
                    if si:
                        continue
                    nbytes, nops = fused_work(kind, variant, *shape,
                                              t["dy"].element_size())
                    st = dict(
                        max_abs_err=max_err, ms=time_ms(kern, iters=20,
                                                        replays=3),
                        plain_ms=time_ms(plain, iters=5, replays=2),
                        library_ms=None if lib is None else time_ms(
                            lib, iters=20, replays=3),
                        bound_ms=bound_ms(nbytes, nops, torch.float32),
                        bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                        >= nops / PEAK_OPS[torch.float32]
                        else "operations")
                    stats[(kind, variant, dtype)] = st
                    lib_txt = ("null (no single PyTorch call computes it)"
                               if lib is None else
                               f"{st['library_ms']:.4f} ms")
                    log(f"[fused] {kind} {variant} {str(dtype)[6:]} "
                        f"{list(shape)}: kernel {st['ms']:.4f} ms, plain "
                        f"{st['plain_ms']:.4f} ms, library {lib_txt}, bound "
                        f"{st['bound_ms']:.4f} ms ({st['bound_by']}: "
                        f"{nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} GFLOP), "
                        f"{st['bound_ms'] / st['ms']:.3f} of the bound")
                    del t
    return stats


def phase_fused_eager(model, cfg, dev):
    """The eager GPT-125M with ``fused_mlp`` on ids [4, 512], fp32: logits
    and every parameter's gradient against the same weights unfused."""
    ids = torch.from_numpy(np.random.RandomState(SEED + 3).randint(
        0, cfg.vocab_size, (4, 513))).to(dev)
    runs = {}
    for fused in (True, False):
        cfg.fused_mlp = fused
        model.zero_grad(set_to_none=True)
        reset_counts()
        logits = model(ids[:, :-1]).float()
        torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size), ids[:, 1:].reshape(-1)
        ).backward()
        torch.cuda.synchronize()
        runs[fused] = (logits.detach(), {n: p.grad for n, p in
                                         model.named_parameters()},
                       fused_counts())
    cfg.fused_mlp = False
    model.zero_grad(set_to_none=True)
    L = cfg.num_layers
    want = (2 * L, 2 * L, L, L)
    if runs[True][2] != want or any(runs[False][2]):
        raise AssertionError(f"eager fused launches {runs[True][2]} (want "
                             f"{want}), unfused {runs[False][2]}")
    logit_err = ((runs[True][0] - runs[False][0]).abs().max()
                 / runs[False][0].abs().max()).item()
    errs = _grad_errors(runs[True][1], runs[False][1])
    worst = max(errs, key=errs.get)
    log(f"[fused] eager GPT-125M ids [4, 512] fp32, fused vs unfused: "
        f"logits {logit_err:.3e} of the max |logit|, {len(errs)} parameter "
        f"gradients, none None, worst {worst} {errs[worst]:.3e} of its max "
        f"|grad| (tol {GRAD_TOL}); fused launches LN fwd/bwd, GELU fwd/bwd "
        f"{runs[True][2]}")
    if not (logit_err <= GRAD_TOL and errs[worst] <= GRAD_TOL):
        raise AssertionError("eager fused vs unfused disagree")


def phase_fused_train_fp32(dev):
    """gpt3-760m's width at 2 layers in fp32 (TF32 off), recompute: the
    fused step, with and without ``remat_save_ln``, against the unfused
    one for the first loss, every gradient leaf and three steps' losses."""
    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.convert import random_train_params
    from paddle_tpu_torch.models.gpt import GPTConfig

    base = dict(TRAIN, num_layers=2)
    weights = random_train_params(GPTConfig(**base), SEED)
    L = base["num_layers"]
    runs = {}
    for label, over, want in (
            ("unfused", {}, (0, 0, 0, 0)),
            ("fused", dict(fused_mlp=True), (4 * L, 2 * L, 2 * L, L)),
            ("fused+save_ln", dict(fused_mlp=True, remat_save_ln=True),
             (2 * L, 2 * L, 2 * L, L))):
        cfg = GPTConfig(**base, **over)
        step, params, mom, (ids, labels) = gpt_spmd.build_spmd_train_step(
            cfg, batch_size=2, seq_len=1024, num_micro=1, lr=0.05,
            device=dev, params=weights)
        reset_counts()
        loss0, grads = gpt_spmd.value_and_grad(params, ids, labels, cfg, 1)
        torch.cuda.synchronize()
        counts = fused_counts()
        grads = dict(gpt_spmd.leaves(grads))
        losses = []
        for _ in range(3):
            params, mom, loss = step(params, mom, ids, labels)
            losses.append(loss.item())
        runs[label] = (loss0.item(), grads, losses)
        log(f"[fused] fp32 760M-width 2 layers b2 s1024 recompute {label}: "
            f"first loss {loss0.item():.6f}, launches LN fwd/bwd, GELU "
            f"fwd/bwd {counts} (want {want}), 3 steps at lr 0.05: "
            f"{', '.join(f'{x:.6f}' for x in losses)}")
        if counts != want:
            raise AssertionError(f"{label}: fused launches {counts}, want "
                                 f"{want}")
        if not losses[2] < losses[0] or not np.isfinite(losses).all():
            raise AssertionError(f"fp32 training loss did not fall: {losses}")
        del step, params, mom, grads
    for label in ("fused", "fused+save_ln"):
        errs = _grad_errors(runs[label][1], runs["unfused"][1])
        worst = max(errs, key=errs.get)
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip([runs[label][0]] + runs[label][2],
                           [runs["unfused"][0]] + runs["unfused"][2]))
        log(f"[fused] fp32 {label} vs unfused: {len(errs)} gradient leaves,"
            f" worst {worst} {errs[worst]:.3e} of its max |grad| (tol "
            f"{GRAD_TOL}); losses rel err {loss_err:.3e} (tol "
            f"{FUSED_LOSS_TOL})")
        if not (errs[worst] <= GRAD_TOL and loss_err <= FUSED_LOSS_TOL):
            raise AssertionError(f"fp32 training: {label} and unfused "
                                 "disagree")


KERNEL_GROUPS = (("flash fwd", ("flash_fwd_kernel", "flash_fwd_tc_kernel",
                                 "flash_fwd_wg_kernel")),
                 ("flash bwd", ("flash_bwd_kernel", "flash_bwd_tc_kernel")),
                 ("fused LN / GELU", ("ln_fwd_kernel", "ln_bwd_kernel",
                                      "gelu_kernel")),
                 ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas",
                                    "nvjet")),
                 ("copies and fills", ("memcpy", "memset")))


def profile_step(step, params, mom, ids, labels, card, tag="[train]"):
    """One more training step under ``torch.profiler``: device time by
    kernel group, and the device's busy and idle share of the step's wall
    time (one stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, mom, ids, labels)[2].item()
        wall_us = 1e6 * (time.perf_counter() - t0)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other PyTorch kernels"] = 0.0
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    for ev in kernels:
        key = ev.key.lower()
        name = next((n for n, marks in KERNEL_GROUPS
                     if any(m in key for m in marks)),
                    "other PyTorch kernels")
        groups[name] += ev.self_device_time_total
    launches = sum(ev.count for ev in kernels)
    busy = sum(groups.values())
    if busy <= 0:
        log(f"{tag} profiler: no device time in the trace (device "
            "breakdown not measured)")
        return
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"{tag} profiled kernel {ev.self_device_time_total / 1e3:8.2f} "
            f"ms x{ev.count:<4d} {ev.key[:90]}")
    flash = groups["flash fwd"] + groups["flash bwd"]
    log(f"{tag} profiled bf16 step: wall {wall_us / 1e3:.1f} ms (under the "
        f"profiler), device busy {busy / 1e3:.1f} ms = "
        f"{busy / wall_us:.3f} of it, idle {1 - busy / wall_us:.3f}; "
        f"{launches} kernels; flash share of device time "
        f"{flash / busy:.3f}; " + ", ".join(
            f"{n} {t / 1e3:.1f} ms ({t / busy:.3f})"
            for n, t in groups.items()) + f" ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs on a CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no paddle_tpu_torch package beside {__file__}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dataclasses import replace

    from paddle_tpu_torch.models.convert import random_state, state_from_jax_numpy
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.flash_attention import bwd_smem_bytes
    from paddle_tpu_torch.ops.flash_attention import smem_bytes as flash_smem
    from paddle_tpu_torch.ops.mega_decode import smem_bytes as mega_smem
    from paddle_tpu_torch.ops.paged_attention import decode_smem_bytes
    from paddle_tpu_torch.ops.paged_attention import smem_bytes as ragged_smem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {kind}; nvidia-smi: {card}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build(["ragged_paged_attention", "flash_attention_fwd",
                          "flash_attention_bwd", "quant_matmul",
                          "fused_mlp", "mega_decode", "grouped_matmul",
                          "paged_decode_attention"])
    log(f"[build] eight kernel sources for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in ptxas_summary(name, text):
            log(f"[build] {line}")
    g = RAGGED_GEOM
    log(f"[build] dynamic shared memory per block: ragged_paged_attention "
        f"{ragged_smem(g['chunk'] * g['hq'] // g['hkv'], g['ps'], g['d'])} B"
        f" (chunk {g['chunk']}, page {g['ps']}, d {g['d']}), "
        "flash_attention_fwd bf16 " + " / ".join(
            f"{flash_smem(d)} B (d {d})" for d in (32, 64, 80, 96, 128))
        + f", fp32 {flash_smem(64, torch.float32)} / "
        f"{flash_smem(128, torch.float32)} B (d 64 / 128), "
        "flash_attention_bwd bf16 " + " / ".join(
            f"{bwd_smem_bytes(d)} B (d {d})" for d in (32, 64, 80, 96, 128))
        + f", fp32 {bwd_smem_bytes(64, torch.float32)} / "
        f"{bwd_smem_bytes(128, torch.float32)} B (d 64 / 128), mega attention "
        f"{mega_smem(MEGA_SERVING[0][1], 64, 64)} B (chunk "
        f"{MEGA_SERVING[0][1]}, d 64, page 64) / {mega_smem(64, 128, 64)} B "
        f"(chunk 64, d 128), paged decode {decode_smem_bytes(1, 64, 64)} B "
        f"(group 1, page 64, d 64) / {decode_smem_bytes(8, 16, 128)} B "
        "(group 8, page 16, d 128)")

    # 3, 4. kernels vs plain versions
    ragged = phase_ragged(dev)
    flash = phase_flash(dev)

    # 5, 6. the main path on GPT-125M (random weights from a numpy seed)
    cfg = GPT_CONFIGS["gpt3-125m"]
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    flash_launches = phase_forward(model, cfg, dev)
    ragged_launches, fp_outs, fp16_step_ms = phase_serve(model, cfg, dev,
                                                         card)

    # 8. quantized serving, while GPT-125M is on the card
    qmm = phase_qmm(dev)
    ragged8 = phase_ragged_int8(dev)
    quant_launches, quant_streams = phase_quant_serve(
        model, cfg, dev, card, fp_outs, fp16_step_ms)

    # 10. mega-kernel serving, while GPT-125M is on the card
    mega = phase_mega_kernels(dev, card)
    mega_launches = phase_mega_serve(model, cfg, dev, card, fp_outs,
                                     quant_streams)

    # 11. MoE serving (GPT-125M, 4 experts, top-2), its kernels and its
    # gradients; the attention routing of what the flash kernels do not take
    gmm = phase_gmm(dev, card)
    moe_cfg = replace(cfg, **MOE)
    gmm_launches = phase_moe_serve(moe_cfg, dev, card, fp16_step_ms)
    gmm_bwd_launches = phase_moe_grads(replace(moe_cfg,
                                               moe_capacity_factor=1.25), dev)
    phase_attention_routing(dev)

    # 12. the legacy two-program path: the paged decode kernel, the ragged
    # kernel's new head dims, GPT-125M served legacy, a d 96 model
    decode = phase_decode_kernel(dev)
    phase_ragged_dims(dev)
    decode_launches = phase_legacy_serve(model, cfg, dev, card, fp_outs,
                                         quant_streams, fp16_step_ms)
    decode_launches += phase_legacy_d96(dev)

    # 7. training: the backward kernel, then the training path; 9. the
    # fused-MLP kernels and their paths, each beside its phase-7 twin
    bwd = phase_flash_bwd(dev)
    model.train()
    phase_eager_grads(model, cfg, dev)
    fused = phase_fused_kernels(dev)
    phase_fused_eager(model, cfg, dev)
    del model
    phase_train_fp32(dev)
    phase_train_bf16_parity(dev)
    phase_fused_train_fp32(dev)
    train = phase_train_bf16(dev, card, bwd[torch.bfloat16])
    fused_train = phase_train_bf16(dev, card, bwd[torch.bfloat16],
                                   fused=True, unfused=train)
    train_fwd = train["fwd_n"] + fused_train["fwd_n"]
    train_bwd = train["bwd_n"] + fused_train["bwd_n"]

    kernels = []
    bf16 = torch.bfloat16
    qmm_rows = []
    for bits, gs, line in ((8, -1, 154), (4, 128, 170)):
        st = qmm[(f"int{bits}", gs, bf16)]
        qmm_rows.append((f"quant_matmul_int{bits}", line,
                         quant_launches[f"int{bits}"], st))
    for bits, gs, line in ((8, -1, 194), (4, 128, 210)):
        st = qmm[(f"int{bits}", gs, bf16)]
        qmm_rows.append((f"quant_matmul_int{bits}_bwd", line,
                         quant_launches[f"int{bits}_bwd"],
                         dict(st, ms=st["bwd_ms"],
                              plain_ms=st["bwd_plain_ms"],
                              max_abs_err=st["bwd_max_abs_err"],
                              library_ms=None)))
    for name, src, replaces, launches, s in (
            ("ragged_paged_attention",
             "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:264",
             ragged_launches + quant_launches["ragged"],
             ragged[torch.float32]),
            ("paged_decode_attention",
             "paddle_tpu_torch/csrc/paged_decode_attention.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:90",
             decode_launches, decode[torch.float32]),
            ("flash_attention_fwd",
             "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:262",
             flash_launches + train_fwd, bwd[bf16]["fwd"]),
            ("flash_attention_bwd",
             "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:419",
             train_bwd, bwd[torch.bfloat16]),
            *((name, "paddle_tpu_torch/csrc/quant_matmul.cu",
               f"paddle_tpu/ops/pallas/quant_matmul.py:{line}", n, st)
              for name, line, n, st in qmm_rows),
            *((f"fused_mlp_{fkind}", "paddle_tpu_torch/csrc/fused_mlp.cu",
               f"paddle_tpu/ops/pallas/fused_mlp.py:{line}",
               fused_train["fused_n"][i], fused[(fkind, "plain", bf16)])
              for i, ((fkind, _), line) in enumerate(
                  zip(FUSED_KINDS, (105, 128, 281, 293)))),
            *((f"mega_{part}", "paddle_tpu_torch/csrc/mega_decode.cu",
               f"paddle_tpu/ops/pallas/mega_decode.py:{line}",
               mega_launches[i], mega[(None, False, torch.float32)][part])
              for i, (part, line) in enumerate((("attn", 224),
                                                ("mlp", 677)))),
            *((f"grouped_matmul_{name}",
               "paddle_tpu_torch/csrc/grouped_matmul.cu",
               f"paddle_tpu/ops/pallas/grouped_matmul.py:{line}", n,
               gmm[(kname, label, bf16, "a")])
              for name, kname, label, line, n in (
                  ("fp", "gmm", "fp", 192, gmm_launches["fp"]),
                  ("int8", "gmm_q", "int8", 210, gmm_launches["int8"]),
                  ("int4", "gmm_q4", "int4 g128", 226, gmm_launches["int4"]),
                  ("fp_bwd", "gmm_bwd", "fp", 251, gmm_bwd_launches[0]),
                  ("int8_bwd", "gmm_q_bwd", "int8", 268,
                   gmm_bwd_launches[1])))):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"]})
    row_of = {k["name"]: k for k in kernels}
    serving, long_fwd, long_bwd = flash[bf16], flash["long"], bwd["long"]
    row_of["flash_attention_fwd"]["serving_shape"] = dict(
        shape=list(FLASH_SHAPE), dtype="bf16",
        **{k: serving[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")})
    for name, st in (("flash_attention_fwd", long_fwd),
                     ("flash_attention_bwd", long_bwd)):
        row_of[name]["long"] = dict(
            shape=list(FLASH_LONG), dtype="bf16",
            **{k: st[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")})
    f32 = flash[torch.float32]
    row_of["flash_attention_fwd"]["note"] = (
        f"bf16 at the training shape {list(BWD_SHAPE)} causal (tensor "
        "cores); serving_shape: bf16 at the full-forward shape; long: bf16 "
        f"at {list(FLASH_LONG)}; fp32 (CUDA cores) at {list(FLASH_SHAPE)}: "
        f"ms {f32['ms']:.4f}, plain_ms {f32['plain_ms']:.4f}, bound_ms "
        f"{f32['bound_ms']:.6f}, library_ms {f32['library_ms']:.4f}; at the "
        f"training shape ms {bwd[torch.float32]['fwd_ms']:.4f}; launches: "
        "phase 5's full forward and both flagship runs")
    b32 = bwd[torch.float32]
    row_of["flash_attention_bwd"]["note"] = (
        f"bf16 at the training shape {list(BWD_SHAPE)} causal (tensor "
        f"cores); long: bf16 at {list(FLASH_LONG)}; fp32 (CUDA cores) at the"
        f" training shape: ms {b32['ms']:.4f}, plain_ms "
        f"{b32['plain_ms']:.4f}, bound_ms {b32['bound_ms']:.6f}, library_ms"
        f" {b32['library_ms']:.4f}; launches: both flagship runs")
    for fkind, variants in FUSED_KINDS:
        row = row_of[f"fused_mlp_{fkind}"]
        other = fused[(fkind, variants[1], bf16)]
        shape = (FUSED_LN_SHAPES if fkind.startswith("ln")
                 else FUSED_GELU_SHAPES)[0]
        row["note"] = (
            f"bf16 at {list(shape)}"
            f" without {variants[1]}; with {variants[1]}: ms "
            f"{other['ms']:.4f}, plain_ms {other['plain_ms']:.4f}, bound_ms "
            f"{other['bound_ms']:.6f}, max_abs_err {other['max_abs_err']:.3e}"
            ", library_ms null (no single PyTorch call); launches: the "
            f"{TRAIN_STEPS} fused bf16 flagship steps")
    fp32, b16 = (mega[(None, False, t)] for t in (torch.float32, bf16))
    q8 = mega[("int8", True, bf16)]
    for part in ("attn", "mlp"):
        row_of[f"mega_{part}"]["note"] = (
            f"fp32, fp weights and KV, at the serving shapes; bf16: ms "
            f"{b16[part]['ms']:.4f}, plain_ms {b16[part]['plain_ms']:.4f}, "
            f"bound_ms {b16[part]['bound_ms']:.6f}; bf16 int8 g128 weights "
            f"+ int8 KV: ms {q8[part]['ms']:.4f}, bound_ms "
            f"{q8[part]['bound_ms']:.6f}; one mega layer vs the per-op layer"
            f" it replaces: fp32 {fp32['layer_ms']:.4f} vs "
            f"{fp32['per_op_layer_ms']:.4f} ms, bf16 {b16['layer_ms']:.4f} vs"
            f" {b16['per_op_layer_ms']:.4f} ms; launches: phase 10's three "
            "fp32 served runs")
    for name, kname, label in (
            ("fp", "gmm", "fp"), ("int8", "gmm_q", "int8"),
            ("int4", "gmm_q4", "int4 g128"), ("fp_bwd", "gmm_bwd", "fp"),
            ("int8_bwd", "gmm_q_bwd", "int8")):
        row = row_of[f"grouped_matmul_{name}"]
        f32, pre = (gmm[(kname, label, t, r)] for t, r in
                    ((torch.float32, "a"), (bf16, "b")))
        extra = ""
        if kname == "gmm_q":
            g = gmm[(kname, "int8 g128", bf16, "a")]
            extra = (f"; int8 g128: ms {g['ms']:.4f}, bound_ms "
                     f"{g['bound_ms']:.6f}")
        row["note"] = (
            f"bf16, w1 + w2 at the serving rows {GMM_ROWS}; fp32: ms "
            f"{f32['ms']:.4f}, plain_ms {f32['plain_ms']:.4f}, bound_ms "
            f"{f32['bound_ms']:.6f}; bf16 prefill rows {GMM_PREFILL}: ms "
            f"{pre['ms']:.4f}, plain_ms {pre['plain_ms']:.4f}, bound_ms "
            f"{pre['bound_ms']:.6f} ({pre['bound_by']}), library_ms "
            + (f"{pre['library_ms']:.4f}" if pre["library_ms"] is not None
               else "null") + extra + "; library: torch._grouped_mm"
            + ("" if row["library_ms"] is not None else
               f" null ({gmm[(kname, label, bf16, 'a')]['library_note']})")
            + ("; launches: phase 11's fp32 served runs"
               if "bwd" not in kname
               else "; launches: phase 11's gradient drives"))
    row_of["ragged_paged_attention"]["note"] = (
        "int8-KV branch checked too: max_abs_err "
        f"{ragged8[torch.float32]['max_abs_err']:.3e} fp32, "
        f"{ragged8[torch.float32]['ms']:.4f} ms vs bound "
        f"{ragged8[torch.float32]['bound_ms']:.6f} ms; launches include the "
        "quantized serving runs; head dims 32 / 80 / 96 checked in phase 12")
    d16 = decode[bf16]
    row_of["paged_decode_attention"]["note"] = (
        f"fp32 at phase 3's serving pools (lengths {DECODE_SERVING[1]}); "
        f"bf16: ms {d16['ms']:.4f}, plain_ms {d16['plain_ms']:.4f}, "
        f"bound_ms {d16['bound_ms']:.6f}; the ragged kernel at chunk 1 on "
        f"the same pools: fp32 {decode[torch.float32]['ragged_ms']:.4f} ms, "
        f"bf16 {d16['ragged_ms']:.4f} ms; launches: phase 12's fp32 legacy "
        "served runs (GPT-125M fp and int8, the d 96 model)")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        "(summary: ragged times in fp32 at the serving shapes of phase 3, "
        "launches on the main paths of phases 5-8; flash_attention_fwd and "
        f"_bwd in bf16 at the training shape {list(BWD_SHAPE)}, launches in "
        "phase 5 and the bf16 training runs; "
        "quant_matmul_* in bf16, the sum of one layer's four GEMMs at M "
        f"{QMM_ROWS}, launches in phase 8's fp32 serving runs (forward) and "
        "gradient drives (backward); fused_mlp_* in bf16 at the flagship "
        "shapes, launches in phase 9's bf16 flagship run; flash launches "
        "count both flagship runs; grouped_matmul_* in bf16, the sum of "
        "one MoE layer's two GEMMs at the serving rows, launches in phase "
        "11's fp32 served runs and gradient drives; paged_decode_attention "
        "in fp32 at phase 3's pools, launches in phase 12's fp32 legacy "
        "runs)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
