"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout. Phases (each failure ends the run non-zero):

1. device: the card's name and power limit;
2. build: the three hand-written kernels from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, started together), with ``ptxas -v``
   registers and spills;
3. ragged paged attention vs its plain version at the serving shapes
   (b 8, chunk 16, 12 heads, d 64, page 64, 16 pages per sequence),
   fp32 and bf16, with kernel / plain / bound times;
4. flash attention forward vs its plain version at the full-forward
   shape [4, 512, 12, 64] causal, plus ``sq != sk`` and a ragged tail;
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
   ragged tails, non-causal), fp32 and bf16, with kernel / plain / bound
   times and SDPA's backward as the library yardstick, and the forward
   kernel vs its plain version at the training shape; the eager GPT-125M
   forward and backward with flash vs plain attention (every parameter
   gets the same gradient, none is ``None``); ``build_spmd_train_step`` in
   fp32 (TF32 off) at gpt3-760m's width and 2 layers, flash vs plain
   attention for the loss, every gradient leaf and 3 steps' losses; then
   the flagship training configuration (``bench.py``'s gpt3-760m: h 1536,
   24 layers, 12 heads, vocab 50304, batch 8, seq 1024, bf16, recompute
   with the flash outputs saved, num_micro 1, momentum SGD at lr 1e-4),
   timed: step ms, tokens/s and MFU, with 24 forward and 24 backward flash
   launches per step.

Kernel times are device times: the calls are captured in a CUDA graph and
the graph is replayed between CUDA events.

Weights are random, drawn from a numpy seed. The last three lines are the
per-kernel JSON summary, the ``nvidia-smi`` card line and ``{"ok": true,
"device": ...}``. Without a
CUDA device, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

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
    """One line per compiled instantiation (element type, head_dim) with its
    registers and spills, from the ``ptxas -v`` report."""
    inst, spills = None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '.*?I(13__nv_bfloat16|f)"
                      r"Li(\d+)E", line)
        if m:
            inst = ("bf16" if m.group(1) != "f" else "fp32", m.group(2))
        elif "spill stores" in line:
            spills = line.strip()
        elif "registers" in line and inst:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            yield (f"{name}<{inst[0]}, d{inst[1]}>: {regs} registers, "
                   f"{spills}")
            inst = None


# -- phase 3 ----------------------------------------------------------------


def ragged_inputs(dtype, dev):
    g = RAGGED_GEOM
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
    lanes = [(kv, ql) for kv, ql in zip(kv_lens.tolist(), q_lens.tolist())
             if ql > 0]
    kv_rows = sum(kv for kv, _ in lanes)
    pages = sum(-(-kv // ps) for kv, _ in lanes)
    nbytes = ((sum(ql for _, ql in lanes) + b * chunk) * hq * d * elt
              + 2 * kv_rows * hkv * d * elt + 4 * (pages + 2 * b))
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


def phase_flash(dev):
    import torch.nn.functional as tnf

    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_fwd as kern, flash_attention_reference as plain)

    stats = {}
    cases = [(*FLASH_SHAPE[:2], FLASH_SHAPE[1], FLASH_SHAPE[2],
              FLASH_SHAPE[2], FLASH_SHAPE[3], True),
             (2, 200, 456, 12, 4, 64, True),      # sq != sk, GQA
             (2, 333, 333, 12, 12, 64, True)]     # tail not a tile multiple
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (b, sq, sk, hq, hkv, d, causal) in enumerate(cases):
            rng = np.random.RandomState(SEED + ci)
            q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)).to(dev, dtype) for s in
                ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
            out, lse = kern(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want, want_lse = plain(q, k, v, causal=causal)
            err, held = kernel_error(out, want, dtype)
            lse_err = (lse - want_lse).abs().max().item()
            if not (held <= KERNEL_TOL[dtype] and lse_err <= 1e-3):
                raise AssertionError(
                    f"flash kernel {dtype} case {ci}: error {held} (tol "
                    f"{KERNEL_TOL[dtype]}, max abs {err}), lse err {lse_err}")
            log(f"[flash] {str(dtype)[6:]} b{b} sq{sq} sk{sk} hq{hq} "
                f"hkv{hkv} d{d}: max_abs_err {err:.3e}, held {held:.3e} "
                f"(tol {KERNEL_TOL[dtype]}), lse err {lse_err:.3e}")
            if ci:
                continue
            nbytes, nops = flash_work(b, sq, sk, hq, hkv, d, causal,
                                      q.element_size())
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            s = dict(max_abs_err=err, ms=time_ms(lambda: kern(q, k, v,
                                                                causal=True)),
                     plain_ms=time_ms(lambda: plain(q, k, v, causal=True),
                                      iters=5),
                     library_ms=time_ms(lambda: tnf.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True)),
                     bound_ms=bound_ms(nbytes, nops, dtype),
                     bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                     >= nops / PEAK_OPS[dtype] else "operations")
            stats[dtype] = s
            log(f"[flash] {str(dtype)[6:]} {list(FLASH_SHAPE)} causal: kernel "
                f"{s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, "
                f"library (torch sdpa) {s['library_ms']:.4f} ms, bound "
                f"{s['bound_ms']:.4f} ms ({s['bound_by']}: "
                f"{nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} GFLOP)")
    return stats


# -- phases 5 and 6 ---------------------------------------------------------


def reset_counts():
    from paddle_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                      flash_attention_fwd)
    from paddle_tpu_torch.ops.paged_attention import ragged_paged_attention

    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    ragged_paged_attention.launches = 0


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
    if flash_n != cfg.num_layers or ragged_n or bwd_count():
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
    return ragged_n


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


def events_ms(fn, iters=10) -> float:
    """Device milliseconds per call from CUDA events around ``iters`` eager
    calls after 3 warm-up calls (for calls that run autograd, which a CUDA
    graph does not capture here)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa_bwd_ms(q, k, v, do) -> float:
    """SDPA's backward (the aten flash / efficient backward op PyTorch
    picks for these inputs) on the same tensors, timed, never used."""
    import torch.nn.functional as tnf

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = tnf.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    return events_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                 retain_graph=True))


def phase_flash_bwd(dev):
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd as kern, flash_attention_bwd_reference as plain)

    b, s, h, d = BWD_SHAPE
    cases = [(b, s, s, h, h, d, True),
             (2, 200, 456, 12, 4, 64, True),      # sq != sk, GQA
             (2, 333, 333, 12, 12, 64, True),     # tail not a tile multiple
             (1, 300, 100, 4, 1, 128, True),      # rows that see no key
             (2, 130, 77, 6, 3, 64, False)]       # non-causal, sq > sk
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        for ci, shape in enumerate(cases):
            causal = shape[-1]
            args = bwd_inputs(shape, dtype, dev, SEED + ci)
            got = kern(*args, causal=causal)
            torch.cuda.synchronize()
            want = plain(*args, causal=causal)
            errs = {}
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err, held = kernel_error(g, w, dtype)
                if dtype == torch.float32:
                    held = err / w.abs().max().item()
                errs[name] = (err, held)
            worst = max(h for _, h in errs.values())
            max_err = max(e for e, _ in errs.values())
            log(f"[train] flash bwd {str(dtype)[6:]} b{shape[0]} sq{shape[1]} "
                f"sk{shape[2]} hq{shape[3]} hkv{shape[4]} d{shape[5]} "
                f"{'causal' if causal else 'non-causal'}: " + ", ".join(
                    f"{n} max_abs_err {e:.3e} held {hd:.3e}"
                    for n, (e, hd) in errs.items())
                + f" (tol {BWD_TOL[dtype]})")
            if not worst <= BWD_TOL[dtype]:
                raise AssertionError(f"flash bwd kernel {dtype} case {ci}: "
                                     f"held error {worst} > {BWD_TOL[dtype]}")
            if ci:
                continue
            elt = args[0].element_size()
            nbytes, nops = bwd_work(*shape, elt)
            st = dict(max_abs_err=max_err,
                      ms=time_ms(lambda: kern(*args, causal=True), iters=10,
                                 replays=2),
                      plain_ms=time_ms(lambda: plain(*args, causal=True),
                                       iters=2, replays=2),
                      library_ms=sdpa_bwd_ms(*args[:4]),
                      bound_ms=bound_ms(nbytes, nops, dtype),
                      bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                      >= nops / PEAK_OPS[dtype] else "operations")
            stats[dtype] = st
            log(f"[train] flash bwd {str(dtype)[6:]} {list(BWD_SHAPE)} "
                f"causal: "
                f"kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, "
                f"library (torch sdpa backward) {st['library_ms']:.4f} ms, "
                f"bound {st['bound_ms']:.4f} ms ({st['bound_by']}: "
                f"{nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} GFLOP)")
    # the forward kernel at the same shape (d 128, which phase 4 does not
    # cover): held against its plain version, and timed for the step's
    # breakdown
    import torch.nn.functional as tnf

    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = bwd_inputs(cases[0], dtype, dev, SEED)[:3]
        out, lse = flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        want, want_lse = flash_attention_reference(q, k, v, causal=True)
        err, held = kernel_error(out, want, dtype)
        lse_err = (lse - want_lse).abs().max().item()
        if not (held <= KERNEL_TOL[dtype] and lse_err <= 1e-3):
            raise AssertionError(
                f"flash kernel {dtype} at {list(BWD_SHAPE)}: error {held} "
                f"(tol {KERNEL_TOL[dtype]}, max abs {err}), lse err "
                f"{lse_err}")
        nbytes, nops = flash_work(b, s, s, h, h, d, True, q.element_size())
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True),
                     iters=10, replays=2)
        plain_ms = time_ms(lambda: flash_attention_reference(
            q, k, v, causal=True), iters=2, replays=2)
        lib_ms = time_ms(lambda: tnf.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=10, replays=2)
        stats[dtype]["fwd_ms"] = ms
        log(f"[train] flash fwd {str(dtype)[6:]} {list(BWD_SHAPE)} causal: "
            f"max_abs_err {err:.3e}, held {held:.3e} (tol "
            f"{KERNEL_TOL[dtype]}), lse err {lse_err:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (torch "
            f"sdpa) {lib_ms:.4f} ms, bound "
            f"{bound_ms(nbytes, nops, dtype):.4f} ms ({nbytes / 1e6:.2f} MB, "
            f"{nops / 1e9:.3f} GFLOP)")
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


def phase_train_bf16(dev, card, bwd_stats):
    """The flagship configuration: full-width gpt3-760m, bf16, timed."""
    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.convert import random_train_params
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(**TRAIN)
    b, s, L = TRAIN_BATCH, cfg.max_seq_len, cfg.num_layers
    t0 = time.perf_counter()
    step, params, mom, (ids, labels) = gpt_spmd.build_spmd_train_step(
        cfg, batch_size=b, seq_len=s, num_micro=1, lr=1e-4, momentum=0.9,
        device=dev, params=random_train_params(cfg, SEED),
        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[train] bf16 gpt3-760m: {cfg.num_params() / 1e6:.1f} M params, "
        f"set up in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, mom, loss = step(params, mom, ids, labels)
        losses.append(loss.item())          # synchronizes
        walls.append(time.perf_counter() - t0)
    fwd_n, bwd_n = read_counts()[0], bwd_count()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not np.isfinite(losses).all():
        raise AssertionError(f"bf16 training loss not finite: {losses}")
    if fwd_n != L * TRAIN_STEPS or bwd_n != L * TRAIN_STEPS:
        raise AssertionError(f"flash launches fwd {fwd_n}, bwd {bwd_n} over "
                             f"{TRAIN_STEPS} steps (want {L} each per step)")
    timed = walls[1:]
    step_s = sum(timed) / len(timed)
    tps = b * s / step_s
    flops_per_token = 6 * cfg.num_params() + 6 * L * cfg.hidden_size * s
    mfu = tps * flops_per_token / PEAK_OPS[torch.bfloat16]
    attn_ms = L * (bwd_stats["ms"] + bwd_stats["fwd_ms"])
    log(f"[train] bf16 gpt3-760m b{b} s{s} recompute+save_attn: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; flash launches fwd "
        f"{fwd_n} bwd {bwd_n} ({L} each per step); step {1e3 * step_s:.1f} ms"
        f" (mean of {len(timed)} after 1 warm-up: "
        f"{', '.join(f'{1e3 * w:.1f}' for w in timed)}), {tps:.1f} tokens/s,"
        f" MFU {mfu:.4f} ({flops_per_token / 1e9:.3f} GFLOP/token over "
        f"989 TFLOP/s bf16); flash kernels alone {attn_ms:.1f} ms a step "
        f"({L} x (bwd {bwd_stats['ms']:.3f} + fwd {bwd_stats['fwd_ms']:.3f}) "
        f"ms, phase-7 kernel times); peak device memory {peak_gb:.2f} GB "
        f"({card})")
    profile_step(step, params, mom, ids, labels, card)
    return fwd_n, bwd_n


KERNEL_GROUPS = (("flash fwd", ("flash_fwd_kernel",)),
                 ("flash bwd", ("flash_bwd_kernel",)),
                 ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas",
                                    "nvjet")),
                 ("copies and fills", ("memcpy", "memset")))


def profile_step(step, params, mom, ids, labels, card):
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
        log("[train] profiler: no device time in the trace (device "
            "breakdown not measured)")
        return
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[train] profiled kernel {ev.self_device_time_total / 1e3:8.2f} "
            f"ms x{ev.count:<4d} {ev.key[:90]}")
    log(f"[train] profiled bf16 step: wall {wall_us / 1e3:.1f} ms (under the "
        f"profiler), device busy {busy / 1e3:.1f} ms = "
        f"{busy / wall_us:.3f} of it, idle {1 - busy / wall_us:.3f}; "
        f"{launches} kernels; " + ", ".join(
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
    from paddle_tpu_torch.models.convert import random_state, state_from_jax_numpy
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.flash_attention import bwd_smem_bytes
    from paddle_tpu_torch.ops.flash_attention import smem_bytes as flash_smem
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
                          "flash_attention_bwd"])
    log(f"[build] three kernels for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in ptxas_summary(name, text):
            log(f"[build] {line}")
    g = RAGGED_GEOM
    log(f"[build] dynamic shared memory per block: ragged_paged_attention "
        f"{ragged_smem(g['chunk'] * g['hq'] // g['hkv'], g['ps'], g['d'])} B"
        f" (chunk {g['chunk']}, page {g['ps']}, d {g['d']}), "
        f"flash_attention_fwd {flash_smem(FLASH_SHAPE[3])} B (d "
        f"{FLASH_SHAPE[3]}), flash_attention_bwd {bwd_smem_bytes(64)} B (d "
        f"64) / {bwd_smem_bytes(128)} B (d 128)")

    # 3, 4. kernels vs plain versions
    ragged = phase_ragged(dev)
    flash = phase_flash(dev)

    # 5, 6. the main path on GPT-125M (random weights from a numpy seed)
    cfg = GPT_CONFIGS["gpt3-125m"]
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    flash_launches = phase_forward(model, cfg, dev)
    ragged_launches = phase_serve(model, cfg, dev, card)

    # 7. training: the backward kernel, then the training path
    bwd = phase_flash_bwd(dev)
    model.train()
    phase_eager_grads(model, cfg, dev)
    del model
    phase_train_fp32(dev)
    train_fwd, train_bwd = phase_train_bf16(dev, card, bwd[torch.bfloat16])

    kernels = []
    for name, src, replaces, launches, s in (
            ("ragged_paged_attention",
             "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:264",
             ragged_launches, ragged[torch.float32]),
            ("flash_attention_fwd",
             "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:262",
             flash_launches + train_fwd, flash[torch.float32]),
            ("flash_attention_bwd",
             "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:419",
             train_bwd, bwd[torch.bfloat16])):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"]})
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        "(summary: ragged and flash_attention_fwd times in fp32 at the "
        "serving / full-forward shapes of phases 3-4, launches on the main "
        "paths of phases 5-7; flash_attention_bwd in bf16 at the training "
        f"shape {list(BWD_SHAPE)}, launches in the bf16 training run)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
