"""Mega-kernel serving layers.

Port of ``paddle_tpu/ops/pallas/mega_decode.py``.

A decoder layer of the unified serving step in two kernels, over the
``[b, chunk, h]`` lane blocks (lane ``b`` feeds ``q_lens[b]`` new rows):

- :func:`mega_attn_layer`: LN1 -> QKV projection (fp or int8 weights) ->
  the new K / V rows (quantized inline when the pools are int8) ->
  attention over the ``ctx_lens`` tokens already in the paged pool and,
  causally, over the lane's own new rows -> output projection -> residual
  + ``bo`` -> LN2. Returns ``(y2, s, k_new, v_new[, k_sc, v_sc])``; the
  caller scatters the new rows into the pools.
- :func:`mega_mlp`: ``s_res + b2 + gelu_tanh(y2 @ w1 + b1) @ w2`` with the
  hidden state rounded to the activation type; given ``q_lens`` (and the
  ``chunk`` of the lane blocks) only the rows each lane feeds, the others
  zero (the attention kernel's convention; nothing reads them).

``fuse_epilogue=False`` (the reference's tensor-parallel spelling) returns
the output projection's partial instead of the residual + LN epilogue.
``head_major`` takes wqkv's columns in the ``[nh, 3, hd]`` order.

On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/mega_decode.cu`` (or raise), counting launches in ``.launches``
(activations of a dtype the kernels are not built for, fp64 say, run the
plain versions there and count ``.twin_routes``: :func:`kernel_takes`); the
attention kernel splits each lane's page walk over blocks as
:func:`mega_plan` says, the MLP kernel its GEMM2 as :func:`mlp_plan` says;
on a CPU tensor, or with ``use_kernel=False``, they
run the plain versions
:func:`mega_attn_layer_reference` / :func:`mega_mlp_reference`, twins of
the reference's jnp oracles with the same stage order and roundings. The
new K / V rows quantize with ``inference.kv_cache.quantize_kv_rows`` (scale
= absmax * fp32(1/127), what the reference's jitted step computes), so the
emitted payloads are those of the per-op write.

Not ported: ``preferred_mega_blocks`` / ``autotune_mega_decode`` (the
kernels' tiles are fixed).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..inference.kv_cache import _INV_127, quantize_kv_rows
from . import _build
from ._build import kernel_takes  # noqa: F401 (the family's predicate)
from .paged_attention import _sms, walk_plan
from .quant_matmul import dequantize_weight

NEG_INF = -1e30
MAX_CHUNK = 64        # the attention kernel's rows a lane (csrc C <= 64)
HEAD_DIMS = (32, 64, 80, 96, 128)   # the attention kernel's instantiations

_K0 = 0.7978845608028654  # sqrt(2/pi)
_A = 0.044715

_KERNEL = "mega_decode"
# fp16's instances: the same source built apart (csrc/mega_decode_f16.cu),
# so the two builds run side by side
_KERNEL_F16 = "mega_decode_f16"
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "ptt_mega_attn": [_P] * 29 + [_I] * 14 + [_F] * 3 + [_I, _I, _P],
    "ptt_mega_mlp": [_P] * 13 + [_I] * 11 + [_P],
    "ptt_mega_attn_smem_bytes": [_I] * 8,
}
# the MLP kernel (csrc/mega_decode.cu, csrc/skinny_gemm.cuh): 32 weight
# columns a block (ffn columns for GEMM1, h columns for GEMM2), up to 64
# live rows a pass, K in stages of 64 rows through a ring of MLP_RING bytes
# of shared memory (two blocks an SM, beside a few row tables)
MLP_COLS, MLP_STAGE, MLP_RING = 32, 64, 96 << 10
_SLAB = 128                 # the attention kernel's projection columns a tile


def _lib(dtype):
    """The library of the kernels' ``dtype`` instances (builds it on first
    use)."""
    return _build.load(_KERNEL_F16 if dtype == torch.float16 else _KERNEL,
                       _SIGNATURES)


def smem_bytes(chunk: int, head_dim: int, dtype=torch.float32,
               int8_weights=False, int8_kv=False, pages=1, group=1) -> int:
    """Dynamic shared memory of one attention block walking ``pages``
    pages a split, its QKV producers taking ``group`` lanes (builds the
    kernel on first use)."""
    return _lib(dtype).ptt_mega_attn_smem_bytes(
        chunk, head_dim, _build.dtype_code(dtype, "mega_attn_layer"),
        int(int8_weights), int(int8_kv), int(int8_weights), pages, group)




# the attention kernel's plan: QKV producer block rows (whole lanes, 64 at
# most; a producer packs the rows that hold a new token, so one-row lanes
# of a small chunk share each weight tile; 16 beat 32 and 64 at the
# serving chunk of 16, chip_smoke.py --paged-walks), and consumer blocks
# (a causal split and the page splits of each lane and head) aimed for in
# waves of the card's SMs
MEGA_ROWS = 16
MEGA_WAVES = 4


class MegaPlan(NamedTuple):
    splits: int          # page splits a (lane, head) (plus its causal split)
    pages: int           # pages a split walks (the last may walk fewer)
    group: int           # lanes a QKV producer takes
    blocks: int          # the grid: 3 producers a (group, head), consumers


def mega_plan(b: int, heads: int, pps: int, page_size: int, d: int,
              chunk: int, kv_elt: int, sms: int) -> MegaPlan:
    """The attention kernel's grid from shapes alone: producers of
    :data:`MEGA_ROWS` rows (whole lanes, one at least) and page splits from
    :func:`walk_plan` aimed at :data:`MEGA_WAVES` waves of consumer
    blocks."""
    group = max(1, min(b, MEGA_ROWS // chunk))
    units = max(b * heads, 1)
    want = max(1, -(-MEGA_WAVES * sms // units) - 1)
    walk = walk_plan(b, heads, pps, page_size, d, chunk, kv_elt, sms,
                     want=want)
    producers = 3 * -(-b // group) * heads
    return MegaPlan(walk.splits, walk.pages, group,
                    producers + units * (1 + walk.splits))


class MlpPlan(NamedTuple):
    splits: int          # ffn splits of GEMM2 (consumers an h tile)
    producers: int       # GEMM1 blocks: f / 32 ffn tiles
    consumers: int       # GEMM2 blocks: h / 32 tiles x splits
    blocks: int          # the grid


def mlp_plan(h: int, f: int) -> MlpPlan:
    """The MLP kernel's grid from its weights' shapes alone (never the
    rows' values): producers of 32 ffn columns each (the last may have
    fewer), consumers of 32 h columns, and GEMM2's ffn range split in whole
    64-row stages (the last split ends at f) so that a consumer reads about
    as many weight bytes as a producer (``splits`` = the largest divisor of
    ceil(f / 64) not above f / h)."""
    producers, cols = -(-f // MLP_COLS), -(-h // MLP_COLS)
    stages = -(-f // MLP_STAGE)
    want = max(1, round(f / h))
    splits = max(d for d in range(1, stages + 1)
                 if stages % d == 0 and d <= want)
    return MlpPlan(splits, producers, cols * splits,
                   producers + cols * splits)


def live_rows(t: int, q_lens, chunk: int):
    """``[t]`` bool: row ``r`` is fed by its lane (``r % chunk <
    q_lens[r // chunk]``); every row when ``q_lens`` is None."""
    if q_lens is None:
        return torch.ones(t, dtype=torch.bool)
    r = torch.arange(t, device=q_lens.device)
    return (r % chunk) < q_lens.long().clamp(0, chunk)[r // chunk]


# ---------------------------------------------------------------------------
# config validation (the build-time gate)
# ---------------------------------------------------------------------------


def validate_mega_config(weight_dtype, group_size, head_dim, mp=1,
                         moe_experts=0) -> None:
    """Reject what the mega path cannot serve, with the reference's
    messages: MoE, int4 weights, and weight scale groups not aligned with
    ``head_dim``. ``mp`` is accepted and ignored, as in the reference."""
    del mp
    if moe_experts:
        raise ValueError(
            "mega_decode is dense-only: the fused MLP kernel has no "
            "routed-expert path (moe_experts="
            f"{moe_experts}) — serve MoE configs through the per-op "
            "unified step (mega_decode=False)")
    if weight_dtype == "int4":
        raise ValueError(
            "mega_decode does not serve int4 weights: split-half nibble "
            "packing interleaves the K rows the per-head wqkv/wo tiles "
            "slice — use weight_dtype='int8' (or the per-op int4 path)")
    if weight_dtype == "int8" and group_size and group_size > 0:
        if head_dim % group_size and group_size % head_dim:
            raise ValueError(
                f"mega_decode needs the weight scale group size "
                f"({group_size}) aligned with head_dim ({head_dim}): the "
                "per-head wo tile must see whole scale groups "
                "(head_dim % group == 0 or group % head_dim == 0)")


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def _ln_f32(x32, g, b, eps):
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * g + b


def _gelu_f32(u):
    return 0.5 * u * (1.0 + torch.tanh(_K0 * (u + _A * u * u * u)))


def _mm(y, leaf):
    """``y @ W`` in y's dtype; a quantized leaf dequantizes in fp32 and
    rounds to y's dtype first (the reference oracles' ``mm``)."""
    if isinstance(leaf, dict):
        w = dequantize_weight(leaf["q"], leaf["s"],
                              out_dtype=torch.float32).to(y.dtype)
    else:
        w = leaf
    return y @ w


def mega_attn_layer_reference(xb, p, k_pages, v_pages, page_table,
                              ctx_lens, q_lens, *, eps=1e-5, k_scales=None,
                              v_scales=None, head_major=False,
                              fuse_epilogue=True):
    """Twin of the reference's composed oracle: the per-op stages chained
    in the mega kernel's order, a gathered softmax over the context and
    the in-chunk causal block. Rows past ``q_lens`` hold whatever the
    padding computes (callers read valid rows only)."""
    b, chunk, h = xb.shape
    num_pages, page_size, hkv, hd = k_pages.shape
    nh = hkv   # the pool's head axis is authoritative
    kv_quant = k_scales is not None
    dtype = xb.dtype
    dev = xb.device
    y1 = _ln_f32(xb.float(), p["ln1_g"].float(), p["ln1_b"].float(),
                 eps).to(dtype)
    qkv = _mm(y1, p["wqkv"]) + p["bqkv"]                  # [b, c, 3h]
    if head_major:
        q4 = qkv.reshape(b, chunk, nh, 3, hd)
        q, k_new, v_new = q4[..., 0, :], q4[..., 1, :], q4[..., 2, :]
    else:
        q4 = qkv.reshape(b, chunk, 3, nh, hd)
        q, k_new, v_new = q4[:, :, 0], q4[:, :, 1], q4[:, :, 2]
    q = q.float()
    kf, vf = k_new.float(), v_new.float()
    if kv_quant:
        k_emit, k_scr = quantize_kv_rows(kf)
        v_emit, v_scr = quantize_kv_rows(vf)
        # attend the quantize-dequantize image — what later steps read
        kf = k_emit.float() * k_scr[..., None]
        vf = v_emit.float() * v_scr[..., None]
    else:
        k_emit, v_emit = k_new.to(dtype), v_new.to(dtype)
    pt = page_table.long().clamp(0, num_pages - 1)
    pps = page_table.shape[1]
    kc = k_pages[pt].reshape(b, pps * page_size, hkv, hd).float()
    vc = v_pages[pt].reshape(b, pps * page_size, hkv, hd).float()
    if kv_quant:
        kc = kc * k_scales[pt].reshape(b, pps * page_size, hkv, 1).float()
        vc = vc * v_scales[pt].reshape(b, pps * page_size, hkv, 1).float()
    scale = 1.0 / math.sqrt(hd)
    s_ctx = torch.einsum("bcnd,bsnd->bncs", q, kc) * scale
    s_new = torch.einsum("bcnd,bknd->bnck", q, kf) * scale
    ql = q_lens.long().reshape(-1, 1, 1, 1)
    col = torch.arange(pps * page_size, device=dev).reshape(1, 1, 1, -1)
    rowi = torch.arange(chunk, device=dev).reshape(1, 1, -1, 1)
    valid_ctx = (col < ctx_lens.long().reshape(-1, 1, 1, 1)) & (rowi < ql)
    colk = torch.arange(chunk, device=dev).reshape(1, 1, 1, -1)
    valid_new = (colk <= rowi) & (colk < ql) & (rowi < ql)
    s_all = torch.cat([torch.where(valid_ctx, s_ctx, NEG_INF),
                       torch.where(valid_new, s_new, NEG_INF)], dim=-1)
    pr = torch.softmax(s_all, dim=-1)
    valid_any = torch.cat([valid_ctx.expand_as(s_ctx),
                           valid_new.expand_as(s_new)], dim=-1)
    pr = torch.where(valid_any, pr, 0.0)
    v_all = torch.cat([vc, vf], dim=1)
    o = torch.einsum("bncs,bsnd->bcnd", pr, v_all)
    a = o.reshape(b, chunk, nh * hd).to(dtype)
    if not fuse_epilogue:
        y_part = _mm(a, p["wo"]).to(dtype)
        if kv_quant:
            return y_part, k_emit, v_emit, k_scr, v_scr
        return y_part, k_emit, v_emit
    s_out = (xb.float() + _mm(a, p["wo"]).float()
             + p["bo"].float()).to(dtype)
    y2 = _ln_f32(s_out.float(), p["ln2_g"].float(), p["ln2_b"].float(),
                 eps).to(dtype)
    if kv_quant:
        return y2, s_out, k_emit, v_emit, k_scr, v_scr
    return y2, s_out, k_emit, v_emit


def mega_mlp_reference(y2, s_res, p, *, fuse_epilogue=True, q_lens=None,
                       chunk=1):
    """Twin of the reference's ``mega_mlp_reference``: ``fuse_epilogue=
    False`` returns the second product alone (no residual, no ``b2``).
    Given ``q_lens``, the rows no lane feeds (:func:`live_rows`) are zero,
    as the kernel writes them."""
    dtype = y2.dtype
    u = _mm(y2, p["w1"]).float() + p["b1"].float()
    g = _gelu_f32(u).to(dtype)
    if not fuse_epilogue:
        out = _mm(g, p["w2"]).to(dtype)
    else:
        out = (s_res.float() + _mm(g, p["w2"]).float()
               + p["b2"].float()).to(dtype)
    if q_lens is None:
        return out
    return torch.where(live_rows(out.shape[0], q_lens, chunk)[:, None], out,
                       torch.zeros((), dtype=dtype, device=out.device))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _use_kernel(use_kernel, t, what) -> bool:
    """Whether to launch the kernel: ``None`` follows the tensor's device
    (CUDA: kernel, CPU: plain version); ``False`` runs the plain version;
    ``True`` needs a CUDA tensor."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {t.device}")
    if use_kernel is None:
        return t.device.type == "cuda"
    if use_kernel and t.device.type != "cuda":
        raise ValueError(f"{what}: the kernel runs on a CUDA tensor, got "
                         f"{t.device} (use_kernel=None runs the plain "
                         "version there)")
    return bool(use_kernel)


def _weight(leaf, k, n, dtype, what):
    """(weight, 2-D fp32 scales or None, K rows per scale group) of a
    serving weight leaf ``[k, n]``, checked for the kernel."""
    if isinstance(leaf, dict):
        w, s = leaf["q"], leaf["s"]
        s = s.reshape(1, -1) if s.dim() == 1 else s
        if w.dtype != torch.int8 or s.dtype != torch.float32:
            raise TypeError(f"{what}: quantized weights are int8 with fp32 "
                            f"scales, got {w.dtype} / {s.dtype}")
        if s.dim() != 2 or s.shape[1] != n or k % s.shape[0]:
            raise ValueError(f"{what}: scales {tuple(s.shape)} do not fit a "
                             f"[{k}, {n}] weight")
        gs = k // s.shape[0]
    else:
        w, s, gs = leaf, None, 1
        if w.dtype != dtype:
            raise TypeError(f"{what}: weight is {w.dtype}, activations "
                            f"{dtype}")
    if tuple(w.shape) != (k, n):
        raise ValueError(f"{what}: weight {tuple(w.shape)}, expected "
                         f"[{k}, {n}]")
    return w, s, gs


def _check_tensors(what, dev, tensors):
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _vector(p, name, n, dtype, what):
    t = p[name]
    if t.dtype != dtype or tuple(t.shape) != (n,):
        raise TypeError(f"{what}: {name} must be [{n}] {dtype}, got "
                        f"{tuple(t.shape)} {t.dtype}")
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_attn(xb, p, k_pages, v_pages, page_table, ctx_lens, q_lens, eps,
                 k_scales, v_scales, head_major, fuse_epilogue):
    what = "mega_attn_layer"
    b, chunk, h = xb.shape
    num_pages, ps, nh, hd = k_pages.shape
    dtype, dev = xb.dtype, xb.device
    code = _build.dtype_code(dtype, what)
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"{what} kernel takes head_dim in "
                                  f"{HEAD_DIMS}, got {hd}")
    if h % 64:
        raise NotImplementedError(f"{what} kernel takes h a multiple of 64, "
                                  f"got {h}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise NotImplementedError(f"{what} kernel takes chunk 1..{MAX_CHUNK}"
                                  f", got {chunk}")
    kv_quant = k_scales is not None
    pool_dtype = torch.int8 if kv_quant else dtype
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != pool_dtype or t.shape != k_pages.shape:
            raise TypeError(f"{what}: {name} is {t.dtype} "
                            f"{tuple(t.shape)}, expected {pool_dtype} "
                            f"{tuple(k_pages.shape)}")
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if kv_quant and (t.dtype != torch.float32
                         or tuple(t.shape) != (num_pages, ps, nh)):
            raise TypeError(f"{what}: {name} must be fp32 [{num_pages}, {ps}"
                            f", {nh}], got {t.dtype} {tuple(t.shape)}")
    for name, t in (("page_table", page_table), ("ctx_lens", ctx_lens),
                    ("q_lens", q_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
    if page_table.shape[0] != b or tuple(ctx_lens.shape) != (b,) \
            or tuple(q_lens.shape) != (b,):
        raise ValueError(f"{what}: page_table / ctx_lens / q_lens must lead "
                         f"with the batch {b}")
    wq, sq, gq = _weight(p["wqkv"], h, 3 * nh * hd, dtype, what + " wqkv")
    wo, so, go = _weight(p["wo"], nh * hd, h, dtype, what + " wo")
    vecs = {n: _vector(p, n, h, dtype, what)
            for n in ("ln1_g", "ln1_b", "ln2_g", "ln2_b", "bo")}
    bqkv = _vector(p, "bqkv", 3 * nh * hd, dtype, what)
    _check_tensors(what, dev, dict(
        xb=xb, wqkv=wq, sqkv=sq, bqkv=bqkv, wo=wo, so=so, k_pages=k_pages,
        v_pages=v_pages, k_scales=k_scales, v_scales=v_scales,
        page_table=page_table, ctx_lens=ctx_lens, q_lens=q_lens, **vecs))
    for name, g in (("wqkv", gq if sq is not None else 16),
                    ("wo", go if so is not None else 16)):
        if g % 16:
            raise NotImplementedError(f"{what} kernel takes int8 {name} scale "
                                      f"groups of a multiple of 16 rows, got "
                                      f"{g}")
    if any(t is not None and t.data_ptr() % 16 for t in (
            xb, wq, sq, wo, so, k_pages, v_pages, vecs["ln1_g"],
            vecs["ln1_b"])):
        raise ValueError(f"{what}: x, the weights, their scales, LN1's "
                         "vectors and the pools must be 16-byte aligned (the "
                         "kernel copies 16-byte chunks)")
    y2 = torch.empty_like(xb)
    s = torch.empty_like(xb) if fuse_epilogue else None
    k_new = torch.empty((b, chunk, nh, hd), dtype=pool_dtype, device=dev)
    v_new = torch.empty_like(k_new)
    k_sc = v_sc = None
    if kv_quant:
        k_sc = torch.empty((b, chunk, nh), dtype=torch.float32, device=dev)
        v_sc = torch.empty_like(k_sc)
    if b:
        plan = mega_plan(b, nh, page_table.shape[1], ps, hd, chunk,
                         k_pages.element_size(), _sms(dev.index))
        nslab = -(-h // _SLAB)
        part_n = b * nh * (1 + plan.splits) * (4 * -(-chunk * (hd + 2) // 4))
        ws_n = b * nh * chunk * h
        pub_n = b * chunk * 3 * nh * hd
        scratch = _build.kept(dev, "mega_attn",
                              part_n + ws_n + pub_n + b * nslab * chunk * 2,
                              torch.float32)
        counters = _build.kept(dev, "attn", b * (3 * nh + nslab + 1) + 1)
        lib = _lib(dtype)
        err = lib.ptt_mega_attn(
            xb.data_ptr(), vecs["ln1_g"].data_ptr(), vecs["ln1_b"].data_ptr(),
            vecs["ln2_g"].data_ptr(), vecs["ln2_b"].data_ptr(),
            wq.data_ptr(), _ptr(sq), bqkv.data_ptr(), wo.data_ptr(),
            _ptr(so), vecs["bo"].data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), _ptr(k_scales), _ptr(v_scales),
            page_table.data_ptr(), ctx_lens.data_ptr(), q_lens.data_ptr(),
            y2.data_ptr(), _ptr(s), k_new.data_ptr(), v_new.data_ptr(),
            _ptr(k_sc), _ptr(v_sc), scratch.data_ptr(),
            scratch[part_n:].data_ptr(), scratch[part_n + ws_n:].data_ptr(),
            scratch[part_n + ws_n + pub_n:].data_ptr(),
            counters.data_ptr(), b, chunk, h,
            nh, hd, num_pages, ps, page_table.shape[1], gq, go,
            int(head_major), int(fuse_epilogue), plan.pages, plan.group,
            float(eps),
            _INV_127, 1.0 / math.sqrt(hd), code, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, err, f"{what} launch")
        mega_attn_layer.launches += 1
    out = (y2, s) if fuse_epilogue else (y2,)
    out += (k_new, v_new)
    return out + ((k_sc, v_sc) if kv_quant else ())


def mega_attn_layer(xb, p, k_pages, v_pages, page_table, ctx_lens, q_lens,
                    *, eps=1e-5, k_scales=None, v_scales=None,
                    head_major=False, use_kernel=None, fuse_epilogue=True):
    """The attention side of a decoder layer over ragged lane blocks.

    xb ``[b, chunk, h]`` (``q_lens[b]`` valid rows a lane); ``p`` one
    layer's serving weights (``wqkv`` / ``wo`` may be ``{"q", "s"}`` int8
    leaves); pools ``[num_pages, page_size, heads, head_dim]`` (int8 with
    fp32 ``k_scales`` / ``v_scales`` ``[num_pages, page_size, heads]``);
    ``page_table [b, pps]``, ``ctx_lens [b]`` (tokens ALREADY in the pool)
    and ``q_lens [b]`` int32. Returns ``(y2, s, k_new, v_new)`` — y2 / s
    ``[b, chunk, h]`` (LN2 output and residual stream), the new rows
    ``[b, chunk, heads, head_dim]`` — plus ``(k_sc, v_sc) [b, chunk,
    heads]`` with int8 pools (k_new / v_new are then the int8 payloads).
    ``fuse_epilogue=False`` returns ``(y_part, k_new, v_new[, k_sc,
    v_sc])`` with y_part the output projection alone. The kernel writes
    zeros in rows past ``q_lens``.
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    kernel = _use_kernel(use_kernel, xb, "mega_attn_layer")
    if kernel and not kernel_takes(xb.dtype):
        mega_attn_layer.twin_routes += 1
        kernel = False
    if not kernel:
        return mega_attn_layer_reference(
            xb, p, k_pages, v_pages, page_table, ctx_lens, q_lens, eps=eps,
            k_scales=k_scales, v_scales=v_scales, head_major=head_major,
            fuse_epilogue=fuse_epilogue)
    return _launch_attn(xb, p, k_pages, v_pages, page_table, ctx_lens,
                        q_lens, eps, k_scales, v_scales, head_major,
                        fuse_epilogue)


mega_attn_layer.launches = 0
mega_attn_layer.twin_routes = 0


def _launch_mlp(y2, s_res, p, fuse_epilogue, q_lens, chunk):
    what = "mega_mlp"
    t, h = y2.shape
    dtype, dev = y2.dtype, y2.device
    code = _build.dtype_code(dtype, what)
    if h % 4:
        raise NotImplementedError(f"{what} kernel takes h a multiple of 4, "
                                  f"got {h}")
    w1l = p["w1"]
    f = (w1l["q"] if isinstance(w1l, dict) else w1l).shape[1]
    w1, s1, g1 = _weight(w1l, h, f, dtype, what + " w1")
    w2, s2, g2 = _weight(p["w2"], f, h, dtype, what + " w2")
    if (s1 is None) != (s2 is None):
        raise NotImplementedError(f"{what} kernel takes w1 and w2 both int8 "
                                  "or both in the activation type")
    b1 = _vector(p, "b1", f, dtype, what)
    b2 = _vector(p, "b2", h, dtype, what)
    if fuse_epilogue:
        if s_res is None or s_res.shape != y2.shape or s_res.dtype != dtype:
            raise ValueError(f"{what}: s_res must match y2 {tuple(y2.shape)}"
                             f" {dtype}")
    else:
        s_res = None
    if q_lens is None:
        lanes, chunk = 1, t
    else:
        lanes = q_lens.shape[0]
        if q_lens.dtype != torch.int32 or q_lens.dim() != 1 \
                or lanes * chunk != t:
            raise ValueError(f"{what}: q_lens must be int32 [t / chunk] = "
                             f"[{t} / {chunk}], got {q_lens.dtype} "
                             f"{tuple(q_lens.shape)}")
    _check_tensors(what, dev, dict(y2=y2, s_res=s_res, w1=w1, s1=s1, b1=b1,
                                   w2=w2, s2=s2, b2=b2, q_lens=q_lens))
    out = torch.empty_like(y2)
    if t == 0:
        return out
    plan = mlp_plan(h, f)
    elt = y2.element_size()
    hid_n = -(-t * f * elt // 4)
    scratch = _build.kept(dev, "mega_mlp",
                          hid_n + 4 + plan.splits * t * h, torch.float32)
    part = scratch[-(-hid_n // 4) * 4:]      # 16-byte aligned after hid
    flags = _build.kept(dev, "mlp", plan.splits + plan.consumers
                        // plan.splits + 2)
    lib = _lib(dtype)
    err = lib.ptt_mega_mlp(
        y2.data_ptr(), _ptr(s_res), w1.data_ptr(), _ptr(s1), b1.data_ptr(),
        w2.data_ptr(), _ptr(s2), b2.data_ptr(), _ptr(q_lens), out.data_ptr(),
        scratch.data_ptr(), part.data_ptr(), flags.data_ptr(), t, h, f, g1,
        g2, lanes, chunk, plan.splits, int(fuse_epilogue), code, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, f"{what} launch")
    mega_mlp.launches += 1
    return out


def mega_mlp(y2, s_res, p, *, use_kernel=None, fuse_epilogue=True, chunk=1,
             q_lens=None):
    """The MLP side of a decoder layer on ``[t, h]`` rows: ``s_res + b2 +
    gelu_tanh(y2 @ w1 + b1) @ w2`` in y2's dtype (``fuse_epilogue=False``:
    the second product alone; ``s_res`` may be None). ``q_lens`` (int32
    ``[t / chunk]``): the rows are lane blocks of ``chunk`` rows and lane
    ``l`` feeds its first ``q_lens[l]``; only those are computed and the
    others are zero (the kernel reads q_lens on the device, so a captured
    step stays valid). Without it every row is computed."""
    kernel = _use_kernel(use_kernel, y2, "mega_mlp")
    if kernel and not kernel_takes(y2.dtype):
        mega_mlp.twin_routes += 1
        kernel = False
    if not kernel:
        return mega_mlp_reference(y2, s_res, p, fuse_epilogue=fuse_epilogue,
                                  q_lens=q_lens, chunk=chunk)
    return _launch_mlp(y2, s_res, p, fuse_epilogue, q_lens, chunk)


mega_mlp.launches = 0
mega_mlp.twin_routes = 0
