"""Mixture-of-Experts routing and expert FFN — port of
``paddle_tpu/models/moe.py``.

One functional core serves every consumer, so the serving step and the
eager model cannot drift apart:

- :func:`route_topk` — deterministic top-k softmax routing (iterative
  argmax and one-hot masking; ``torch.argmax`` returns the first maximum,
  so ties go to the LOWEST expert index, as ``jnp.argmax`` does);
- :func:`moe_capacity` / :func:`capacity_positions` — GShard capacity: per
  (token, choice) slot ranks in choice-major priority (every first choice
  queues before any second choice); choices past an expert's capacity
  DROP, their FFN contribution is zero and the residual carries the token;
- :func:`moe_ffn` — the grouped-GEMM spelling (sort token-choice pairs by
  expert, one ragged ``ops/grouped_matmul`` per FFN matmul, combine by
  renormalized gates) that both :class:`GPTMoE` and the serving step run;
- :func:`topk_dispatch_combine` / :func:`moe_ffn_einsum` — the dense
  dispatch / combine mask spelling the reference's SPMD training block
  uses; the same function, no kernel;
- the aux load-balance loss ``E * sum(frac_tokens * mean_prob)`` over the
  FIRST choices (GShard eq. 13 / Switch eq. 4).

The reference combines the k choices of a token with a scatter-add
(``.at[].add``); here the pairs go back to ``[N, k, d]`` and sum over k in
choice order, a fixed order on every device (``index_add_`` on CUDA sums in
no fixed order).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.grouped_matmul import grouped_matmul


def moe_capacity(n_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert slot budget: ``max(int(factor * n / E) * k, 4)``. A
    factor >= ``num_experts`` never drops a token."""
    return max(int(float(capacity_factor) * int(n_tokens)
                   / int(num_experts)) * int(top_k), 4)


def route_topk(logits, top_k: int):
    """Deterministic top-k routing over router ``logits [N, E]``.

    Returns ``(gates [N, k] fp32, idx [N, k] int32, probs [N, E] fp32,
    masks)``: gates renormalized over the k selections, ``masks`` the
    per-choice one-hot ``[N, E]`` fp32 list."""
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    p = probs
    idxs, raw, masks = [], [], []
    for _ in range(int(top_k)):
        i = torch.argmax(p, dim=-1)
        m = torch.nn.functional.one_hot(i, e).to(torch.float32)
        idxs.append(i.to(torch.int32))
        raw.append((p * m).sum(-1))
        masks.append(m)
        p = p * (1.0 - m)
    gates = torch.stack(raw, dim=1)
    gates = gates / gates.sum(1, keepdim=True).clamp_min(1e-9)
    return gates, torch.stack(idxs, dim=1), probs, masks


def load_balance_aux(probs, mask1, valid=None):
    """GShard aux loss over FIRST choices; ``valid [N]`` excludes padding
    rows."""
    e = probs.shape[-1]
    if valid is None:
        frac = mask1.mean(0)
        pmean = probs.mean(0)
    else:
        vw = valid.to(torch.float32)[:, None]
        denom = vw.sum().clamp_min(1.0)
        frac = (mask1 * vw).sum(0) / denom
        pmean = (probs * vw).sum(0) / denom
    return (frac * pmean).sum() * e


def capacity_positions(masks, capacity: int, valid=None):
    """Per (token, choice) slot in the chosen expert's buffer, choice-major:
    ``pos [N, k]`` fp32, ``pos >= capacity`` drops; rows with ``valid``
    False take no slot (pos -1)."""
    e = masks[0].shape[-1]
    offset = torch.zeros((e,), dtype=torch.float32, device=masks[0].device)
    poss = []
    for m in masks:
        mv = m if valid is None else m * valid.to(torch.float32)[:, None]
        ranks = torch.cumsum(mv, 0) + offset[None, :]
        poss.append((ranks * mv).sum(-1) - 1.0)
        offset = offset + mv.sum(0)
    return torch.stack(poss, dim=1)


def _grouped_mm(xs, w, offsets, use_kernel):
    """An fp stack or a quantized ``{"q", "s"}`` dict through the ragged
    grouped GEMM."""
    if isinstance(w, dict):
        return grouped_matmul(xs, w["q"], offsets, scales=w["s"],
                              use_kernel=use_kernel)
    return grouped_matmul(xs, w, offsets, use_kernel=use_kernel)


def _expert_bias(b, eids):
    """Per-row bias gather from an ``[E, F]`` stack."""
    return b[eids.long()]


def moe_ffn(x, gate_w, w1, b1, w2, b2, *, top_k: int,
            capacity_factor: float, use_kernel=None, valid=None,
            with_stats: bool = False):
    """The MoE FFN over 2D tokens ``x [N, d]``.

    gate_w ``[d, E]``; w1 ``[E, d, f]`` / w2 ``[E, f, d]`` (fp stacks or
    quantized ``{"q", "s"}`` dicts, the ``inference/quantize.py`` layout);
    b1 ``[E, f]``; b2 ``[E, d]``. ``valid [N]`` masks padding rows: they
    take no capacity slot and output zero. Dropped pairs keep their place
    in the grouped layout and combine with gate 0. ``use_kernel`` as
    :func:`~paddle_tpu_torch.ops.grouped_matmul.grouped_matmul`.

    Returns ``(out [N, d], aux_loss)``, plus a stats dict (``load [E]``
    kept-pair fraction per expert, ``drop_rate``, ``capacity``) when
    ``with_stats``.
    """
    n, d = x.shape
    e = gate_w.shape[-1]
    k = int(top_k)
    logits = x.float() @ gate_w.float()
    gates, idx, probs, masks = route_topk(logits, k)
    aux = load_balance_aux(probs, masks[0], valid=valid)
    cap = moe_capacity(n, e, k, capacity_factor)
    pos = capacity_positions(masks, cap, valid=valid)
    keep = (pos >= 0.0) & (pos < cap)                     # [N, k]
    if valid is not None:
        keep = keep & valid[:, None]
    gates = gates * keep.to(gates.dtype)

    # token-choice pairs sorted by expert (stable: token-major within an
    # expert) — the ragged grouped layout. Every size here is fixed by the
    # shapes (no host read of a device value: the serving step runs in a
    # captured CUDA graph), so the expert counts are a scatter-add into E
    # bins rather than ``bincount``, which reads the max on the host
    pair_tok = torch.arange(n * k, device=x.device) // k
    eid = idx.reshape(-1).long()
    order = torch.argsort(eid, stable=True)
    tok_sorted = pair_tok[order]
    eid_sorted = eid[order]
    counts = torch.zeros(e, dtype=torch.long, device=x.device).scatter_add_(
        0, eid, torch.ones_like(eid))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]
                        ).to(torch.int32)

    xs = x[tok_sorted]                                    # [N*k, d]
    h = _grouped_mm(xs, w1, offsets, use_kernel)
    h = torch.nn.functional.gelu(h + _expert_bias(b1, eid_sorted).to(h.dtype),
                                 approximate="tanh")
    y = (_grouped_mm(h.to(x.dtype), w2, offsets, use_kernel)
         + _expert_bias(b2, eid_sorted).to(x.dtype))
    g_sorted = gates.reshape(-1)[order].float()
    contrib = y.float() * g_sorted[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    out = contrib[inv].view(n, k, d).sum(1).to(x.dtype)
    if not with_stats:
        return out, aux
    kept = keep.to(torch.float32)
    n_pairs = (valid.to(torch.float32).sum().clamp_min(1.0) * k
               if valid is not None
               else torch.full((), float(n * k), device=x.device))
    load = (torch.nn.functional.one_hot(eid, e).to(torch.float32)
            * kept.reshape(-1, 1)).sum(0)
    stats = {
        "load": load / load.sum().clamp_min(1.0),
        "drop_rate": 1.0 - torch.clamp(kept.sum() / n_pairs, max=1.0),
        "capacity": float(cap),
    }
    return out, aux, stats


# ---------------------------------------------------------------------------
# einsum (dispatch / combine) formulation — the SPMD training spelling
# ---------------------------------------------------------------------------


def _combine_one(gate, mask, pos, capacity: int):
    keep = (pos >= 0) & (pos < capacity)
    kf = keep.to(torch.float32)
    mask = mask * kf[:, None]
    slots = pos.clamp(0, capacity - 1).long()
    oh = torch.nn.functional.one_hot(slots, capacity).to(torch.float32) \
        * kf[:, None]
    return (gate * kf)[:, None, None] * mask[:, :, None] * oh[:, None, :]


def topk_dispatch_combine(logits, capacity: int, top_k: int):
    """Dense-mask gating for any k: ``(combine [N, E, C], dispatch [N, E,
    C], aux_loss)`` with the tie-breaks, slot priority and renormalized
    gates of :func:`moe_ffn`."""
    gates, _idx, probs, masks = route_topk(logits, top_k)
    aux = load_balance_aux(probs, masks[0])
    pos = capacity_positions(masks, capacity)
    combine = torch.zeros((logits.shape[0], logits.shape[1], int(capacity)),
                          dtype=torch.float32, device=logits.device)
    for j, m in enumerate(masks):
        combine = combine + _combine_one(gates[:, j], m, pos[:, j],
                                         int(capacity))
    dispatch = (combine > 0).to(logits.dtype)
    return combine, dispatch, aux


def moe_ffn_einsum(x, gate_w, w1, b1, w2, b2, *, top_k: int,
                   capacity_factor: float):
    """Capacity-dense einsum MoE: the training-path twin of
    :func:`moe_ffn`. Returns ``(out [N, d], aux)``."""
    n = x.shape[0]
    e = gate_w.shape[-1]
    cap = moe_capacity(n, e, top_k, capacity_factor)
    logits = x.float() @ gate_w.float()
    combine, dispatch, aux = topk_dispatch_combine(logits, cap, top_k)
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), x)
    h = torch.nn.functional.gelu(
        torch.einsum("ecd,edh->ech", expert_in, w1) + b1[:, None, :],
        approximate="tanh")
    expert_out = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]
    out = torch.einsum("nec,ecd->nd", combine.to(x.dtype), expert_out)
    return out, aux


def active_params_frac(config) -> float:
    """Fraction of per-layer decoder weights a token streams under top-k
    routing: attention and router always, k of E expert FFNs."""
    e = int(getattr(config, "moe_experts", 0) or 0)
    if not e:
        return 1.0
    h, f = config.hidden_size, config.ffn_size
    k = int(config.moe_top_k)
    attn = 4 * h * h + 4 * h
    gate = h * e
    expert = 2 * h * f + h + f
    total = attn + gate + e * expert
    active = attn + gate + min(k, e) * expert
    return float(active) / float(total)


# ---------------------------------------------------------------------------
# eager module (GPTDecoderLayer's MLP when config.moe_experts > 0)
# ---------------------------------------------------------------------------


class GPTMoE(nn.Module):
    """Eager MoE FFN block — the GPTMLP drop-in for MoE configs.

    One stacked parameter per role (``gate_weight [h, E]``, ``w1 [E, h,
    f]``, ``b1 [E, f]``, ``w2 [E, f, h]``, ``b2 [E, h]``), so serving
    stacks them ``[L, E, ...]`` like the dense keys. Forward runs the same
    :func:`moe_ffn` as the serving step; ``aux_loss`` and ``router_stats``
    (``load``, ``drop_rate``: detached tensors) refresh per call.
    ``MATRICES`` names the parameters drawn N(0, initializer_range); the
    biases start at zero."""

    MATRICES = ("gate_weight", "w1", "w2")

    def __init__(self, config, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        h, f, e = config.hidden_size, config.ffn_size, config.moe_experts
        kw = dict(device=device, dtype=dtype)
        self.gate_weight = nn.Parameter(torch.empty(h, e, **kw))
        self.w1 = nn.Parameter(torch.empty(e, h, f, **kw))
        self.b1 = nn.Parameter(torch.zeros(e, f, **kw))
        self.w2 = nn.Parameter(torch.empty(e, f, h, **kw))
        self.b2 = nn.Parameter(torch.zeros(e, h, **kw))
        self.aux_loss = None
        self.router_stats = None

    def forward(self, x):
        cfg = self.config
        tokens = x.reshape(-1, x.shape[-1])
        out, aux, stats = moe_ffn(
            tokens, self.gate_weight, self.w1, self.b1, self.w2, self.b2,
            top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
            with_stats=True)
        self.aux_loss = aux
        self.router_stats = {"load": stats["load"].detach(),
                             "drop_rate": stats["drop_rate"].detach()}
        return out.reshape(x.shape)
