"""Draft proposers for speculative decoding — port of
``paddle_tpu/inference/draft.py``.

Each request owns one proposer; the serving scheduler hands it the
request's context (prompt and landed outputs) and asks for up to ``k``
draft tokens a decode step. The unified step verifies them in one ragged
pass and keeps the longest matching prefix and one token more
(``models/gpt.py build_unified_step(spec_k=)``).

- :class:`DraftProposer`: prompt-lookup decoding over an n-gram table of
  the context. The longest trailing n-gram (``max_ngram`` down to 1) that
  occurred earlier, its most recent occurrence, gives the tokens that
  followed it; copied tokens extend a virtual context and the lookup
  repeats, so a period-1 tail fills all ``k`` slots. The table is
  incremental and a function of the context alone, so a preemption
  replay proposes the same drafts.
- adaptive k: ``update(proposed, accepted)`` drives an EMA of acceptance;
  ``k`` falls with it to 0 (plain decode), and while at 0 a cooldown of
  plain steps re-arms a probe.
- :class:`ModelDraftProposer` / :class:`ModelDraftEngine`: the self-draft,
  the first ``draft_layers`` layers of the same serving params (shared
  embeddings, final LN and LM head) over a draft KV pool of its own. One
  engine pass a round drafts every lane: catch-up chunks replay context
  the pool does not hold, then one k-step chain (``build_draft_chain``)
  runs every lane's drafts on the device, and one host sync lands them.
  The pool heals itself: each lane records the tokens it fed, and a
  proposal first rolls the pool back to the longest prefix of the lane's
  current context it holds.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

__all__ = ["DraftProposer", "ModelDraftProposer", "ModelDraftEngine"]


class DraftProposer:
    """Per-request n-gram draft source with adaptive speculation length.

    ``max_k``: the most drafts a step (the verify step's build geometry).
    ``max_ngram``: the longest trailing n-gram tried first. ``alpha``: the
    EMA weight of the newest acceptance. ``min_ema``: the EMA below which
    speculation stops (k = 0). ``retry_after``: plain steps spent stopped
    before the EMA re-arms to ``probe_ema``.
    """

    def __init__(self, max_k: int, *, max_ngram: int = 3, alpha: float = 0.5,
                 min_ema: float = 0.2, retry_after: int = 16,
                 probe_ema: float = 0.5):
        if max_k < 1:
            raise ValueError(f"max_k must be >= 1, got {max_k}")
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_k = int(max_k)
        self.max_ngram = int(max_ngram)
        self.alpha = float(alpha)
        self.min_ema = float(min_ema)
        self.retry_after = int(retry_after)
        self.probe_ema = float(probe_ema)
        self._ema = 1.0          # optimistic start: speculate until priced
        self._cool = 0
        # n-gram -> latest start, over n-grams ending strictly before the
        # last context token (the tail must not shadow its earlier matches)
        self._index: dict[tuple, int] = {}
        self._synced = 0         # context positions indexed so far

    @property
    def k(self) -> int:
        """The current speculation length, monotone in the EMA: ``max_k``
        at 1.0, 0 below ``min_ema``."""
        if self._ema < self.min_ema:
            return 0
        return min(self.max_k, int(self._ema * (self.max_k + 1)))

    def update(self, proposed: int, accepted: int) -> None:
        """One decode step's outcome. ``proposed == 0`` leaves the EMA and
        ticks the re-arm cooldown while stopped."""
        if proposed <= 0:
            if self.k == 0:
                self._cool += 1
                if self._cool >= self.retry_after:
                    self._ema = self.probe_ema
                    self._cool = 0
            return
        accepted = max(0, min(int(accepted), int(proposed)))
        self._ema = ((1.0 - self.alpha) * self._ema
                     + self.alpha * (accepted / proposed))
        self._cool = 0

    def _sync(self, context) -> None:
        """Index the n-grams of ``context`` ending at positions <= len - 2
        (a high-water mark: replaying the same context is a no-op)."""
        for end in range(self._synced, len(context) - 1):
            for n in range(1, self.max_ngram + 1):
                start = end - n + 1
                if start < 0:
                    break
                self._index[tuple(context[start:end + 1])] = start
        self._synced = max(self._synced, len(context) - 1)

    def propose(self, context, budget: int) -> list[int]:
        """Up to ``min(self.k, budget)`` drafts continuing ``context``:
        none when it has fewer than 2 tokens, k backed off, or no trailing
        n-gram recurs."""
        k = min(self.k, int(budget))
        if k <= 0 or len(context) < 2:
            return []
        self._sync(context)
        drafts: list[int] = []
        v = list(context)
        # n-grams ending inside the drafted extension: later than anything
        # in the index, so they win
        overlay: dict[tuple, int] = {}

        def extend_overlay(upto):
            end = upto - 2
            for n in range(1, self.max_ngram + 1):
                start = end - n + 1
                if start < 0:
                    break
                overlay[tuple(v[start:end + 1])] = start

        while len(drafts) < k:
            match = None
            for n in range(min(self.max_ngram, len(v) - 1), 0, -1):
                key = tuple(v[-n:])
                p = overlay.get(key, self._index.get(key))
                if p is not None and p + n < len(v):
                    match = (p, n)
                    break
            if match is None:
                break
            p, n = match
            take = v[p + n:p + n + (k - len(drafts))]
            if not take:
                break
            for t in take:
                drafts.append(t)
                v.append(t)
                extend_overlay(len(v))
        return drafts


class ModelDraftProposer(DraftProposer):
    """Per-request adaptive-k state for the model draft source: the n-gram
    proposer's ``k`` / ``update`` surface, proposals from the shared
    :class:`ModelDraftEngine` (the scheduler batches every lane into one
    engine pass; :meth:`propose` is the one-lane spelling)."""

    def __init__(self, max_k: int, engine: "ModelDraftEngine", req_id,
                 **kw):
        super().__init__(max_k, **kw)
        self._engine = engine
        self._req_id = req_id

    def propose(self, context, budget: int) -> list[int]:
        k = min(self.k, int(budget))
        if k <= 0 or not len(context):
            return []
        return self._engine.propose(
            {0: (self._req_id, list(context), k)}).get(0, [])


class ModelDraftEngine:
    """The truncated-layer self-draft behind every
    :class:`ModelDraftProposer` of one predictor.

    It owns a draft KV pool (a :class:`KVCacheManager` of ``draft_layers``
    layers, int8 with ``kv_quant``), the layer views of the params it
    serves (made once: the captured programs bind them), a catch-up step
    (``build_draft_step`` at ``chunk`` tokens a lane) and one chain
    (``build_draft_chain``, per-op or ``mega``) per chain length the
    rounds ask for. Every program's inputs are persistent buffers
    refreshed through pinned staging, so on a CUDA device each is captured
    once per geometry. A lane the pool cannot hold evicts the oldest idle
    lane or proposes nothing this round: drafts are opportunistic.
    ``device``, ``staging_slots`` as for the predictor's pool.
    """

    def __init__(self, config, params, draft_layers: int, *, page_size,
                 chunk, max_batch, max_seq_len, num_pages=None,
                 kv_quant=False, max_k=None, mega=None, device=None,
                 staging_slots=None):
        from ..models.gpt import (build_draft_step, draft_config,
                                  draft_serving_params)
        from ..observability import MetricsRegistry
        from .kv_cache import KVCacheManager, pages_needed
        from .staging import STAGING_SLOTS_DEFAULT, Feed

        self.draft_layers = int(draft_layers)
        draft_config(config, self.draft_layers)      # validates the depth
        self.params = draft_serving_params(params, self.draft_layers)
        self.chunk = int(chunk)
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        self.kv_quant = bool(kv_quant)
        if num_pages is None:
            # the draft pool holds the main pool's tokens at fewer layers
            num_pages = self.max_batch * pages_needed(self.max_seq_len,
                                                      page_size)
        dev = self.params["tok_emb"].device if device is None else device
        slots = STAGING_SLOTS_DEFAULT if staging_slots is None else \
            staging_slots
        # a private registry: the pool's kv_* names would overwrite the
        # main pool's on the predictor's
        self.cache = KVCacheManager(
            self.draft_layers, config.num_heads, config.head_dim,
            num_pages=num_pages, max_batch=self.max_batch,
            max_seq_len=self.max_seq_len, page_size=page_size,
            dtype=self.params["tok_emb"].dtype, quantize_kv=self.kv_quant,
            metrics=MetricsRegistry(), device=dev, staging_slots=slots)
        self._config = config
        self.mega = bool(config.mega_decode if mega is None else mega)
        self._catchup = build_draft_step(
            config, self.draft_layers, self.cache.page_size, self.chunk,
            kv_quant=self.kv_quant, device=dev)
        self._chains: dict = {}
        self.max_k = int(max_k) if max_k else 0
        if self.max_k:
            self._chain_fn(self.max_k)    # build-time validation
        b, t = self.max_batch, self.max_batch * self.chunk
        self._t_catchup = t
        self._feed = Feed(
            [(n, t, "i32") for n in ("tok_ids", "tok_slot", "tok_pos",
                                     "feedback")]
            + [(n, b, "i32") for n in ("q_lens", "last_idx", "emit_mask")]
            + [("first", b, "i32"), ("steps", b, "i32")], dev, slots)
        i32 = dict(dtype=torch.int32, device=dev)
        # the catch-up step's fixed inputs: no copy-on-write, greedy
        self._no_cow = torch.full((b,), self.cache.num_pages, **i32)
        self._zeros = torch.zeros((b,), **i32)
        self._zero_f32 = torch.zeros((b,), dtype=torch.float32, device=dev)
        self._one_f32 = torch.ones((b,), dtype=torch.float32, device=dev)
        # req_id -> {"slot", "fed": token ids written, "rid"}, oldest
        # proposer first (the eviction order)
        self._lanes: OrderedDict = OrderedDict()
        self.model_steps = 0          # draft program launches
        self.chain_syncs = 0          # host syncs landing a chain's drafts

    @property
    def trace_count(self) -> int:
        """Captures of the draft programs (catch-up and chains) on a CUDA
        device; on the CPU the geometries that ran."""
        return self._catchup.trace_count + sum(
            c.trace_count for c in self._chains.values())

    @property
    def replay_counts(self) -> list:
        """What one replay of each draft capture adds to the kernel
        wrappers' counters, catch-up first, then the chains by length."""
        return self._catchup.replay_counts + [
            d for k in sorted(self._chains)
            for d in self._chains[k].replay_counts]

    # -- lifecycle ---------------------------------------------------------

    def release(self, req_id) -> None:
        """Drop a request's draft lane (when the request ends)."""
        st = self._lanes.pop(req_id, None)
        if st is not None:
            self.cache.free(st["slot"])

    def _evict_one(self, keep: set) -> bool:
        """Free the oldest draft lane not in ``keep``."""
        for rid in list(self._lanes):
            if rid not in keep:
                self.release(rid)
                return True
        return False

    def _lane_for(self, req_id, ctx, keep: set):
        """The request's draft lane, admitted on first use; None when the
        pool cannot hold it even after evicting every other idle lane."""
        st = self._lanes.get(req_id)
        if st is not None:
            self._lanes.move_to_end(req_id)
            return st
        while True:
            hit = self.cache.admit_prefix(ctx, soft=True)
            if hit is not None:
                st = {"slot": hit[0], "fed": [], "rid": req_id}
                self._lanes[req_id] = st
                return st
            if not self._evict_one(keep):
                return None

    def _ensure(self, st, new_len: int, keep: set) -> bool:
        """Grow a draft lane, evicting idle lanes under pressure but never
        a lane proposing this round (``keep``)."""
        while not self.cache.ensure_capacity(st["slot"], new_len):
            if new_len > self.max_seq_len or not self._evict_one(
                    keep | {st["rid"]}):
                return False
        return True

    # -- the per-round proposal pass ---------------------------------------

    def _catch_up(self, rows, q_lens) -> None:
        """One catch-up launch over packed ``rows`` ((row, slot, token,
        position) each); ``q_lens`` the tokens each slot feeds."""
        h = self._feed.host
        for name in ("tok_ids", "tok_slot", "tok_pos", "feedback",
                     "emit_mask"):
            h[name][...] = 0
        h["tok_slot"][...] = -1
        h["last_idx"][...] = self._t_catchup      # idle-lane sentinel
        h["q_lens"][...] = q_lens
        for w, slot, tok, pos in rows:
            h["tok_slot"][w], h["tok_pos"][w], h["tok_ids"][w] = slot, pos, tok
        self._feed.upload()
        d, cache = self._feed.dev, self.cache
        self._catchup(
            self.params, d["tok_ids"], d["tok_slot"], d["tok_pos"],
            d["q_lens"], cache.seq_lens_device(), d["last_idx"],
            d["feedback"], self._zeros, d["emit_mask"], self._zeros,
            *cache.pools(), cache.page_table_device(), self._no_cow,
            self._no_cow, self._zeros, self._zero_f32, self._zeros,
            self._one_f32)
        self.model_steps += 1

    def propose(self, lanes: dict) -> dict:
        """Drafts for every lane in one pass. ``lanes``: ``{key: (req_id,
        context, k)}``, each context value-complete (prompt and landed
        outputs) and ``k`` > 0 already clamped. Returns ``{key: [ints]}``
        (``[]`` for a lane the pool cannot hold)."""
        cache = self.cache
        keep = {rid for rid, _, _ in lanes.values()}
        active = {}                    # key -> (st, ctx, k)
        for key, (rid, ctx, k) in lanes.items():
            st = self._lane_for(rid, ctx, keep)
            if st is None:
                continue
            # self-heal: roll back to the longest prefix of the current
            # context the pool holds, short of the last token (the chain
            # feeds that one)
            fed, limit = st["fed"], len(ctx) - 1
            p = 0
            while p < min(len(fed), limit) and fed[p] == ctx[p]:
                p += 1
            if len(fed) > p:
                cache.rollback(st["slot"], p)
                del fed[p:]
            active[key] = (st, ctx, int(k))
        # catch-up: replay the context the pool does not hold yet
        while True:
            rows = []
            q_lens = np.zeros((self.max_batch,), np.int32)
            w = 0
            drop = []
            for key, (st, ctx, k) in active.items():
                need = len(ctx) - 1 - len(st["fed"])
                n = min(self.chunk, need, self._t_catchup - w)
                if n <= 0:
                    continue
                if not self._ensure(st, len(st["fed"]) + n, keep):
                    drop.append(key)
                    continue
                base = len(st["fed"])
                rows += [(w + i, st["slot"], ctx[base + i], base + i)
                         for i in range(n)]
                q_lens[st["slot"]] = n
                w += n
            for key in drop:
                st, _, _ = active.pop(key)
                self.release(st["rid"])
            if not rows:
                break
            self._catch_up(rows, q_lens)
            for st, ctx, _ in active.values():
                n = int(q_lens[st["slot"]])
                if n:
                    cache.advance(st["slot"], n)
                    st["fed"].extend(ctx[len(st["fed"]):len(st["fed"]) + n])
        drafts = {key: [] for key in lanes}
        if not active:
            return drafts
        # the chain: its page table is fixed for all k steps, so capacity
        # is reserved first; a lane the pool cannot grow runs fewer steps
        h = self._feed.host
        h["first"][...] = 0
        h["steps"][...] = 0
        reach = {}
        for key, (st, ctx, k) in active.items():
            s = int(k)
            while s > 0 and not self._ensure(st, len(ctx) - 1 + s, keep):
                s -= 1
            reach[key] = s
            if s > 0:
                h["first"][st["slot"]] = ctx[-1]
                h["steps"][st["slot"]] = s
        if not any(reach.values()):
            return drafts
        self._feed.upload()
        d = self._feed.dev
        out = self._chain_fn(max(k for _, _, k in active.values()))(
            self.params, d["first"], d["steps"], cache.seq_lens_device(),
            *cache.pools(), cache.page_table_device())[0]
        self.model_steps += 1
        # ONE host sync lands every lane's drafts
        arr = out.cpu().numpy()
        self.chain_syncs += 1
        for key, (st, ctx, k) in active.items():
            r = reach[key]
            if r <= 0:
                continue
            cache.advance(st["slot"], r)
            got = [int(x) for x in arr[st["slot"], :r]]
            drafts[key] = got
            # the pool now holds ctx[-1] and the first r - 1 drafts
            st["fed"].extend([ctx[-1]] + got[:r - 1])
        return drafts

    def _chain_fn(self, k: int):
        """The chain of length ``k`` (the round's longest request), built
        on first use: at most ``max_k`` of them, each captured once."""
        from ..models.gpt import build_draft_chain

        chain = self._chains.get(k)
        if chain is None:
            chain = self._chains[k] = build_draft_chain(
                self._config, self.draft_layers, self.cache.page_size, k,
                kv_quant=self.kv_quant, mega=self.mega,
                device=self.cache.device)
        return chain
