"""Paged KV cache manager — port of ``paddle_tpu/inference/kv_cache.py``.

The cache is a POOL of fixed-size pages per K and V, ``[num_layers,
num_pages, page_size, kv_heads, head_dim]``; each admitted sequence owns
pages through a per-slot page table (``-1`` = unallocated) and
``seq_lens[slot]`` counts the tokens already written.

- **host side** (:class:`KVCacheManager`): page and slot free lists,
  admission, growth, eviction, page-granular prefix caching under sha1
  content chain keys with refcounts and an LRU of zero-ref registered
  pages, and copy-on-write claims — plain Python/numpy, the same
  algorithm (and so the same page numbers) as the reference.
- **device side** (functions below): the packed K/V scatter (fp, or
  int8 with a per-token, per-head scale: quantize-on-write, or rows the
  mega attention kernel already quantized) and the CoW page copy the
  unified step runs; the one-token-per-slot and whole-prompt writes of
  the legacy decode and prefill programs.

The reference drops out-of-range scatters (``mode="drop"``); torch has no
such mode. The port's pools therefore carry ONE spare page at index
``num_pages``: padding tokens, unallocated entries and no-op CoW lanes
land there, nothing wraps or faults, and the attention kernel is handed
the pools without it. The pools update in place — the reference donates
them to its jit.

Speculative decoding's page accounting is here too: the draft allowance
(drafts claim only strictly-free pages), the plain-step page need, and
the rollback of rejected drafts' pages (``trim_pages`` / ``rollback``).

Not ported here (they raise): the host-DRAM tier, page import/export and
withholding pages.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict

import numpy as np
import torch

from .._device import resolve_device
from ..observability import MetricsRegistry
from ..ops.paged_attention import PAGE_SIZE_DEFAULT
from .staging import STAGING_SLOTS_DEFAULT, DeviceBuffer


def kv_cache_quantized(kv_cache_dtype) -> bool:
    """Map a ``kv_cache_dtype`` config value to the pool-quantization flag;
    an unsupported value raises rather than serving a full-precision
    cache."""
    if kv_cache_dtype in (None, "none"):
        return False
    if kv_cache_dtype == "int8":
        return True
    raise ValueError(
        f"kv_cache_dtype must be None or 'int8', got {kv_cache_dtype!r} "
        "(int4 KV is not supported — sub-byte pages would halve the "
        "scatter granularity; weight_dtype='int4' is the 4x lever)")


def pages_needed(length: int, page_size: int) -> int:
    """Pages a ``length``-token sequence occupies (>= 1)."""
    return math.ceil(max(length, 1) / page_size)


def chain_key(prev: bytes, tokens) -> bytes:
    """The prefix cache's sha1 content chain key: page i's key folds page
    i-1's, so one key names the whole prefix up to and including this
    page's tokens (count included). Byte-identical to the reference's, so
    both packages name a prefix the same way."""
    h = hashlib.sha1(prev)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


def prompt_chain_keys(tokens, page_size: int) -> list[bytes]:
    """The chain keys of every FULL page of ``tokens``, shallowest first
    (prompts shorter than one page: empty list)."""
    keys: list[bytes] = []
    h = b""
    for i in range(0, len(tokens) - len(tokens) % int(page_size),
                   int(page_size)):
        h = chain_key(h, tokens[i:i + page_size])
        keys.append(h)
    return keys


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


def packed_dest(page_table, tok_slot, tok_pos, page_size, num_pages):
    """Per-token ``(page, row)`` of a packed write; padding (< 0 slot or
    position) and unallocated (-1) entries route to page ``num_pages``.
    The unified step computes it once and writes every layer's K and V."""
    b, pps = page_table.shape
    slot_c = tok_slot.long().clamp(0, b - 1)
    pos = tok_pos.long().clamp_min(0)
    pg = page_table[slot_c, (pos // page_size).clamp(0, pps - 1)].long()
    valid = (tok_slot >= 0) & (tok_pos >= 0) & (pg >= 0)
    return torch.where(valid, pg, num_pages), pos % page_size


def paged_write_packed_(pool, toks, dest):
    """In-place packed write into ONE layer's pool ``[num_pages + 1,
    page_size, kv_heads, head_dim]`` (spare page last); toks ``[budget,
    kv_heads, head_dim]``, dest from :func:`packed_dest`."""
    pool[dest] = toks.to(pool.dtype)


_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def quantize_kv_rows(toks):
    """The int8 KV write's quantizer: each token row quantizes per head
    against its own absmax, ``scale = max(absmax, 1e-8) / 127`` in fp32,
    ``q = clip(round_half_even(x / scale), -127, 127)``. toks ``[budget,
    kv_heads, head_dim]``; returns ``(q int8, scales fp32 [budget,
    kv_heads])``. The division by 127 is a product with fp32(1/127): the
    reference's step is jitted, and XLA computes a division by a constant
    that way, so this gives its scales bit for bit."""
    tf = toks.to(torch.float32)
    s = tf.abs().amax(dim=-1).clamp_min(1e-8) * _INV_127
    q = torch.round(tf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def paged_write_packed_prequant_(pool, scales, q_toks, s_toks, dest):
    """In-place scatter of rows ALREADY quantized (the mega attention
    kernel quantizes them inline): int8 payloads ``q_toks [budget,
    kv_heads, head_dim]`` and their scales ``s_toks [budget, kv_heads]``
    into ONE layer's int8 pool and scale plane (spare page last)."""
    pool[dest] = q_toks.to(pool.dtype)
    scales[dest] = s_toks.to(scales.dtype)


def paged_write_packed_quant_(pool, scales, toks, dest):
    """In-place quantize-on-write into ONE layer's int8 pool ``[num_pages +
    1, page_size, kv_heads, head_dim]`` and its fp32 scale plane
    ``[num_pages + 1, page_size, kv_heads]`` (spare page last)."""
    paged_write_packed_prequant_(pool, scales, *quantize_kv_rows(toks), dest)


def _with_spare(*planes):
    """Copies of ``[num_pages, ...]`` arrays with a spare page appended, for
    the functional forms: a write routed there is dropped."""
    return [torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
            for t in planes]


def paged_write_packed_quant(pages, scales, toks, page_table, tok_slot,
                             tok_pos, page_size):
    """Functional form over ``[num_pages, ...]`` int8 pages and ``[num_pages,
    page_size, kv_heads]`` scales (the reference's signature): returns
    ``(pages, scales)``, dropped writes dropped."""
    n = pages.shape[0]
    ext, ext_s = _with_spare(pages, scales)
    paged_write_packed_quant_(ext, ext_s, toks, packed_dest(
        page_table, tok_slot, tok_pos, page_size, n))
    return ext[:n], ext_s[:n]


def paged_write_packed_prequant(pages, scales, q_toks, s_toks, page_table,
                                tok_slot, tok_pos, page_size):
    """Functional form over ``[num_pages, ...]`` int8 pages and scales (the
    reference's signature): returns ``(pages, scales)``, dropped writes
    dropped."""
    n = pages.shape[0]
    ext, ext_s = _with_spare(pages, scales)
    paged_write_packed_prequant_(ext, ext_s, q_toks, s_toks, packed_dest(
        page_table, tok_slot, tok_pos, page_size, n))
    return ext[:n], ext_s[:n]


def paged_write_packed(pages, toks, page_table, tok_slot, tok_pos,
                       page_size):
    """Functional form over ``[num_pages, ...]`` pages (the reference's
    signature): returns the updated pool, dropped writes dropped."""
    n = pages.shape[0]
    (ext,) = _with_spare(pages)
    paged_write_packed_(ext, toks, packed_dest(page_table, tok_slot, tok_pos,
                                               page_size, n))
    return ext[:n]


def paged_write_tokens_(pool, tok, page_table, positions, page_size):
    """In-place decode-step write: ONE token per slot into ONE layer's pool
    ``[num_pages + 1, page_size, kv_heads, head_dim]`` (spare page last).
    tok ``[b, kv_heads, head_dim]``; positions ``[b]`` (< 0: an inactive
    slot). Inactive slots and unallocated (-1) entries land on the spare
    page — the reference's ``mode="drop"``."""
    num_pages = pool.shape[0] - 1
    b, pps = page_table.shape
    pos = positions.long().clamp_min(0)
    pg = page_table[torch.arange(b, device=pool.device),
                    (pos // page_size).clamp_max(pps - 1)].long()
    pg = torch.where((positions >= 0) & (pg >= 0), pg, num_pages)
    pool[pg, pos % page_size] = tok.to(pool.dtype)


def paged_write_prefill_(pool, seq, pages_for_slot, length, page_size):
    """In-place prefill write of one slot's prompt K/V ``seq [s_pad,
    kv_heads, head_dim]`` into ONE layer's pool (spare page last) through
    its page-table row ``pages_for_slot [pps]``. Positions at or past
    ``length`` (padding) and unallocated entries land on the spare page."""
    num_pages = pool.shape[0] - 1
    i = torch.arange(seq.shape[0], device=pool.device)
    pg = pages_for_slot.long()[(i // page_size).clamp_max(
        pages_for_slot.shape[0] - 1)]
    pg = torch.where((i < length) & (pg >= 0), pg, num_pages)
    pool[pg, i % page_size] = seq.to(pool.dtype)


def paged_copy_pages_(pools, src, dst):
    """In-place copy-on-write over every layer of ``[L, num_pages + 1,
    ...]`` pools: lane i copies page ``src[i]`` to ``dst[i]``; the no-op
    sentinel ``dst == num_pages`` lands in the spare page."""
    num_pages = pools.shape[1] - 1
    pools[:, dst.long()] = pools[:, src.long().clamp(0, num_pages - 1)]


def paged_copy_pages(pages, src, dst):
    """Functional form over ``[L, num_pages, ...]`` pages (the reference's
    signature): ``dst == num_pages`` drops the copy."""
    n = pages.shape[1]
    ext = torch.cat([pages, pages[:, :1].clone()], dim=1)
    paged_copy_pages_(ext, src, dst)
    return ext[:, :n]


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


def _not_ported(name: str, later: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"KVCacheManager.{name} belongs to {later}, a later port slice")
    method.__name__ = name
    return method


class KVCacheManager:
    """Owns the page pools, page table and free lists for one model.

    ``num_pages`` bounds cached tokens (``num_pages * page_size``),
    ``max_batch`` concurrent sequences, ``max_seq_len`` the per-sequence
    length (page-table width). Pools live on ``device`` (``None`` =
    ``cuda:0``). ``quantize_kv=True`` stores the pools int8 with fp32
    scale planes ``k_scales`` / ``v_scales`` ``[num_layers, num_pages + 1,
    page_size, kv_heads]`` — one scale per (page slot, head), so a scale
    travels with its page through copy-on-write and prefix sharing;
    ``dtype`` stays the compute dtype. ``staging_slots``: pinned host
    buffers behind each device view (``inference/staging.py``), one per
    step the serving engine may have in flight, plus one.
    """

    def __init__(self, num_layers, num_kv_heads, head_dim, *, num_pages,
                 max_batch, max_seq_len, page_size=None,
                 dtype=torch.float32, enable_prefix_cache=False,
                 quantize_kv=False, mesh=None, metrics=None,
                 host_tier_bytes=0, device=None,
                 staging_slots=STAGING_SLOTS_DEFAULT):
        if mesh is not None:
            raise NotImplementedError(
                "head-sharded pools are the multi-GPU serving slice")
        if host_tier_bytes:
            raise NotImplementedError(
                "the host-DRAM spill tier is the fleet/robustness slice")
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.page_size = int(page_size or PAGE_SIZE_DEFAULT)
        self.num_pages = int(num_pages)
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        self.pages_per_slot = math.ceil(self.max_seq_len / self.page_size)
        shape = (num_layers, self.num_pages + 1, self.page_size,
                 num_kv_heads, head_dim)
        self.quantize_kv = bool(quantize_kv)
        pool_dtype = torch.int8 if self.quantize_kv else dtype
        self.k_pool = torch.zeros(shape, dtype=pool_dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=pool_dtype, device=self.device)
        self.k_scales = self.v_scales = None
        if self.quantize_kv:
            self.k_scales = torch.zeros(shape[:4], dtype=torch.float32,
                                        device=self.device)
            self.v_scales = torch.zeros_like(self.k_scales)
        self._page_table = np.full((self.max_batch, self.pages_per_slot), -1,
                                   np.int32)
        self._seq_lens = np.zeros((self.max_batch,), np.int32)
        self._pt_rev = 0
        self._sl_rev = 0
        # the step's device views: persistent buffers (a captured step
        # keeps their addresses), refreshed in place through pinned staging
        # when a mutator changed the host copy since the last refresh
        self._pt_buf = DeviceBuffer(self._page_table.shape, torch.int32,
                                    self.device, staging_slots)
        self._sl_buf = DeviceBuffer(self._seq_lens.shape, torch.int32,
                                    self.device, staging_slots)
        self._pt_sent = self._sl_sent = -1
        self._free_pages = list(range(self.num_pages - 1, -1, -1))  # pop()
        self._free_slots = list(range(self.max_batch - 1, -1, -1))
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self._refcount = np.zeros((self.num_pages,), np.int32)
        self._page_key: dict[int, bytes] = {}      # page -> chain key
        self._prefix_pages: dict[bytes, int] = {}  # chain key -> page
        self._lru: OrderedDict[int, None] = OrderedDict()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m_pages_free = m.gauge("kv_pages_free", "strictly-free pages")
        self._m_pages_evictable = m.gauge(
            "kv_pages_evictable", "zero-ref registered pages on the LRU")
        self._m_slots_free = m.gauge("kv_slots_free", "unoccupied slots")
        self._m_prefix_hit = m.counter(
            "kv_prefix_hit_tokens", "admitted tokens served from the cache")
        self._m_prefix_query = m.counter(
            "kv_prefix_query_tokens", "admitted tokens queried")
        self._m_evictions = m.counter(
            "kv_prefix_evictions", "registered pages evicted off the LRU")
        self._m_cow = m.counter(
            "kv_cow_copies", "copy-on-write page copies prepared")
        self._m_trimmed = m.counter(
            "kv_pages_trimmed", "pages released by draft rollback")
        self._note_occupancy()

    def _note_occupancy(self) -> None:
        self._m_pages_free.set(len(self._free_pages))
        self._m_pages_evictable.set(len(self._lru))
        self._m_slots_free.set(len(self._free_slots))

    # -- capacity ----------------------------------------------------------

    @property
    def prefix_hit_tokens(self) -> int:
        return int(self._m_prefix_hit.value)

    @property
    def prefix_query_tokens(self) -> int:
        return int(self._m_prefix_query.value)

    @property
    def free_page_count(self) -> int:
        return len(self._free_pages)

    @property
    def available_page_count(self) -> int:
        """Truly free pages + evictable (zero-ref registered) ones."""
        return len(self._free_pages) + len(self._lru)

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    def pages_needed(self, length: int) -> int:
        return pages_needed(length, self.page_size)

    def can_admit(self, prompt_len: int) -> bool:
        return (bool(self._free_slots)
                and prompt_len <= self.max_seq_len
                and self.pages_needed(prompt_len)
                <= self.available_page_count)

    def _alloc_page(self) -> int:
        """The free list first, then evict the LRU tail of the zero-ref
        registered pages (unregistering it)."""
        if self._free_pages:
            return self._free_pages.pop()
        if self._lru:
            page, _ = self._lru.popitem(last=False)   # oldest
            del self._prefix_pages[self._page_key.pop(page)]
            self._m_evictions.inc()
            return page
        raise RuntimeError("cache exhausted: no free or evictable pages")

    def _release_page(self, page: int) -> None:
        """Drop one reference; a zero-ref page parks on the LRU if
        registered (it keeps serving prefix hits), else frees."""
        self._refcount[page] -= 1
        if self._refcount[page] < 0:
            raise RuntimeError(f"refcount underflow on page {page}")
        if self._refcount[page] == 0:
            if page in self._page_key:
                self._lru[page] = None        # MRU end
            else:
                self._free_pages.append(page)

    # -- admission / growth / eviction ------------------------------------

    def admit(self, prompt_len: int) -> int:
        """Claim a slot + the pages the prompt needs; returns the slot."""
        if prompt_len > self.max_seq_len:
            raise RuntimeError(
                f"prompt of {prompt_len} tokens exceeds max_seq_len "
                f"{self.max_seq_len}")
        if not self._free_slots:
            raise RuntimeError("no free decode slots")
        need = self.pages_needed(prompt_len)
        if need > self.available_page_count:
            raise RuntimeError(
                f"cache exhausted: need {need} pages, "
                f"{self.available_page_count} free")
        slot = self._free_slots.pop()
        for i in range(need):
            page = self._alloc_page()
            self._page_table[slot, i] = page
            self._refcount[page] = 1
        self._seq_lens[slot] = prompt_len
        self._pt_rev += 1
        self._sl_rev += 1
        self._note_occupancy()
        return slot

    def ensure_capacity(self, slot: int, new_len: int) -> bool:
        """Allocate pages so ``slot`` can hold ``new_len`` tokens; False
        (allocating nothing) when the pool cannot."""
        if new_len > self.max_seq_len:
            return False
        have = int((self._page_table[slot] >= 0).sum())
        need = self.pages_needed(new_len)
        if need <= have:
            return True
        if need - have > self.available_page_count:
            return False
        for i in range(have, need):
            page = self._alloc_page()
            self._page_table[slot, i] = page
            self._refcount[page] = 1
        self._pt_rev += 1
        self._note_occupancy()
        return True

    def advance(self, slot: int, n: int = 1) -> None:
        self._seq_lens[slot] += n
        self._sl_rev += 1

    def draft_allowance(self, slot: int, reserve: int = 0) -> int:
        """Draft tokens ``slot`` may feed this step beyond its base decode
        token using only its own pages and strictly-free ones, after
        reserving the base token's growth page, a copy-on-write destination
        when the write position is shared, and ``reserve`` pages promised
        elsewhere (the plain needs of the other slots scheduled this step):
        a rejected draft never costs a registered prefix page its place or
        preempts anyone."""
        written = int(self._seq_lens[slot])
        if written >= self.max_seq_len:
            return 0     # at the ceiling: the truncation stop owns it
        have = int((self._page_table[slot] >= 0).sum())
        base_need = max(0, self.pages_needed(written + 1) - have)
        cow_need = 1 if self.needs_cow(slot, written) else 0
        spare = max(0, len(self._free_pages) - base_need - cow_need
                    - max(0, int(reserve)))
        cap = min((have + base_need + spare) * self.page_size,
                  self.max_seq_len)
        return max(0, cap - written - 1)

    def plain_step_page_need(self, slot: int, n_tokens: int) -> int:
        """Pages ``slot`` claims this step to write ``n_tokens`` plain
        (non-draft) tokens: growth pages, and a copy-on-write destination
        when the first write position is shared."""
        written = int(self._seq_lens[slot])
        if written >= self.max_seq_len:
            return 0
        have = int((self._page_table[slot] >= 0).sum())
        grow = max(0, self.pages_needed(
            min(written + max(1, n_tokens), self.max_seq_len)) - have)
        return grow + (1 if self.needs_cow(slot, written) else 0)

    def trim_pages(self, slot: int) -> int:
        """Release ``slot``'s pages past what ``seq_len`` needs: the host
        half of a rejected draft's rollback. The pages go back highest
        index first, so the free list ends as a never-speculated run's
        (allocation pops its tail). Trimmed pages are fresh refcount-1
        pages: shared prefix pages sit below the watermark, and a shared
        tail was copied before any draft wrote into it. Returns the pages
        released."""
        keep = self.pages_needed(int(self._seq_lens[slot]))
        have = int((self._page_table[slot] >= 0).sum())
        freed = 0
        for i in range(have - 1, keep - 1, -1):
            page = int(self._page_table[slot, i])
            if page < 0:
                continue
            self._page_table[slot, i] = -1
            self._release_page(page)
            freed += 1
        if freed:
            self._pt_rev += 1
            self._m_trimmed.inc(freed)
            self._note_occupancy()
        return freed

    def rollback(self, slot: int, new_len: int) -> int:
        """Shrink ``slot``'s watermark to ``new_len`` tokens and release the
        pages past it (the draft pool's self-heal; its pages are never
        shared). Returns the pages released."""
        new_len = max(0, int(new_len))
        if new_len > int(self._seq_lens[slot]):
            raise ValueError(
                f"rollback to {new_len} tokens past slot {slot}'s "
                f"watermark {int(self._seq_lens[slot])}")
        if new_len != int(self._seq_lens[slot]):
            self._seq_lens[slot] = new_len
            self._sl_rev += 1
        return self.trim_pages(slot)

    def free(self, slot: int) -> None:
        """Drop the slot's page references (shared pages survive in other
        slots / the prefix LRU) and park the slot."""
        for i in range(self.pages_per_slot):
            pg = int(self._page_table[slot, i])
            if pg >= 0:
                self._release_page(pg)
            self._page_table[slot, i] = -1
        self._seq_lens[slot] = 0
        self._pt_rev += 1
        self._sl_rev += 1
        self._free_slots.append(slot)
        self._note_occupancy()

    # -- prefix cache ------------------------------------------------------

    def _match_prefix(self, tokens):
        """Longest registered prefix of ``tokens`` at page granularity (the
        final page may match a partial fill), capped at ``len - 1`` so one
        token is left to feed. Returns (pages, matched_len)."""
        ps = self.page_size
        n = len(tokens)
        pages: list[int] = []
        matched = 0
        h = b""
        while matched + ps <= n:
            nxt = chain_key(h, tokens[matched:matched + ps])
            page = self._prefix_pages.get(nxt)
            if page is None:
                break
            pages.append(page)
            matched += ps
            h = nxt
        for t in range(min(ps - 1, n - matched), 0, -1):
            page = self._prefix_pages.get(
                chain_key(h, tokens[matched:matched + t]))
            if page is not None:
                pages.append(page)
                matched += t
                break
        return pages, min(matched, n - 1)

    def admit_prefix(self, tokens, *, headroom=0, soft=False):
        """Admit a sequence whose context is ``tokens``: attach every
        registered prefix page read-only (refcount += 1), allocate fresh
        pages for the rest, set the written length to the matched count.
        Returns ``(slot, cached_len)``; on pressure ``soft=True`` returns
        None with nothing mutated instead of raising."""
        n = len(tokens)
        if n > self.max_seq_len:
            raise RuntimeError(
                f"prompt of {n} tokens exceeds max_seq_len "
                f"{self.max_seq_len}")
        if not self._free_slots:
            if soft:
                return None
            raise RuntimeError("no free decode slots")
        shared, matched = (self._match_prefix(tokens)
                           if self.enable_prefix_cache else ([], 0))
        need_total = self.pages_needed(n)
        need_fresh = need_total - len(shared)
        # matched pages on the LRU are re-pinned by THIS admission: they
        # cannot also serve the fresh allocations
        lru_matched = sum(1 for p in shared if p in self._lru)
        available = self.available_page_count - lru_matched
        if need_fresh + headroom > available:
            if soft:
                return None
            raise RuntimeError(
                f"cache exhausted: need {need_fresh} pages, "
                f"{available} free")
        self._m_prefix_query.inc(n)
        self._m_prefix_hit.inc(matched)
        slot = self._free_slots.pop()
        for i, page in enumerate(shared):
            self._page_table[slot, i] = page
            if self._refcount[page] == 0:
                self._lru.pop(page, None)
            self._refcount[page] += 1
        for i in range(len(shared), need_total):
            page = self._alloc_page()
            self._page_table[slot, i] = page
            self._refcount[page] = 1
        self._seq_lens[slot] = matched
        self._pt_rev += 1
        self._sl_rev += 1
        self._note_occupancy()
        return slot, matched

    def register_prefix(self, slot: int, tokens, include_tail=True) -> None:
        """Register ``slot``'s pages holding ``tokens`` under their chain
        keys: every full page, plus the partial tail when
        ``include_tail``. One page, one key — repeated calls are
        idempotent."""
        if not self.enable_prefix_cache:
            return
        ps = self.page_size
        h = b""
        pos = 0
        i = 0
        while pos < len(tokens):
            t = min(ps, len(tokens) - pos)
            if t < ps and not include_tail:
                break
            h = chain_key(h, tokens[pos:pos + t])
            page = int(self._page_table[slot, i])
            if page < 0:
                break
            if page not in self._page_key and h not in self._prefix_pages:
                self._page_key[page] = h
                self._prefix_pages[h] = page
            pos += t
            i += 1

    @property
    def prefix_hit_rate(self) -> float:
        if not self.prefix_query_tokens:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_query_tokens

    # -- copy-on-write -----------------------------------------------------

    def needs_cow(self, slot: int, pos: int) -> bool:
        """True when writing ``pos`` would touch a page another reference
        also holds (refcount >= 2)."""
        page = int(self._page_table[slot, pos // self.page_size])
        return page >= 0 and int(self._refcount[page]) >= 2

    def prepare_write(self, slot: int, pos: int):
        """Make ``slot``'s page at ``pos`` privately writable: ``None`` when
        it already is, else ``(src, dst)`` for the device-side copy the
        next step runs. The shared source keeps its registration."""
        i = pos // self.page_size
        page = int(self._page_table[slot, i])
        if page < 0 or int(self._refcount[page]) < 2:
            return None
        dst = self._alloc_page()
        self._refcount[dst] = 1
        self._page_table[slot, i] = dst
        self._pt_rev += 1
        self._refcount[page] -= 1
        self._m_cow.inc()
        self._note_occupancy()
        return page, dst

    # -- device views ------------------------------------------------------

    def pools(self) -> tuple:
        """The device pools in the unified step's order: ``(k_pool,
        v_pool)``, then ``(k_scales, v_scales)`` when quantized."""
        if self.quantize_kv:
            return self.k_pool, self.v_pool, self.k_scales, self.v_scales
        return self.k_pool, self.v_pool

    def page_table_device(self) -> torch.Tensor:
        """The page table on the pools' device: ONE persistent buffer,
        refreshed in place (a queued copy, ordered after every step already
        dispatched) only when a mutator changed it since the last refresh.
        Unlike the reference's snapshots, a later refresh rewrites what an
        earlier call returned: a step reads it in stream order, before the
        next refresh lands."""
        if self._pt_sent != self._pt_rev:
            self._pt_buf.put(self._page_table)
            self._pt_sent = self._pt_rev
        return self._pt_buf.tensor

    def seq_lens_device(self) -> torch.Tensor:
        """``seq_lens`` on the pools' device, kept like
        :meth:`page_table_device`."""
        if self._sl_sent != self._sl_rev:
            self._sl_buf.put(self._seq_lens)
            self._sl_sent = self._sl_rev
        return self._sl_buf.tensor

    def seq_len(self, slot: int) -> int:
        return int(self._seq_lens[slot])

    def slot_pages(self, slot: int) -> torch.Tensor:
        """``slot``'s page-table row ``[pages_per_slot]`` on the pools'
        device. The legacy prefill writes the pools in place through it, so
        there is no ``update_pages``: the reference's jitted programs
        return new pools for the manager to adopt, the port's update the
        manager's own."""
        return torch.from_numpy(self._page_table[slot].copy()).to(
            self.device)

    withhold_pages = _not_ported("withhold_pages", "fault injection")
    read_page_payload = _not_ported("read_page_payload",
                                    "KV-page transfer")
    prefix_page_records = _not_ported("prefix_page_records",
                                      "KV-page transfer")
    import_prefix_page = _not_ported("import_prefix_page",
                                     "KV-page transfer")
    import_prefix_pages = _not_ported("import_prefix_pages",
                                      "KV-page transfer")
