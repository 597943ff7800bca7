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
- **device side** (functions below): the packed K/V scatter and the CoW
  page copy the unified step runs.

The reference drops out-of-range scatters (``mode="drop"``); torch has no
such mode. The port's pools therefore carry ONE spare page at index
``num_pages``: padding tokens, unallocated entries and no-op CoW lanes
land there, nothing wraps or faults, and the attention kernel is handed
the pools without it. The pools update in place — the reference donates
them to its jit.

Not ported here (they raise): the host-DRAM tier, page import/export,
withholding pages and trimming speculative pages.
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


def paged_write_packed(pages, toks, page_table, tok_slot, tok_pos,
                       page_size):
    """Functional form over ``[num_pages, ...]`` pages (the reference's
    signature): returns the updated pool, dropped writes dropped."""
    n = pages.shape[0]
    ext = torch.cat([pages, pages.new_zeros((1,) + tuple(pages.shape[1:]))])
    paged_write_packed_(ext, toks, packed_dest(page_table, tok_slot, tok_pos,
                                               page_size, n))
    return ext[:n]


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
    ``cuda:0``).
    """

    def __init__(self, num_layers, num_kv_heads, head_dim, *, num_pages,
                 max_batch, max_seq_len, page_size=None,
                 dtype=torch.float32, enable_prefix_cache=False,
                 quantize_kv=False, mesh=None, metrics=None,
                 host_tier_bytes=0, device=None):
        if quantize_kv:
            raise NotImplementedError(
                "int8 KV pools are the quantized-KV serving slice")
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
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self._page_table = np.full((self.max_batch, self.pages_per_slot), -1,
                                   np.int32)
        self._seq_lens = np.zeros((self.max_batch,), np.int32)
        self._pt_rev = 0
        self._sl_rev = 0
        self._pt_dev = (-1, None)
        self._sl_dev = (-1, None)
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

    def page_table_device(self) -> torch.Tensor:
        """The page table on the pools' device, uploaded only when a
        mutator changed it since the last upload."""
        rev, dev = self._pt_dev
        if rev != self._pt_rev:
            dev = torch.from_numpy(self._page_table.copy()).to(self.device)
            self._pt_dev = (self._pt_rev, dev)
        return dev

    def seq_lens_device(self) -> torch.Tensor:
        rev, dev = self._sl_dev
        if rev != self._sl_rev:
            dev = torch.from_numpy(self._seq_lens.copy()).to(self.device)
            self._sl_dev = (self._sl_rev, dev)
        return dev

    def seq_len(self, slot: int) -> int:
        return int(self._seq_lens[slot])

    withhold_pages = _not_ported("withhold_pages", "fault injection")
    trim_pages = _not_ported("trim_pages", "speculative decoding")
    read_page_payload = _not_ported("read_page_payload",
                                    "KV-page transfer")
    prefix_page_records = _not_ported("prefix_page_records",
                                      "KV-page transfer")
    import_prefix_page = _not_ported("import_prefix_page",
                                     "KV-page transfer")
    import_prefix_pages = _not_ported("import_prefix_pages",
                                      "KV-page transfer")
