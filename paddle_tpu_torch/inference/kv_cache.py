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

The HOST TIER (``host_tier_bytes``): a bounded host-DRAM buffer under the
device pool. A zero-ref prefix page evicted off the LRU spills its
payload (K/V rows, the int8 scale planes, partial tails included) to the
host under the same chain key, with a crc32 taken at spill time. A later
admission (or export walk) whose chain breaks in the device registry but
continues in the tier lands the missing links back through the batched
import (:meth:`KVCacheManager.import_prefix_pages`: one scatter a plane a
round, in place, into the pools the captured step binds), and the match
walk then pins them like never-evicted pages. Eviction runs device ->
host -> drop: the tier keeps its own LRU under its byte budget, and an
entry whose checksum fails at restore is detected, dropped and counted —
the admission recomputes, corrupt bytes never reach the pool. Reading a
page's payload to the host (:meth:`KVCacheManager.read_page_payload`, a
spill's first step) waits for the stream: under the async engine a spill
at pack time waits for every step in flight
(``kv_tier_payload_syncs`` counts the waits).

The page payload seams: the chain-keyed export walk
(``prefix_page_records``), ``read_page_payload``, ``pin_page`` /
``unpin_page``, the landing zones (``import_prefix_page`` /
``import_prefix_pages``) and ``discard_imported_prefix``; and the
fault-injection squeeze, ``withhold_pages`` / ``restore_withheld``.
"""
from __future__ import annotations

import hashlib
import math
import zlib
from collections import OrderedDict

import numpy as np
import torch

from .._device import resolve_device
from ..observability import MetricsRegistry
from ..ops.paged_attention import PAGE_SIZE_DEFAULT
from .faults import fault_point
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


def batched_import_rows_(pools, vals, pg, row):
    """In-place landing of one restore round's token rows in ONE scatter:
    ``pools`` ``[L, num_pages + 1, page_size, kv_heads, head_dim]`` (or a
    scale plane ``[L, num_pages + 1, page_size, kv_heads]``), ``vals``
    ``[L, R, kv_heads, head_dim]`` (resp. ``[L, R, kv_heads]``): flat row
    ``r`` lands at ``pools[:, pg[r], row[r]]``. Padding rows carry ``pg ==
    num_pages`` and land in the spare page."""
    pools[:, pg, row] = vals.to(pools.dtype)


#: numpy storage of a pool dtype for host payloads: bf16 travels as its
#: bit pattern (numpy has no bf16), every other dtype as itself
_HOST_DTYPES = {torch.float32: np.float32, torch.float16: np.float16,
                torch.bfloat16: np.uint16, torch.int8: np.int8}


def _host_dtype(dtype) -> np.dtype:
    return np.dtype(_HOST_DTYPES[dtype])


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as its host payload array (bf16 as uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype) -> torch.Tensor:
    """A host payload array back as a CPU tensor of the pool's dtype."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _payload_crc(planes: dict) -> int:
    """The host tier's integrity checksum: one crc32 over every plane's
    bytes in plane-name order, taken at spill time and checked at restore
    (a corrupt stored payload must be detected, never scattered into the
    pool)."""
    crc = 0
    for name in sorted(planes):
        crc = zlib.crc32(planes[name].tobytes(), crc)
    return crc


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


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
    ``host_tier_bytes`` (0: off) sizes the host-DRAM spill tier under the
    pool (see the module docstring). ``metrics`` must be enabled: the
    read surface (hit tokens, tier counters) reads its instruments.
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
        # pages out of circulation (the fault plan's pool squeeze): out of
        # every free / available count until restored
        self._withheld: list[int] = []
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self._refcount = np.zeros((self.num_pages,), np.int32)
        self._page_key: dict[int, bytes] = {}      # page -> chain key
        self._prefix_pages: dict[bytes, int] = {}  # chain key -> page
        self._lru: OrderedDict[int, None] = OrderedDict()
        # the host tier: chain key -> (ntok, host planes, nbytes, crc32),
        # LRU-ordered under the byte budget (0: off, evictions drop)
        self.host_tier_limit = int(host_tier_bytes or 0)
        if self.host_tier_limit < 0:
            raise ValueError(
                f"host_tier_bytes must be >= 0, got {host_tier_bytes}")
        self._host_tier: OrderedDict[
            bytes, tuple[int, dict, int, int]] = OrderedDict()
        self._host_tier_nbytes = 0
        # per registered page, its real token count: a partial tail spills
        # exactly its fill
        self._page_ntok: dict[int, int] = {}
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if not self.metrics.enabled:
            raise ValueError(
                "KVCacheManager requires an enabled metrics registry; "
                "the one passed is disabled")
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
        self._m_withheld = m.gauge(
            "kv_pages_withheld", "pages withheld from circulation")
        # the host tier's instruments exist with or without a tier, so the
        # flat snapshot has one schema
        self._m_tier_pages = m.gauge(
            "kv_tier_pages", "page payloads held in the host tier")
        self._m_tier_bytes = m.gauge("kv_tier_bytes",
                                     "host-tier bytes in use")
        self._m_tier_spills = m.counter(
            "kv_tier_spills", "evicted pages spilled to the host tier")
        self._m_tier_spill_bytes = m.counter(
            "kv_tier_spill_bytes", "payload bytes spilled to the host tier")
        self._m_tier_restores = m.counter(
            "kv_tier_restores", "host-tier pages landed back in the pool")
        self._m_tier_restore_bytes = m.counter(
            "kv_tier_restore_bytes", "payload bytes restored from the tier")
        self._m_tier_lookups = m.counter(
            "kv_tier_lookups", "chain links probed against the host tier")
        self._m_tier_hits = m.counter(
            "kv_tier_hits", "host-tier probes that returned a verified "
            "payload")
        self._m_tier_evictions = m.counter(
            "kv_tier_evictions", "host-tier entries dropped by its own LRU")
        self._m_tier_spill_drops = m.counter(
            "kv_tier_spill_drops", "spills lost at the host_spill_drop seam")
        self._m_tier_corrupt = m.counter(
            "kv_tier_restore_corrupt", "host-tier payloads the restore "
            "checksum rejected (detected, dropped, recomputed)")
        self._m_restore_scatters = m.counter(
            "kv_tier_restore_device_calls", "device scatters issued by "
            "batched imports (one a plane a round)")
        self._m_payload_syncs = m.counter(
            "kv_tier_payload_syncs", "stream waits of page payload reads "
            "to the host (a spill waits for every step in flight)")
        self._note_occupancy()

    def _note_occupancy(self) -> None:
        self._m_pages_free.set(len(self._free_pages))
        self._m_pages_evictable.set(len(self._lru))
        self._m_slots_free.set(len(self._free_slots))
        self._m_withheld.set(len(self._withheld))
        self._m_tier_pages.set(len(self._host_tier))
        self._m_tier_bytes.set(self._host_tier_nbytes)

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

    @property
    def withheld_page_count(self) -> int:
        return len(self._withheld)

    def pages_needed(self, length: int) -> int:
        return pages_needed(length, self.page_size)

    def can_admit(self, prompt_len: int) -> bool:
        return (bool(self._free_slots)
                and prompt_len <= self.max_seq_len
                and self.pages_needed(prompt_len)
                <= self.available_page_count)

    def _alloc_page(self) -> int:
        """The free list first, then evict the LRU tail of the zero-ref
        registered pages (unregistering it; its payload spills to the
        host tier first)."""
        if self._free_pages:
            return self._free_pages.pop()
        if self._lru:
            self._evict_lru_tail()
            return self._free_pages.pop()
        raise RuntimeError("cache exhausted: no free or evictable pages")

    def _evict_lru_tail(self) -> None:
        """Evict the oldest zero-ref registered page down the ladder: its
        payload spills to the host tier (when one is on), its key leaves
        the registry, the page joins the free list."""
        page, _ = self._lru.popitem(last=False)   # oldest
        key = self._page_key.pop(page)
        del self._prefix_pages[key]
        self._spill_page(key, page, self._page_ntok.pop(page, 0))
        self._m_evictions.inc()
        self._free_pages.append(page)

    # -- host tier ---------------------------------------------------------

    def _spill_page(self, key: bytes, page: int, ntok: int) -> bool:
        """Spill one evicted page's payload to the host tier. Content-
        addressed: a key already resident only refreshes its recency. Host
        pressure drops the tier's own LRU head. Returns True when the
        payload is resident after the call."""
        if not self.host_tier_limit or not ntok \
                or not self.enable_prefix_cache:
            return False
        if key in self._host_tier:
            self._host_tier.move_to_end(key)
            return True
        if fault_point("host_spill_drop"):
            # a lost spill: the eviction proceeds, the tier never sees the
            # bytes (a cache-effectiveness loss, counted, never an error)
            self._m_tier_spill_drops.inc()
            return False
        planes = self.read_page_payload(page, int(ntok))
        nbytes = sum(a.nbytes for a in planes.values())
        if nbytes > self.host_tier_limit:
            return False
        while self._host_tier_nbytes + nbytes > self.host_tier_limit:
            self._drop_tier_entry(next(iter(self._host_tier)))
            self._m_tier_evictions.inc()
        self._host_tier[key] = (int(ntok), planes, nbytes,
                                _payload_crc(planes))
        self._host_tier_nbytes += nbytes
        self._m_tier_spills.inc()
        self._m_tier_spill_bytes.inc(nbytes)
        return True

    def _drop_tier_entry(self, key: bytes) -> None:
        _, _, nbytes, _ = self._host_tier.pop(key)
        self._host_tier_nbytes -= nbytes

    def reserve_import_room(self, npages: int) -> bool:
        """Refill the strictly-free list to ``npages`` by evicting LRU-tail
        zero-ref pages down the ladder (each spills first). The landing
        zones themselves never evict; this is the room-making step a
        restore round runs first. ``available_page_count`` is unchanged
        (pages move from the evictable rung to the free one). Returns
        True when the room exists after the call."""
        npages = int(npages)
        while len(self._free_pages) < npages and self._lru:
            self._evict_lru_tail()
        self._note_occupancy()
        return len(self._free_pages) >= npages

    def _tier_lookup(self, key: bytes):
        """Probe the host tier for one chain key and verify the stored
        checksum before handing the payload out; the
        ``tier_restore_corrupt`` seam flips a stored byte first, and the
        mismatch drops the entry (counted) and reads as a miss. Returns
        ``(ntok, planes)`` or None."""
        self._m_tier_lookups.inc()
        ent = self._host_tier.get(key)
        if ent is None:
            return None
        ntok, planes, nbytes, crc = ent
        if fault_point("tier_restore_corrupt"):
            flat = planes[min(planes)].reshape(-1).view(np.uint8)
            flat[flat.shape[0] // 2] ^= 0xFF
        if _payload_crc(planes) != crc:
            self._drop_tier_entry(key)
            self._m_tier_corrupt.inc()
            return None
        self._host_tier.move_to_end(key)
        self._m_tier_hits.inc()
        return ntok, planes

    def _tier_restore(self, tokens) -> int:
        """Walk ``tokens``'s chain and land back every link the device
        registry lost but the host tier holds, so the match or export walk
        that follows sees them as registered pages. The walk mirrors
        :meth:`_match_prefix` (full pages in chain order, then the longest
        partial tail), touches this chain's device-resident links to the
        LRU's young end (the room-making must not evict them), makes room
        down the ladder and lands the round through
        :meth:`import_prefix_pages`; under true pressure a prefix of the
        round lands and the rest stays in the tier. Restored entries stay
        in the tier. Returns the pages restored."""
        if not self.host_tier_limit or not self._host_tier:
            return 0
        ps = self.page_size
        n = len(tokens)
        entries: list[tuple[bytes, int, dict]] = []
        pos = 0
        h = b""
        while pos + ps <= n:
            nxt = chain_key(h, tokens[pos:pos + ps])
            if nxt in self._prefix_pages:
                page = self._prefix_pages[nxt]
                if page in self._lru:
                    self._lru.move_to_end(page)
            else:
                ent = self._tier_lookup(nxt)
                if ent is None:
                    break
                entries.append((nxt, ent[0], ent[1]))
            pos += ps
            h = nxt
        for t in range(min(ps - 1, n - pos), 0, -1):
            nxt = chain_key(h, tokens[pos:pos + t])
            if nxt in self._prefix_pages:
                break                      # a deeper device tail wins
            ent = self._tier_lookup(nxt)
            if ent is not None:
                entries.append((nxt, ent[0], ent[1]))
                break
        if not entries:
            return 0
        self.reserve_import_room(len(entries))
        restored = 0
        for (_, _, planes), status in zip(
                entries, self.import_prefix_pages(entries)):
            if status == "imported":
                restored += 1
                self._m_tier_restores.inc()
                self._m_tier_restore_bytes.inc(
                    sum(a.nbytes for a in planes.values()))
        return restored

    @property
    def host_tier_page_count(self) -> int:
        return len(self._host_tier)

    @property
    def host_tier_bytes_used(self) -> int:
        return int(self._host_tier_nbytes)

    @property
    def host_tier_occupancy(self) -> float:
        """The host tier's byte budget in use, 0..1 (0.0 with no tier)."""
        if not self.host_tier_limit:
            return 0.0
        return self._host_tier_nbytes / self.host_tier_limit

    @property
    def tier_hit_rate(self) -> float:
        """The share of host-tier probes that returned a verified payload
        (0.0 before any probe)."""
        lookups = int(self._m_tier_lookups.value)
        if not lookups:
            return 0.0
        return int(self._m_tier_hits.value) / lookups

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

    def withhold_pages(self, n: int) -> int:
        """Take up to ``n`` strictly-free pages out of circulation until
        :meth:`restore_withheld` (the fault plan's pool squeeze). One
        holder: ``restore_withheld`` returns all of them. Referenced and
        prefix-LRU pages are never taken. Returns how many were
        withheld."""
        take = min(max(0, int(n)), len(self._free_pages))
        for _ in range(take):
            self._withheld.append(self._free_pages.pop())
        if take:
            self._note_occupancy()
        return take

    def restore_withheld(self) -> int:
        """Every withheld page back to the free list, in the order that
        restores the pre-withhold pops. Returns how many came back."""
        n = len(self._withheld)
        while self._withheld:
            self._free_pages.append(self._withheld.pop())
        if n:
            self._note_occupancy()
        return n

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
        if self.enable_prefix_cache:
            # the chain's host-tier survivors land back first, so the match
            # walk pins them like never-evicted pages (cache state only:
            # free pages move to the LRU, the availability counts hold)
            self._tier_restore(tokens)
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
                self._page_ntok[page] = t
            pos += t
            i += 1

    @property
    def prefix_hit_rate(self) -> float:
        if not self.prefix_query_tokens:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_query_tokens

    # -- page payloads: export, import ---------------------------------------
    #
    # A page travels addressed by its chain key: another manager (a replica
    # of the same build) lands it as a zero-ref registered LRU page, and
    # its next admission pins it like a page it prefilled itself.

    def prefix_page_records(self, tokens):
        """The chain-keyed export walk: every registered page holding a
        prefix of ``tokens`` (full pages, then the longest registered
        partial tail) as ``(chain_key, page, ntok)`` in chain order, with
        no ``n - 1`` feed cap (the receiver's admission applies it). Stops
        at the first unregistered link. Host-tier survivors land back
        first, so an export reaches through the tier."""
        if self.enable_prefix_cache:
            self._tier_restore(tokens)
        ps = self.page_size
        n = len(tokens)
        recs: list[tuple[bytes, int, int]] = []
        pos = 0
        h = b""
        while pos + ps <= n:
            nxt = chain_key(h, tokens[pos:pos + ps])
            page = self._prefix_pages.get(nxt)
            if page is None:
                break
            recs.append((nxt, page, ps))
            pos += ps
            h = nxt
        for t in range(min(ps - 1, n - pos), 0, -1):
            nxt = chain_key(h, tokens[pos:pos + t])
            page = self._prefix_pages.get(nxt)
            if page is not None:
                recs.append((nxt, page, t))
                break
        return recs

    def pin_page(self, page: int) -> None:
        """One more reference on ``page`` (an export in flight keeps its
        source page from eviction); balanced by :meth:`unpin_page`."""
        if self._refcount[page] == 0:
            self._lru.pop(page, None)
        self._refcount[page] += 1
        self._note_occupancy()

    def unpin_page(self, page: int) -> None:
        self._release_page(page)
        self._note_occupancy()

    def read_page_payload(self, page: int, ntok: int) -> dict:
        """One page's payload on the host: the first ``ntok`` token rows of
        every layer's K and V (``"k"`` / ``"v"`` ``[L, ntok, kv_heads,
        head_dim]``), and with an int8 pool the scale planes (``"ks"`` /
        ``"vs"`` ``[L, ntok, kv_heads]``), as numpy arrays (bf16 as its
        uint16 bits). On a CUDA device the copies are queued on the
        current stream and the call waits for it: every step dispatched
        before has run (counted on ``kv_tier_payload_syncs``)."""
        planes = {"k": self.k_pool[:, page, :ntok],
                  "v": self.v_pool[:, page, :ntok]}
        if self.quantize_kv:
            planes["ks"] = self.k_scales[:, page, :ntok]
            planes["vs"] = self.v_scales[:, page, :ntok]
        if self.device.type == "cuda":
            host = {n: t.to("cpu", non_blocking=True)
                    for n, t in planes.items()}
            torch.cuda.current_stream(self.device).synchronize()
            self._m_payload_syncs.inc()
        else:
            host = {n: t.clone() for n, t in planes.items()}
        return {n: _to_host(t) for n, t in host.items()}

    def import_prefix_page(self, key: bytes, ntok: int, payload: dict):
        """Land one page: take a strictly-free page, write the payload
        rows into it in place, register ``key`` and park the page zero-ref
        on the LRU. Returns ``"imported"``, ``"present"`` (the key is
        registered already: a re-delivery is a no-op) or ``None`` when no
        page is strictly free (an import never evicts). Geometry or dtype
        mismatches raise. :meth:`import_prefix_pages` lands a whole round
        in one scatter a plane; this per-page path is its oracle."""
        if not self.enable_prefix_cache:
            raise RuntimeError(
                "import_prefix_page needs enable_prefix_cache=True "
                "(imported pages land in the prefix registry)")
        if key in self._prefix_pages:
            return "present"
        self._validate_import(ntok, payload)
        if not self._free_pages:
            return None
        page = self._free_pages.pop()
        self._refcount[page] = 0
        for name, pool in zip(("k", "v", "ks", "vs"), self.pools()):
            pool[:, page, :ntok] = _from_host(payload[name], pool.dtype).to(
                self.device)
        self._page_key[page] = key
        self._prefix_pages[key] = page
        self._page_ntok[page] = int(ntok)
        self._lru[page] = None                 # young end, zero-ref
        self._note_occupancy()
        return "imported"

    def _validate_import(self, ntok: int, payload: dict) -> None:
        """The landing zones' geometry and dtype gate (both paths).
        Mismatches are configuration errors between managers that must be
        built alike: they raise."""
        if not (0 < int(ntok) <= self.page_size):
            raise ValueError(
                f"ntok must be in (0, {self.page_size}], got {ntok}")
        want = {"k", "v"} | ({"ks", "vs"} if self.quantize_kv else set())
        if set(payload) != want:
            raise ValueError(
                f"payload planes {sorted(payload)} do not match this "
                f"pool's {sorted(want)} (fp and int8-KV managers must be "
                "built alike)")
        shape = (self.num_layers, int(ntok), self.num_kv_heads,
                 self.head_dim)
        kv = _host_dtype(self.k_pool.dtype)
        for name in ("k", "v"):
            a = payload[name]
            if tuple(a.shape) != shape or a.dtype != kv:
                raise ValueError(
                    f"plane '{name}' is {a.dtype}{tuple(a.shape)}, "
                    f"expected {kv}{shape}")
        if self.quantize_kv:
            for name in ("ks", "vs"):
                a = payload[name]
                if tuple(a.shape) != shape[:3] or a.dtype != np.float32:
                    raise ValueError(
                        f"plane '{name}' is {a.dtype}{tuple(a.shape)}, "
                        f"expected float32{shape[:3]}")

    def import_prefix_pages(self, entries):
        """The batched landing zone: land a round of ``(key, ntok,
        payload)`` entries with ONE in-place scatter a plane
        (:func:`batched_import_rows_`) into the pools the captured step
        binds (their addresses do not change). Registration is
        :meth:`import_prefix_page`'s (zero-ref LRU parking, strictly-free
        pages, idempotent re-delivery) and the landed bytes are the
        per-page path's. Every entry is validated before anything changes.
        Returns a status a entry: ``"imported"``, ``"present"`` or
        ``None`` (once the free list runs dry, every later entry)."""
        if not self.enable_prefix_cache:
            raise RuntimeError(
                "import_prefix_pages needs enable_prefix_cache=True "
                "(imported pages land in the prefix registry)")
        entries = list(entries)
        for _, ntok, payload in entries:
            self._validate_import(ntok, payload)
        statuses: list = [None] * len(entries)
        landings = []       # (entry index, key, ntok, payload, page)
        claimed: set[bytes] = set()
        for i, (key, ntok, payload) in enumerate(entries):
            if key in self._prefix_pages or key in claimed:
                statuses[i] = "present"
                continue
            if not self._free_pages:
                continue                       # stays None: pressure
            landings.append((i, key, int(ntok), payload,
                             self._free_pages.pop()))
            claimed.add(key)
        if not landings:
            return statuses
        self._scatter_landings(landings)
        for i, key, ntok, _, page in landings:
            self._refcount[page] = 0
            self._page_key[page] = key
            self._prefix_pages[key] = page
            self._page_ntok[page] = ntok
            self._lru[page] = None
            statuses[i] = "imported"
        self._note_occupancy()
        return statuses

    def _scatter_landings(self, landings) -> None:
        """Flatten a round's (page, row) destinations and land each plane
        with one scatter, queued on the current stream behind the steps
        already dispatched. The row axis pads to a power of two; padding
        rows go to the spare page ``num_pages``."""
        total = sum(ntok for _, _, ntok, _, _ in landings)
        cap = 1
        while cap < total:
            cap *= 2
        pg = np.full((cap,), self.num_pages, np.int64)
        row = np.zeros((cap,), np.int64)
        pools = dict(zip(("k", "v", "ks", "vs"), self.pools()))
        vals = {name: np.zeros((self.num_layers, cap)
                               + tuple(pool.shape[3:]),
                               _host_dtype(pool.dtype))
                for name, pool in pools.items()}
        off = 0
        for _, _, ntok, payload, page in landings:
            pg[off:off + ntok] = page
            row[off:off + ntok] = np.arange(ntok)
            for name in vals:
                vals[name][:, off:off + ntok] = payload[name]
            off += ntok
        cuda = self.device.type == "cuda"

        def put(a, dtype=None):
            t = _from_host(a, dtype) if dtype is not None \
                else torch.from_numpy(a)
            if cuda:
                return t.pin_memory().to(self.device, non_blocking=True)
            return t

        pg_d, row_d = put(pg), put(row)
        for name, pool in pools.items():
            batched_import_rows_(pool, put(vals[name], pool.dtype), pg_d,
                                 row_d)
            self._m_restore_scatters.inc()

    def discard_imported_prefix(self, keys) -> int:
        """Undo a failed import: unregister and free every page of
        ``keys`` still zero-ref (a page an admission pinned serves traffic
        and stays). Keys in reverse import order give the free list back
        its pre-import order. No host-tier spill: an undo leaves no trace.
        Returns the pages freed."""
        dropped = 0
        for key in keys:
            page = self._prefix_pages.get(key)
            if page is None or int(self._refcount[page]) != 0:
                continue
            del self._prefix_pages[key]
            del self._page_key[page]
            self._page_ntok.pop(page, None)
            self._lru.pop(page, None)
            self._free_pages.append(page)
            dropped += 1
        if dropped:
            self._note_occupancy()
        return dropped

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

