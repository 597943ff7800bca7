"""The KV cache's host-DRAM tier and page payload seams on the port,
against the JAX package's ``KVCacheManager``.

Spills, restores and detected corruption go step for step with the
reference manager (the same free list, LRU, registry, tier and counters
after every operation, the same seeded fault draws), and every payload is
bitwise the reference's, fp32 and int8 with its scale planes. The batched
landing zone writes in place (the pools keep their addresses) and lands
the per-page path's bytes. A served churn with a tier that spills emits
the untiered streams.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference import FaultPlan as JaxPlan
from paddle_tpu.inference import KVCacheManager as JaxManager
from paddle_tpu_torch.inference import (FaultPlan, KVCacheManager,
                                        ServingPredictor)
from paddle_tpu_torch.inference.kv_cache import batched_import_rows_

from test_torch_faults import drive, port_model, prompts

GEOM = dict(num_layers=2, num_kv_heads=2, head_dim=8, num_pages=8,
            max_batch=2, max_seq_len=32, page_size=8,
            enable_prefix_cache=True)


def managers(**kw):
    """(port, reference) managers of one geometry."""
    kw = dict(GEOM, **kw)
    return (KVCacheManager(**kw, device="cpu"),
            JaxManager(**{k: (jnp.float16 if v is torch.float16 else v)
                          for k, v in kw.items()}))


def fill(m, tokens, seed=0):
    """Admit ``tokens``, write seeded K/V rows (and scale rows on an int8
    pool), register the chain and free the slot: the zero-ref LRU state a
    finished request leaves. The same bytes land in either package."""
    slot, _ = m.admit_prefix(list(tokens))
    rng = np.random.RandomState(seed)
    n = len(tokens)
    shape = (m.num_layers, n, m.num_kv_heads, m.head_dim)
    k, v = rng.randn(*shape) * 50, rng.randn(*shape) * 50
    ks = rng.rand(*shape[:3]).astype(np.float32)
    vs = rng.rand(*shape[:3]).astype(np.float32)
    if m.quantize_kv:
        k, v = k.astype(np.int8), v.astype(np.int8)
    port = isinstance(m, KVCacheManager)
    for i in range(0, n, m.page_size):
        pg = int(m._page_table[slot, i // m.page_size])
        t = min(m.page_size, n - i)
        planes = [("k", k), ("v", v)]
        if m.quantize_kv:
            planes += [("ks", ks), ("vs", vs)]
        for name, a in planes:
            rows = a[:, i:i + t]
            if port:
                pool = dict(zip(("k", "v", "ks", "vs"), m.pools()))[name]
                pool[:, pg, :t] = torch.from_numpy(rows).to(pool.dtype)
            else:
                attr = {"k": "k_pages", "v": "v_pages", "ks": "k_scales",
                        "vs": "v_scales"}[name]
                pool = getattr(m, attr)
                setattr(m, attr, pool.at[:, pg, :t].set(
                    jnp.asarray(rows, pool.dtype)))
    m._seq_lens[slot] = n
    m.register_prefix(slot, list(tokens))
    m.free(slot)


def payloads(m, tokens):
    return {key: m.read_page_payload(page, ntok)
            for key, page, ntok in m.prefix_page_records(tokens)}


def state(m):
    """Everything the scheduler and the tier account, comparable across
    the packages."""
    counters = {k: v for k, v in m.metrics.snapshot_flat().items()
                if k.startswith("kv_")
                and k not in ("kv_tier_payload_syncs",)}
    return (list(m._free_pages), list(m._lru), dict(m._prefix_pages),
            list(m._host_tier), m.host_tier_bytes_used, counters,
            m._refcount.tolist())


def assert_same_payloads(a, b):
    assert a.keys() == b.keys() and a
    for key in a:
        assert a[key].keys() == b[key].keys()
        for name in a[key]:
            x, y = a[key][name], np.asarray(b[key][name])
            assert x.dtype == y.dtype and np.array_equal(x, y), (key, name)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_spill_and_restore_match_jax_bitwise(quant):
    """A chain (partial tail included) evicted through the tier and
    restored on the next admission: the port's payloads are the
    reference's, bit for bit, before and after, and the managers agree
    on every count at every step."""
    port, ref = managers(host_tier_bytes=1 << 20, quantize_kv=quant)
    toks = list(range(100, 120))                 # 2 full pages + tail 4
    other = list(range(300, 310))
    for m in (port, ref):
        fill(m, toks, seed=1)
        fill(m, other, seed=2)
    before = payloads(ref, toks)
    assert_same_payloads(payloads(port, toks), before)
    assert state(port) == state(ref)
    for m in (port, ref):
        assert m.reserve_import_room(m.num_pages)
    assert state(port) == state(ref)
    assert port.host_tier_page_count == 5 and not port._prefix_pages
    hits = [m.admit_prefix(toks) for m in (port, ref)]
    assert hits[0] == hits[1] and hits[0][1] == 19
    assert state(port) == state(ref)
    assert_same_payloads(payloads(port, toks), before)
    assert port.tier_hit_rate == 1.0
    assert int(port._m_tier_restore_bytes.value) == \
        int(ref._m_tier_restore_bytes.value) > 0
    for m, (slot, _) in zip((port, ref), hits):
        m.free(slot)
    assert state(port) == state(ref)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_seeded_spill_drops_and_corruption_step_for_step(quant):
    """Rounds of evict / re-admit under one seeded plan with the spill
    drop and restore corruption seams: each package draws the same
    faults, drops the same spills, detects the same corrupt entries
    (degrading to recompute misses) and ends every operation in the same
    state; no corrupt byte reaches a pool."""
    port, ref = managers(host_tier_bytes=1 << 20, quantize_kv=quant)
    chains = [list(range(b, b + 13)) for b in (0, 40, 80)]
    for m in (port, ref):
        for i, c in enumerate(chains):
            fill(m, c, seed=i)
    good = payloads(ref, chains[0])
    trail = {id(port): [], id(ref): []}

    def rounds(m, plan_cls):
        with plan_cls(seed=5, host_spill_drop=0.3,
                      tier_restore_corrupt=0.3) as plan:
            for r in range(6):
                m.reserve_import_room(m.num_pages)
                trail[id(m)].append(state(m))
                c = chains[r % 3]
                slot, hit = m.admit_prefix(c)
                trail[id(m)].append((hit, state(m)))
                m.free(slot)
        return dict(plan.fired)

    assert rounds(port, FaultPlan) == rounds(ref, JaxPlan)
    assert trail[id(port)] == trail[id(ref)]
    flat = port.metrics.snapshot_flat()
    assert flat["kv_tier_spill_drops"] > 0
    assert flat["kv_tier_restore_corrupt"] > 0
    assert flat["kv_tier_restores"] > 0
    # what a restore landed is the original bytes, never a flipped one
    for key, planes in payloads(port, chains[0]).items():
        for name, a in planes.items():
            ntok = a.shape[1]
            assert np.array_equal(a, np.asarray(good[key][name])[:, :ntok])


def test_batched_import_lands_in_place_as_the_per_page_path():
    """One scatter a plane for a whole round, into the pools the captured
    step binds (their data_ptr unchanged), bitwise the per-page landing;
    the statuses are the reference's (imported, present, pressure)."""
    for quant in (False, True):
        src, ref_src = managers(quantize_kv=quant)
        toks = list(range(500, 520))
        fill(src, toks, seed=7)
        fill(ref_src, toks, seed=7)
        entries = [(key, ntok, src.read_page_payload(page, ntok))
                   for key, page, ntok in src.prefix_page_records(toks)]
        per_page, _ = managers(quantize_kv=quant)
        assert [per_page.import_prefix_page(*e) for e in entries] \
            == ["imported"] * 3
        batched, ref = managers(quantize_kv=quant)
        ptrs = [p.data_ptr() for p in batched.pools()]
        calls = int(batched._m_restore_scatters.value)
        ref_entries = [(k, n, {a: np.asarray(b) for a, b in p.items()})
                       for k, n, p in entries]
        assert batched.import_prefix_pages(entries) \
            == ref.import_prefix_pages(ref_entries) == ["imported"] * 3
        assert [p.data_ptr() for p in batched.pools()] == ptrs
        assert int(batched._m_restore_scatters.value) - calls \
            == (4 if quant else 2)
        assert_same_payloads(payloads(batched, toks), payloads(per_page,
                                                                toks))
        assert_same_payloads(payloads(batched, toks), payloads(ref, toks))
        assert state(batched) == state(ref)
        assert batched.import_prefix_pages(entries) == ["present"] * 3
        tight, tight_ref = managers(quantize_kv=quant, num_pages=2)
        for m in (tight, tight_ref):
            fill(m, list(range(900, 916)))
        assert tight.import_prefix_pages(entries) \
            == tight_ref.import_prefix_pages(ref_entries) == [None] * 3
        assert tight.discard_imported_prefix([]) == 0
        with pytest.raises(ValueError, match="planes"):
            batched.import_prefix_pages([(b"x" * 20, 4, {"k": entries[0][2][
                "k"]})])


def test_bf16_payload_round_trip_and_scatter_helper():
    """bf16 pools travel as their uint16 bits; the scatter helper routes
    padding rows to the spare page."""
    m = KVCacheManager(**dict(GEOM, host_tier_bytes=1 << 20),
                       dtype=torch.bfloat16, device="cpu")
    toks = list(range(20))
    fill(m, toks, seed=3)
    before = payloads(m, toks)
    assert next(iter(before.values()))["k"].dtype == np.uint16
    assert m.reserve_import_room(m.num_pages) and not m._prefix_pages
    slot, hit = m.admit_prefix(toks)
    assert hit == 19
    assert_same_payloads(payloads(m, toks), before)
    pool = torch.zeros(1, 3, 2, 1)
    batched_import_rows_(pool, torch.ones(1, 4, 1), torch.tensor([0, 1, 2, 2]),
                         torch.tensor([1, 0, 0, 0]))
    assert pool[0, :, :, 0].tolist() == [[0, 1], [1, 0], [1, 0]]


def test_tier_budget_and_disabled_tier_match_jax():
    page_bytes = 2 * 2 * 8 * 2 * 8 * 4      # L * (K, V) * ps * heads * hd
    for kw in (dict(host_tier_bytes=2 * page_bytes), dict(),
               dict(host_tier_bytes=16)):
        port, ref = managers(**kw)
        for m in (port, ref):
            for i, b in enumerate((0, 50, 80)):
                fill(m, list(range(b, b + 8)), seed=i)
            m.reserve_import_room(m.num_pages)
            for b in (0, 50):
                slot, _ = m.admit_prefix(list(range(b, b + 8)))
                m.free(slot)
        assert state(port) == state(ref)
    assert port.host_tier_page_count == 0
    with pytest.raises(ValueError, match="host_tier_bytes"):
        managers(host_tier_bytes=-1)


def test_served_churn_with_a_spilling_tier_keeps_the_streams():
    """Reused prompts through a pool too small to keep their prefixes:
    with a host tier the evicted pages spill and come back (restores,
    prefix hits the untiered run misses), and every stream, fp and int8
    KV, is the untiered run's; the pools keep their addresses."""
    model = port_model()
    base = prompts(np.random.RandomState(9), 6, 30)
    pool = [p for _ in range(3) for p in base]
    for kv in (None, "int8"):
        kw = dict(max_batch=2, max_seq_len=48, page_size=8, chunk=8,
                  num_pages=10, kv_cache_dtype=kv)
        want = [list(r.output_ids) for r in drive(
            ServingPredictor(model, device="cpu", **kw), pool)]
        sp = ServingPredictor(model, device="cpu", host_tier_bytes=1 << 20,
                              **kw)
        ptrs = [p.data_ptr() for p in sp.cache.pools()]
        got = [list(r.output_ids) for r in drive(sp, pool)]
        assert any(want) and got == want
        flat = sp.telemetry()
        assert flat["kv_tier_spills"] > 0 and flat["kv_tier_restores"] > 0
        assert [p.data_ptr() for p in sp.cache.pools()] == ptrs
        assert sp.healthz()["host_tier_bytes"] == flat["kv_tier_bytes"] > 0
        assert sp.cache.available_page_count == sp.cache.num_pages
