"""Port KV cache (host manager + device scatters) against the JAX package.

One sequence of admit / prefix / CoW / grow / free operations runs on both
managers; page tables, seq lens, free and available counts, refcounts and
chain-key bytes must be equal after every operation. The packed write and
the CoW page copy, with sentinel rows, must produce equal pools.
"""
import numpy as np
import torch

import jax.numpy as jnp

from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu_torch.inference import kv_cache as tkv

GEOM = dict(num_layers=2, num_kv_heads=2, head_dim=4, num_pages=10,
            max_batch=3, max_seq_len=32, page_size=4,
            enable_prefix_cache=True)


def _assert_same(jm, tm):
    np.testing.assert_array_equal(tm._page_table, jm._page_table)
    np.testing.assert_array_equal(tm._seq_lens, jm._seq_lens)
    np.testing.assert_array_equal(tm._refcount, jm._refcount)
    assert tm.free_page_count == jm.free_page_count
    assert tm.available_page_count == jm.available_page_count
    assert tm.free_slot_count == jm.free_slot_count
    assert tm._prefix_pages == jm._prefix_pages
    assert list(tm._lru) == list(jm._lru)
    np.testing.assert_array_equal(tm.page_table_device().numpy(),
                                  np.asarray(jm.page_table_device()))


def test_manager_sequence_matches_jax():
    jm = jkv.KVCacheManager(**GEOM)
    tm = tkv.KVCacheManager(**GEOM, device="cpu")
    a = list(range(1, 11))            # 10 tokens: 2 full pages + tail of 2
    both = lambda fn: (fn(jm), fn(tm))  # noqa: E731

    ja, ta = both(lambda m: m.admit_prefix(a))
    assert ja == ta == (ja[0], 0)
    _assert_same(jm, tm)
    both(lambda m: m.advance(ja[0], len(a)))
    both(lambda m: m.register_prefix(ja[0], a))
    _assert_same(jm, tm)
    # a duplicate prompt hits every page but leaves one token to feed; its
    # first write lands in the shared tail page -> copy-on-write
    jb, tb = both(lambda m: m.admit_prefix(a, headroom=1))
    assert jb == tb == (jb[0], len(a) - 1)
    assert jm.needs_cow(jb[0], len(a) - 1) and tm.needs_cow(tb[0], len(a) - 1)
    jc, tc = both(lambda m: m.prepare_write(jb[0], len(a) - 1))
    assert jc == tc is not None
    _assert_same(jm, tm)
    # a prompt sharing two full pages, then diverging
    c = a[:8] + [50, 51, 52, 53, 54]
    jd, td = both(lambda m: m.admit_prefix(c))
    assert jd == td == (jd[0], 8)
    _assert_same(jm, tm)
    # growth, pressure, then frees (the registered pages park on the LRU)
    assert both(lambda m: m.ensure_capacity(jb[0], 16)) == (True, True)
    assert both(lambda m: m.ensure_capacity(jd[0], 32)) == (False, False)
    _assert_same(jm, tm)
    for slot in (ja[0], jb[0], jd[0]):
        both(lambda m: m.free(slot))
        _assert_same(jm, tm)
    assert tm.available_page_count == GEOM["num_pages"]
    # reuse evicts the LRU's registered pages in the same order
    big = list(range(100, 130))
    je, te = both(lambda m: m.admit_prefix(big))
    assert je == te
    _assert_same(jm, tm)
    assert tkv.chain_key(b"", a[:4]) == jkv.chain_key(b"", a[:4])
    assert tkv.prompt_chain_keys(a, 4) == jkv.prompt_chain_keys(a, 4)


def test_packed_write_and_copy_match_jax():
    rng = np.random.RandomState(0)
    num_pages, ps, hkv, d = 6, 4, 2, 3
    pages = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    pt = np.array([[2, 5, -1], [0, -1, -1]], np.int32)
    # slot 0 writes rows 2..6 (crossing into page 5), slot 1 row 1, one
    # write into an unallocated page, two padding tokens
    tok_slot = np.array([0, 0, 0, 0, 0, 1, 1, -1, -1], np.int32)
    tok_pos = np.array([2, 3, 4, 5, 6, 1, 8, 0, -1], np.int32)
    toks = rng.standard_normal((9, hkv, d)).astype(np.float32)
    want = np.asarray(jkv.paged_write_packed(
        jnp.asarray(pages), jnp.asarray(toks), jnp.asarray(pt),
        jnp.asarray(tok_slot), jnp.asarray(tok_pos), ps))
    got = tkv.paged_write_packed(
        torch.from_numpy(pages), torch.from_numpy(toks),
        torch.from_numpy(pt), torch.from_numpy(tok_slot),
        torch.from_numpy(tok_pos), ps).numpy()
    np.testing.assert_array_equal(got, want)

    stacked = rng.standard_normal((2, num_pages, ps, hkv, d)
                                  ).astype(np.float32)
    src = np.array([1, 4, 0], np.int32)
    dst = np.array([3, num_pages, num_pages], np.int32)   # 2 no-op lanes
    want = np.asarray(jkv.paged_copy_pages(jnp.asarray(stacked),
                                           jnp.asarray(src),
                                           jnp.asarray(dst)))
    got = tkv.paged_copy_pages(torch.from_numpy(stacked),
                               torch.from_numpy(src),
                               torch.from_numpy(dst)).numpy()
    np.testing.assert_array_equal(got, want)
