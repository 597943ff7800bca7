"""Speculative decoding in the port against the JAX package: the verify
rows and accept epilogue of ``build_unified_step(spec_k=)``, per-op and
mega, fp and int8 weights with int8 KV; ``KVCacheManager``'s draft
allowance and rollback; and ``ServingPredictor(spec_decode_k=)`` with the
n-gram and the model draft source, per-op and mega, sync and async.

The JAX package runs with ``use_kernel=False`` and its synchronous engine;
the port runs its plain versions on the CPU. Prompts are tiled from short
motifs, so drafts are accepted. Every greedy stream is held token for
token, to the JAX package's spec stream and to the port's spec-off stream.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu.inference import quantize as jquantize
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference import ServingPredictor
from paddle_tpu_torch.inference import kv_cache as tkv
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import (random_state,
                                             serving_params_from_jax_numpy,
                                             state_from_jax_numpy)

from test_torch_serving import TINY, _pair

V = TINY["vocab_size"]
TOL = dict(atol=1e-5, rtol=1e-5)
QUANT = dict(weight_dtype="int8", weight_quant_group_size=8)
# three lanes in eight pages of 8: the churn preempts and copies on write
KW = dict(max_batch=3, page_size=8, chunk=8, num_pages=8)


def _motifs(seed=2, lens=(9, 30, 5, 17, 30, 12)):
    """Prompts tiled from 3-token motifs; the fourth repeats the second
    (a prefix hit and a copy-on-write) and the fifth shares its start."""
    rng = np.random.RandomState(seed)
    out = [np.tile(rng.randint(0, V, 3), n // 3 + 1)[:n].tolist()
           for n in lens]
    out[3] = list(out[1])
    out[4] = out[1][:20] + out[4][:10]
    return out


def _tiny_model(**over):
    cfg = tgpt.GPTConfig(**TINY, **over)
    return state_from_jax_numpy(random_state(cfg, 3), cfg,
                                device="cpu").eval()


# ---------------------------------------------------------------------------
# the verify step
# ---------------------------------------------------------------------------


def _spec_args(lanes, b, t):
    """Packed arrays for ``lanes``: slot -> (kv_len, tokens, drafts); a
    lane's drafts follow its tokens and its first verify row is its last
    token."""
    tok_ids = np.zeros(t, np.int32)
    tok_slot = np.full(t, -1, np.int32)
    tok_pos = np.zeros(t, np.int32)
    q_lens, kv_lens = np.zeros(b, np.int32), np.zeros(b, np.int32)
    last_idx = np.full(b, t, np.int32)
    spec_len, emit = np.zeros(b, np.int32), np.zeros(b, np.int32)
    w = 0
    for slot, (kv_len, toks, drafts) in sorted(lanes.items()):
        row = list(toks) + list(drafts)
        n = len(row)
        tok_ids[w:w + n] = row
        tok_slot[w:w + n] = slot
        tok_pos[w:w + n] = np.arange(kv_len, kv_len + n)
        q_lens[slot], kv_lens[slot] = n, kv_len
        last_idx[slot] = w + len(toks) - 1
        spec_len[slot], emit[slot] = len(drafts), 1
        w += n
    return (tok_ids, tok_slot, tok_pos, q_lens, kv_lens, last_idx, spec_len,
            np.zeros(t, np.int32), np.zeros(b, np.int32), emit,
            np.zeros(b, np.int32))


def _pools(cfg, num_pages, ps, kv_quant):
    shape = (cfg.num_layers, num_pages, ps, cfg.num_heads, cfg.head_dim)
    ext = (shape[0], num_pages + 1) + shape[2:]
    if kv_quant:
        return ([jnp.zeros(shape, jnp.int8) for _ in range(2)]
                + [jnp.zeros(shape[:4], jnp.float32) for _ in range(2)],
                [torch.zeros(ext, dtype=torch.int8) for _ in range(2)]
                + [torch.zeros(ext[:4]) for _ in range(2)])
    return ([jnp.zeros(shape, jnp.float32) for _ in range(2)],
            [torch.zeros(ext) for _ in range(2)])


def _held(got, want):
    got = got.numpy()
    want = np.asarray(want)
    got = got[:, :want.shape[1]]
    assert got.dtype == want.dtype
    if want.dtype == np.int8:      # as tests/test_torch_mega_decode.py
        diff = np.abs(got.astype(np.int32) - want)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8w-int8kv"])
@pytest.mark.parametrize("mega", [False, True], ids=["per-op", "mega"])
def test_spec_step_matches_jax(mega, quant):
    """Two steps at ``spec_k`` 2: prefill chunks, then two decode lanes
    with 2 and 1 drafts (the first draft the greedy token, so it is
    accepted) beside a prefill chunk. ``out_ids``, ``n_emit`` and
    ``next_toks`` equal the JAX step's; logits and pools agree."""
    jm, _ = _pair(seed=5)
    cfg = tgpt.GPTConfig(**TINY)
    ps, chunk, b, num_pages, k = 4, 4, 3, 8, 2
    t = b * (1 + k) + chunk
    jparams = jgpt.serving_params(jm)
    if quant:
        jparams = jquantize.quantize_serving_params(jparams, "int8", 8)
    tparams = serving_params_from_jax_numpy(
        jax_tree_numpy(jparams), device="cpu")
    jstep = jgpt.build_unified_step(jgpt.GPTConfig(**TINY), ps, chunk,
                                    use_kernel=False, kv_quant=quant,
                                    spec_k=k, mega=mega)
    tstep = tgpt.build_unified_step(cfg, ps, chunk, kv_quant=quant,
                                    spec_k=k, mega=mega)
    jpools, tpools = _pools(cfg, num_pages, ps, quant)
    pt = np.array([[0, 1, 2], [3, 4, -1], [5, 6, -1]], np.int32)
    no_cow = np.full(b, num_pages, np.int32)

    def targs(lanes, tpools):
        return (tparams,
                *(torch.from_numpy(a) for a in _spec_args(lanes, b, t)),
                *tpools, torch.from_numpy(pt), torch.from_numpy(no_cow),
                torch.from_numpy(no_cow), torch.zeros(b, dtype=torch.int64),
                torch.zeros(b), torch.zeros(b, dtype=torch.int32),
                torch.ones(b))

    def run(lanes, jpools, tpools):
        arrays = _spec_args(lanes, b, t)
        jres = jstep(jparams, *(jnp.asarray(a) for a in arrays), *jpools,
                     jnp.asarray(pt), jnp.asarray(no_cow),
                     jnp.asarray(no_cow), jnp.zeros((b, 2), jnp.uint32),
                     jnp.zeros(b, jnp.float32), jnp.zeros(b, jnp.int32),
                     jnp.ones(b, jnp.float32))
        return jres, tstep(*targs(lanes, tpools))

    first = {0: (0, [5, 6, 7, 8], []), 1: (0, [9, 10, 11], [])}
    jres, tres = run(first, jpools, tpools)
    jpools, tpools = list(jres[4:]), list(tres[4:])
    # row 0 does not read the drafts: probe it on copies, then draft
    probe = {0: (4, [12], [0, 0]), 1: (3, [13], [0]), 2: (0, [1, 2, 3], [])}
    jp, _ = run(probe, [jnp.array(p, copy=True) for p in jpools],
                [p.clone() for p in tpools])
    d0 = int(np.asarray(jp[0])[0, 0])
    d1 = int(np.asarray(jp[0])[1, 0])
    second = {0: (4, [12], [d0, (d0 + 1) % V]), 1: (3, [13], [d1]),
              2: (0, [1, 2, 3], [])}
    before = [p.clone() for p in tpools]
    jres, tres = run(second, jpools, tpools)
    for res in (jres, tres):
        assert [int(x) for x in np.asarray(res[1])] == [2, 2, 1]
    for got, want in zip(tres[:3], jres[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tres[3].numpy(), np.asarray(jres[3]), **TOL)
    for got, want in zip(tres[4:], jres[4:]):
        _held(got, want)
    # every verify row's logits (the checks' form): row 0 is the step's,
    # and each row's argmax is its greedy token
    rows = tstep.eager(*targs(second, before), all_rows=True)
    assert rows[3].shape == (b, k + 1, V)
    for got, want in zip(rows[:3], tres[:3]):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(rows[3][:, 0].numpy(), tres[3].numpy())
    np.testing.assert_array_equal(rows[3].argmax(-1).numpy(),
                                  tres[0].numpy())


def jax_tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_spec_step_samples_row_j_at_produced_plus_j():
    """A sampled lane's verify row j draws the uniform of ``produced + j``:
    its tokens equal the plain step's at ``produced``, ``produced + 1``,
    ... fed the same rows."""
    _, tm = _pair(seed=5)
    cfg = tgpt.GPTConfig(**TINY)
    params = tgpt.serving_params(tm)
    ps, chunk, b, num_pages = 4, 8, 2, 6
    t = b * 3 + chunk
    spec = tgpt.build_unified_step(cfg, ps, chunk, spec_k=2)
    plain = tgpt.build_unified_step(cfg, ps, chunk)
    pt = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    no_cow = torch.full((b,), num_pages, dtype=torch.int32)
    samp = (torch.tensor([7, 11]), torch.full((b,), 0.9),
            torch.tensor([20, 0], dtype=torch.int32),
            torch.tensor([1.0, 0.8]))
    ctx = [[5, 6, 7, 8, 9], [4, 3, 2, 1, 9]]
    pools = [torch.zeros(cfg.num_layers, num_pages + 1, ps, cfg.num_heads,
                         cfg.head_dim) for _ in range(2)]
    lanes = {s: (0, c, [2, 3]) for s, c in enumerate(ctx)}
    arrays = list(_spec_args(lanes, b, t))
    arrays[-1] = np.array([4, 9], np.int32)          # produced
    out = spec(params, *(torch.from_numpy(a) for a in arrays),
               *[p.clone() for p in pools], torch.from_numpy(pt), no_cow,
               no_cow, *samp)[0]
    for j in range(3):
        rows = {s: (0, c + [2, 3][:j], []) for s, c in enumerate(ctx)}
        a = list(_spec_args(rows, b, t))
        del a[6]                                      # no spec_len
        a[-1] = np.array([4 + j, 9 + j], np.int32)
        got = plain(params, *(torch.from_numpy(x) for x in a),
                    *[p.clone() for p in pools], torch.from_numpy(pt),
                    no_cow, no_cow, *samp)[0]
        assert got.tolist() == out[:, j].tolist()


# ---------------------------------------------------------------------------
# page accounting
# ---------------------------------------------------------------------------


def test_draft_allowance_and_trim_match_jax_under_churn():
    """The same random admissions, draft claims, partial accepts, trims,
    rollbacks and frees on the port's and the JAX package's managers: the
    same allowances, page needs, trimmed counts, page tables and free
    lists; trimming the rejected drafts leaves the free list a
    never-speculated manager's."""
    kw = dict(num_pages=20, max_batch=4, max_seq_len=64, page_size=4)
    tm = tkv.KVCacheManager(1, 1, 4, device="cpu",
                            enable_prefix_cache=True, **kw)
    jm = jkv.KVCacheManager(1, 1, 4, enable_prefix_cache=True, **kw)
    plain = tkv.KVCacheManager(1, 1, 4, device="cpu",
                               enable_prefix_cache=True, **kw)
    rng = np.random.RandomState(5)
    slots = []
    for _ in range(300):
        op = rng.randint(4)
        if op == 0 and len(slots) < 4:
            ctx = rng.randint(0, 5, rng.randint(2, 12)).tolist()
            hits = [m.admit_prefix(ctx, soft=True) for m in (tm, jm, plain)]
            assert hits[0] == hits[1] == hits[2]
            if hits[0] is not None:
                # the prompt's prefill landed: a decode lane
                slots.append(hits[0][0])
                for m in (tm, jm, plain):
                    m.advance(hits[0][0], len(ctx) - 1 - hits[0][1])
        elif op == 1 and slots:
            s = slots[rng.randint(len(slots))]
            reserve = int(rng.randint(3))
            allow = [m.draft_allowance(s, reserve=reserve) for m in (tm, jm)]
            need = [m.plain_step_page_need(s, 1) for m in (tm, jm)]
            assert allow[0] == allow[1] and need[0] == need[1]
            w = tm.seq_len(s)
            k = min(allow[0], 4)
            grew = [m.ensure_capacity(s, w + 1 + k) for m in (tm, jm)]
            assert grew[0] == grew[1]
            if not grew[0]:
                continue
            plain.ensure_capacity(s, w + 1 + 0)
            acc = int(rng.randint(k + 1))
            for m in (tm, jm, plain):
                m.advance(s, 1 + acc)
            plain.ensure_capacity(s, w + 1 + acc)
            assert tm.trim_pages(s) == jm.trim_pages(s)
        elif op == 2 and slots:
            s = slots[rng.randint(len(slots))]
            to = int(rng.randint(tm.seq_len(s) + 1))
            assert tm.rollback(s, to) == jm.rollback(s, to)
            plain.rollback(s, to)
        elif op == 3 and slots:
            s = slots.pop(rng.randint(len(slots)))
            for m in (tm, jm, plain):
                m.free(s)
        np.testing.assert_array_equal(tm._page_table, jm._page_table)
        assert tm._free_pages == jm._free_pages
        assert tm._free_pages == plain._free_pages
    assert tm.metrics.snapshot_flat()["kv_pages_trimmed"] > 0
    s = tm.admit_prefix([1, 2, 3], soft=True)
    if s is not None:
        with pytest.raises(ValueError, match="past slot"):
            tm.rollback(s[0], 4)


# ---------------------------------------------------------------------------
# the predictor
# ---------------------------------------------------------------------------

TELEMETRY = ("serving_draft_proposed", "serving_draft_accepted",
             "serving_draft_rollback_pages", "serving_spec_lane_steps",
             "serving_spec_tokens_emitted", "serving_preemptions",
             "kv_cow_copies", "kv_prefix_hit_tokens", "kv_pages_trimmed")


def _source(source):
    return (dict(draft_source="model", draft_layers=1) if source == "model"
            else {})


def _spec(model, k, source, **kw):
    return ServingPredictor(model, device="cpu", spec_decode_k=k,
                            **_source(source), **{**KW, **kw})


def _check_drained(sp):
    """Nothing of speculation outlives the requests: pages, proposers and
    draft lanes."""
    assert sp.cache.available_page_count == sp.cache.num_pages
    assert not sp._drafts
    if sp._draft_engine is not None:
        eng = sp._draft_engine
        assert not eng._lanes
        assert eng.cache.available_page_count == eng.cache.num_pages


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("source", ["ngram", "model"])
def test_spec_streams_match_jax_and_spec_off(source, k):
    """The churn (a prefix hit, copy-on-write, preemptions) served with
    speculation: the JAX package's synchronous spec engine and the port,
    per-op and mega, sync and async, all give the port's spec-off greedy
    streams; the sync per-op port run counts what the JAX run counts; one
    capture of the verify step."""
    jm, tm = _pair()
    prompts = _motifs()
    off = ServingPredictor(tm, device="cpu", async_engine=False,
                           **KW).generate(prompts, 10)
    assert all(off) and len({t for s in off for t in s}) > 3
    jsp = JaxPredictor(jm, use_kernel=False, async_engine=False,
                       spec_decode_k=k, **_source(source), **KW)
    want = jsp.generate(prompts, 10)
    assert all(want) and want == off
    jt = jsp.telemetry()
    assert jt["serving_preemptions"] > 0 and jt["kv_prefix_hit_tokens"] > 0
    assert jt["kv_cow_copies"] > 0 or source == "model"
    for mega in (False, True):
        for engine in ("sync", "async"):
            sp = _spec(tm, k, source, mega_decode=mega,
                       async_engine=engine == "async")
            assert sp.token_budget == KW["max_batch"] * (1 + k) + KW["chunk"]
            assert sp.generate(prompts, 10) == off, (mega, engine)
            assert sp.decode_trace_count == 1
            _check_drained(sp)
            if engine == "sync" and not mega:
                tt = sp.telemetry()
                for key in TELEMETRY:
                    assert tt[key] == jt[key], key
                assert sp.spec_accepted > 0
                assert sp.accepted_tokens_per_step > 1.0
                assert 0.0 < sp.draft_acceptance_rate <= 1.0
                assert 0.0 < sp.spec_accept_ema <= 1.0
            if source == "model":
                # the catch-up step and one chain per length the rounds ran
                assert 2 <= sp.draft_trace_count <= 1 + k
                assert sp.telemetry()["serving_draft_model_steps"] > 0


@pytest.mark.parametrize("source", ["ngram", "model"])
def test_spec_quantized_streams_match_jax_and_spec_off(source):
    """int8 g8 weights with an int8 KV cache (the draft pool int8 too): the
    JAX package's spec streams, and the port's per-op and mega, sync and
    async, equal the port's spec-off streams."""
    jm, tm = _pair(**{})
    named = random_state(tgpt.GPTConfig(**TINY), 3)
    tq = state_from_jax_numpy(named, tgpt.GPTConfig(**TINY, **QUANT),
                              device="cpu").eval()
    jm.config.weight_dtype = QUANT["weight_dtype"]
    jm.config.weight_quant_group_size = QUANT["weight_quant_group_size"]
    prompts = _motifs(seed=1)
    kv = dict(kv_cache_dtype="int8")
    off = ServingPredictor(tq, device="cpu", async_engine=False, **kv,
                           **KW).generate(prompts, 8)
    assert all(off)
    try:
        want = JaxPredictor(jm, use_kernel=False, async_engine=False,
                            spec_decode_k=3, **_source(source), **kv,
                            **KW).generate(prompts, 8)
    finally:
        jm.config.weight_dtype = None
        jm.config.weight_quant_group_size = -1
    assert want == off
    for mega in (False, True):
        for engine in ("sync", "async"):
            sp = _spec(tq, 3, source, mega_decode=mega,
                       async_engine=engine == "async", **kv)
            assert sp.generate(prompts, 8) == off, (mega, engine)
            assert sp.cache.k_pool.dtype == torch.int8
            assert sp.spec_proposed > 0
            _check_drained(sp)


@pytest.mark.parametrize("source", ["ngram", "model"])
def test_spec_sampled_streams_equal_plain(source):
    """Seeded sampling through the verify rows: the port's spec streams,
    sync and async, are the port's plain seeded streams (the reference's
    threefry streams differ from the port's by design)."""
    _, tm = _pair()
    prompts = _motifs(seed=2)
    sampling = dict(temperature=0.7, top_k=8, top_p=0.9, seed=5)
    want = ServingPredictor(tm, device="cpu", async_engine=False,
                            **KW).generate(prompts, 10, **sampling)
    for engine in ("sync", "async"):
        sp = _spec(tm, 3, source, async_engine=engine == "async")
        assert sp.generate(prompts, 10, **sampling) == want
        assert sp.spec_proposed > 0


def test_spec_validation_errors():
    """The reference's rejections, raised at construction."""
    _, tm = _pair()
    with pytest.raises(ValueError, match="unified"):
        ServingPredictor(tm, device="cpu", unified=False, spec_decode_k=2)
    with pytest.raises(ValueError, match="chunk"):
        ServingPredictor(tm, device="cpu", chunk=4, spec_decode_k=4)
    with pytest.raises(ValueError, match=">= 0"):
        ServingPredictor(tm, device="cpu", spec_decode_k=-1)
    kw = dict(device="cpu", max_batch=2, page_size=8)
    for layers in (TINY["num_layers"], TINY["num_layers"] + 3):
        with pytest.raises(ValueError, match="num_layers"):
            ServingPredictor(tm, spec_decode_k=2, draft_source="model",
                             draft_layers=layers, **kw)
    with pytest.raises(ValueError, match=">= 1"):
        ServingPredictor(tm, spec_decode_k=2, draft_source="model",
                         draft_layers=0, **kw)
    with pytest.raises(ValueError, match="draft_source"):
        ServingPredictor(tm, spec_decode_k=2, draft_source="eagle", **kw)
    with pytest.raises(ValueError, match="spec_decode_k"):
        ServingPredictor(tm, draft_source="model", draft_layers=1, **kw)
    # the config spelling: spec_draft_layers selects the model source
    tm.config.spec_draft_layers = TINY["num_layers"]
    try:
        with pytest.raises(ValueError, match="num_layers"):
            ServingPredictor(tm, spec_decode_k=2, **kw)
    finally:
        tm.config.spec_draft_layers = 0
    sp = ServingPredictor(_tiny_model(spec_decode_k=2, spec_draft_layers=1),
                          **kw)
    assert sp.spec_k == 2 and sp.draft_source == "model"
    assert ServingPredictor(tm, token_budget=5, **kw).token_budget == 5


def test_spec_async_reconciles_drafted_steps_behind_by_one():
    """In the async engine a drafted step stays in flight past its own
    ``step()`` and lands at the start of the next round; the counters
    charge the deferral, and the streams are the sync engine's."""
    _, tm = _pair()
    prompts = _motifs()
    sync = _spec(tm, 4, "ngram", async_engine=False)
    want = sync.generate(prompts, 12)
    sp = _spec(tm, 4, "ngram")
    reqs = [sp.add_request(p, 12) for p in prompts]
    behind = 0
    while sp.has_work():
        sp.step()
        behind += any(e.spec_slots for e in sp._inflight)
    sp.flush()
    assert [r.output_ids for r in reqs] == want
    assert behind > 0
    tel = sp.telemetry()
    assert tel["serving_spec_async_deferred_steps"] >= behind
    assert sp.hard_syncs <= sync.hard_syncs
    assert sp.spec_accepted == sync.spec_accepted > 0


def _spy_pool(eng):
    """Counts, on a model draft engine, the idle lanes it evicts, and the
    proposing lanes it gives no draft or a shorter draft than asked."""
    seen = dict(evicted=0, empty=0, short=0)
    evict, propose = eng._evict_one, eng.propose

    def _evict(keep):
        done = evict(keep)
        seen["evicted"] += done
        return done

    def _propose(lanes):
        out = propose(lanes)
        for key, (_, _, k) in lanes.items():
            seen["empty"] += not out[key]
            seen["short"] += 0 < len(out[key]) < k
        return out

    eng._evict_one, eng.propose = _evict, _propose
    return seen


@pytest.mark.parametrize("mega", [False, True], ids=["per-op", "mega"])
def test_model_draft_tiny_pool_stays_opportunistic(mega):
    """A draft pool too small for every lane (``draft_num_pages=4``): the
    engine evicts idle draft lanes, drops a lane it cannot grow and runs a
    shorter chain rather than failing (reference
    ``test_model_draft_tiny_pool_stays_opportunistic``). The port's
    streams, sync and async, equal its spec-off streams and the JAX
    predictor's with the same tiny pool."""
    jm, tm = _pair()
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, V, (n,)).tolist() for n in (15, 3, 9, 7)]
    kw = dict(max_batch=3, max_seq_len=48, page_size=8, chunk=8)
    spec = dict(spec_decode_k=3, draft_source="model", draft_layers=1,
                draft_num_pages=4)
    off = ServingPredictor(tm, device="cpu", async_engine=False,
                           **kw).generate(prompts, 8)
    assert all(off)
    jsp = JaxPredictor(jm, use_kernel=False, async_engine=False, **spec, **kw)
    assert jsp.generate(prompts, 8) == off
    assert jsp._draft_engine.cache.num_pages == 4
    for engine in ("sync", "async"):
        sp = ServingPredictor(tm, device="cpu", mega_decode=mega,
                              async_engine=engine == "async", **spec, **kw)
        eng = sp._draft_engine
        assert eng.cache.num_pages == 4
        seen = _spy_pool(eng)
        assert sp.generate(prompts, 8) == off, engine
        # every pressure path ran: an eviction, a lane with no draft, a
        # chain shorter than asked
        assert min(seen.values()) > 0, seen
        assert sp.spec_proposed > 0
        _check_drained(sp)
