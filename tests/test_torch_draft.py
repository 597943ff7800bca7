"""The port's draft side of speculative decoding against the JAX package:
``inference/draft.py`` (the n-gram proposer, its adaptive k, the model
draft engine) and ``models/gpt.py``'s draft builders (``draft_config``,
``draft_serving_params``, ``build_draft_step``, ``build_draft_chain``,
per-op and mega, fp and int8 KV).

The JAX programs run with ``use_kernel=False`` (the reference's Pallas
kernels cannot be traced on this jax); the port runs its plain versions
on the CPU. Draft tokens are held equal, pools within fp32 1e-5 (int8
payloads by steps, as ``tests/test_torch_mega_decode.py`` holds them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import draft as jdraft
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference import draft as tdraft
from paddle_tpu_torch.models import gpt as tgpt

from test_torch_serving import TINY, _pair

TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the n-gram proposer
# ---------------------------------------------------------------------------

# (max_k, proposer options, context, budget): the cases of the JAX
# package's tests/test_draft.py, and a long self-repetition
_rep = [int(x) for x in np.random.RandomState(0).randint(0, 50, 24)]
PROPOSE_CASES = {
    "empty": (4, {}, [], 4),
    "one token": (4, {}, [7], 4),
    "zero budget": (4, {}, [7, 8], 0),
    "negative budget": (4, {}, [7, 8], -1),
    "nothing recurs": (4, {}, [7, 8], 4),
    "continuation": (4, dict(max_ngram=3), [1, 2, 3, 50, 60, 1, 2, 3], 2),
    "most recent match": (1, dict(max_ngram=2),
                          [1, 2, 66, 9, 1, 2, 77, 9, 1, 2], 1),
    "longest n-gram": (1, dict(max_ngram=3),
                       [5, 2, 3, 88, 1, 2, 3, 99, 4, 1, 2, 3], 1),
    "period 1": (6, dict(max_ngram=3), [9, 4, 7, 7, 7], 6),
    "period 2": (6, dict(max_ngram=3), [9, 1, 2, 1, 2, 1, 2], 4),
    "budget clamps": (4, {}, [3, 7, 7, 7, 7], 2),
    "self-repetition": (4, {}, _rep + _rep[:8], 4),
}


@pytest.mark.parametrize("case", sorted(PROPOSE_CASES))
def test_proposer_matches_jax(case):
    max_k, kw, ctx, budget = PROPOSE_CASES[case]
    want = jdraft.DraftProposer(max_k, **kw).propose(ctx, budget)
    got = tdraft.DraftProposer(max_k, **kw).propose(ctx, budget)
    assert got == want
    if case in ("continuation", "period 1", "self-repetition"):
        assert got                      # the case proposes something


def test_proposer_survives_preemption_replay_like_jax():
    """A replayed context proposes the same drafts, and an index synced
    incrementally equals a fresh one's, on both sides."""
    ctx = _rep + _rep[:8]
    grown = ctx + _rep[8:12]
    for mod in (jdraft, tdraft):
        p = mod.DraftProposer(4)
        first = p.propose(ctx, 4)
        assert first and p.propose(ctx, 4) == first
        assert p.propose(grown, 4) == mod.DraftProposer(4).propose(grown, 4)
    assert (tdraft.DraftProposer(4).propose(grown, 4)
            == jdraft.DraftProposer(4).propose(grown, 4))


def test_adaptive_k_follows_jax():
    """The same outcomes drive the same k on both sides: a run of
    rejections backs k off to 0, the cooldown re-arms a probe, and full
    acceptance climbs back to max_k."""
    outcomes = ([(4, 0)] * 12 + [(0, 0)] * 3 + [(1, 1), (2, 2), (3, 3)]
                + [(4, 4)] * 6 + [(4, 1), (3, 2), (0, 0)])
    ks = {}
    for mod in (jdraft, tdraft):
        p = mod.DraftProposer(4, retry_after=3)
        trail = [p.k]
        for proposed, accepted in outcomes:
            p.update(proposed, accepted)
            trail.append(p.k)
        ks[mod] = trail
    assert ks[tdraft] == ks[jdraft]
    assert 0 in ks[tdraft] and ks[tdraft][-1] > 0 and max(ks[tdraft]) == 4


def test_proposer_validation():
    with pytest.raises(ValueError, match="max_k"):
        tdraft.DraftProposer(0)
    with pytest.raises(ValueError, match="max_ngram"):
        tdraft.DraftProposer(4, max_ngram=0)


def test_model_draft_proposer_shares_adaptive_k_surface():
    """It keeps the n-gram proposer's k / update and asks the engine; a
    backed-off proposer never calls it."""

    class FakeEngine:
        def __init__(self):
            self.calls = []

        def propose(self, lanes):
            self.calls.append(lanes)
            return {k: [1] * min(v[2], 2) for k, v in lanes.items()}

    eng = FakeEngine()
    p = tdraft.ModelDraftProposer(4, eng, 7)
    assert p.k == 4
    assert p.propose([5, 6, 7], 3) == [1, 1]
    assert eng.calls[0][0][0] == 7 and eng.calls[0][0][2] == 3
    for _ in range(12):
        p.update(4, 0)
    assert p.k == 0 and p.propose([5, 6, 7], 3) == []
    assert len(eng.calls) == 1


# ---------------------------------------------------------------------------
# the draft builders
# ---------------------------------------------------------------------------


def test_draft_config_and_params():
    cfg = tgpt.GPTConfig(**TINY, mega_decode=True, spec_decode_k=3)
    d = tgpt.draft_config(cfg, 1)
    want = jgpt.draft_config(jgpt.GPTConfig(**TINY, mega_decode=True,
                                            spec_decode_k=3), 1)
    for f in ("num_layers", "spec_decode_k", "spec_draft_layers",
              "mega_decode", "hidden_size"):
        assert getattr(d, f) == getattr(want, f), f
    for bad, match in ((0, ">= 1"), (TINY["num_layers"], "num_layers")):
        with pytest.raises(ValueError, match=match):
            tgpt.draft_config(cfg, bad)
    _, tm = _pair()
    params = tgpt.serving_params(tm)
    dp = tgpt.draft_serving_params(params, 1)
    for k in ("tok_emb", "pos_emb", "lnf_g", "lnf_b"):
        assert dp[k] is params[k]            # shared, not copied
    for k, w in dp["layers"].items():
        assert w.shape[0] == 1 and w.data_ptr() == params["layers"][
            k].data_ptr()                    # a view of the stack
    step = tgpt.build_draft_step(cfg, 1, 8, 4)
    assert step.config.num_layers == 1 and not step.mega and not step.spec_k


def _chain_inputs(rng, cfg, kv_quant, b=3, ps=4, pps=3):
    """Draft pools for one layer holding random K / V at a mid-context
    lane, a deeper lane and an idle lane (steps 0), pages reserved."""
    num_pages = b * pps
    shape = (1, num_pages, ps, cfg.num_heads, cfg.head_dim)
    if kv_quant:
        pools = [rng.randint(-127, 128, shape).astype(np.int8),
                 rng.randint(-127, 128, shape).astype(np.int8),
                 (rng.rand(*shape[:4]) * 0.02).astype(np.float32),
                 (rng.rand(*shape[:4]) * 0.02).astype(np.float32)]
    else:
        pools = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    pt = np.arange(num_pages, dtype=np.int32).reshape(b, pps)
    kv0 = np.array([5, 2, 0], np.int32)
    first = rng.randint(0, TINY["vocab_size"], b).astype(np.int32)
    return pools, pt, kv0, first


def _port_pools(pools):
    """The port's pools carry a spare page at index ``num_pages``."""
    out = []
    for p in pools:
        t = torch.from_numpy(p)
        out.append(torch.cat([t, torch.zeros_like(t[:, :1])], dim=1))
    return out


@pytest.mark.parametrize("mega", [False, True], ids=["per-op", "mega"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8kv"])
def test_draft_chain_matches_jax(mega, kv_quant):
    """``build_draft_chain`` at k 3 with ragged per-lane steps (3, 2, 0):
    the drafts equal the JAX chain's, the pools agree, the idle lane
    drafts zeros and writes nothing."""
    jm, tm = _pair(seed=7)
    cfg = tgpt.GPTConfig(**TINY)
    rng = np.random.RandomState(2)
    pools, pt, kv0, first = _chain_inputs(rng, cfg, kv_quant)
    steps = np.array([3, 2, 0], np.int32)
    jparams = jgpt.draft_serving_params(jgpt.serving_params(jm), 1)
    tparams = tgpt.draft_serving_params(tgpt.serving_params(tm), 1)
    jfn = jgpt.build_draft_chain(jgpt.GPTConfig(**TINY), 1, 4, 3,
                                 use_kernel=False, kv_quant=kv_quant,
                                 mega=mega)
    tfn = tgpt.build_draft_chain(cfg, 1, 4, 3, kv_quant=kv_quant, mega=mega)
    jres = jfn(jparams, jnp.asarray(first), jnp.asarray(steps),
               jnp.asarray(kv0), *(jnp.asarray(p) for p in pools),
               jnp.asarray(pt))
    tp = _port_pools(pools)
    tres = tfn(tparams, torch.from_numpy(first), torch.from_numpy(steps),
               torch.from_numpy(kv0), *tp, torch.from_numpy(pt))
    drafts = tres[0].numpy()
    np.testing.assert_array_equal(drafts, np.asarray(jres[0]))
    assert drafts.dtype == np.int32 and not drafts[2].any()
    assert len(set(drafts[:2].ravel().tolist())) > 1
    n = pt.size
    for got, want, raw in zip(tres[1:], jres[1:], pools):
        got, want = got[:, :n].numpy(), np.asarray(want)
        if want.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want)
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        else:
            np.testing.assert_allclose(got, want, **TOL)
        # the idle lane's pages are untouched
        np.testing.assert_array_equal(got[:, pt[2]], raw[:, pt[2]])
    assert tfn.trace_count == 1            # one geometry (CPU: it ran)


def test_draft_chain_is_per_step_chain():
    """The k-step chain equals k one-step chains fed each other's tokens
    on the same pools (the reference's chain contract)."""
    _, tm = _pair(seed=7)
    cfg = tgpt.GPTConfig(**TINY)
    rng = np.random.RandomState(4)
    pools, pt, kv0, first = _chain_inputs(rng, cfg, False)
    steps = np.array([3, 1, 0], np.int32)
    params = tgpt.draft_serving_params(tgpt.serving_params(tm), 1)
    full = tgpt.build_draft_chain(cfg, 1, 4, 3)(
        params, torch.from_numpy(first), torch.from_numpy(steps),
        torch.from_numpy(kv0), *_port_pools(pools), torch.from_numpy(pt))
    one = tgpt.build_draft_chain(cfg, 1, 4, 1)
    tp, ids, per_step = _port_pools(pools), first.copy(), []
    for j in range(3):
        active = steps > j
        d = one(params, torch.from_numpy(ids),
                torch.from_numpy(active.astype(np.int32)),
                torch.from_numpy(kv0 + j), *tp, torch.from_numpy(pt))[0]
        d = d.numpy()[:, 0]
        per_step.append(np.where(active, d, 0))
        ids = np.where(active, d, ids).astype(np.int32)
    np.testing.assert_array_equal(full[0].numpy(), np.stack(per_step, 1))
    for a, b in zip(full[1:], tp):
        assert torch.equal(a, b)


def test_draft_chain_validation():
    cfg = tgpt.GPTConfig(**TINY)
    with pytest.raises(ValueError, match="k must be"):
        tgpt.build_draft_chain(cfg, 1, 4, 0)
    with pytest.raises(NotImplementedError, match="later port slice"):
        tgpt.build_draft_chain(cfg, 1, 4, 2, mesh=object())
    with pytest.raises(ValueError, match="int4"):
        tgpt.build_draft_chain(tgpt.GPTConfig(**TINY, weight_dtype="int4"),
                               1, 4, 2, mega=True)


@pytest.mark.parametrize("mega", [False, True], ids=["per-op", "mega"])
def test_model_draft_engine_self_heals_like_jax(mega):
    """The engine against the JAX one over three rounds on one lane: a
    fresh context (catch-up over several chunks, then the chain), a
    context that diverged after the first draft (the pool rolls back to
    the fork) and a shorter context (a preemption replay). Each round's
    drafts equal the JAX engine's and a fresh engine's; ``release`` frees
    the lane's pages."""
    jm, tm = _pair(seed=9)
    kw = dict(page_size=4, chunk=4, max_batch=2, max_seq_len=48, max_k=3,
              mega=mega)
    jeng = jdraft.ModelDraftEngine(jgpt.GPTConfig(**TINY),
                                   jgpt.serving_params(jm), 1,
                                   use_kernel=False, **kw)
    tparams = tgpt.serving_params(tm)
    cfg = tgpt.GPTConfig(**TINY)
    teng = tdraft.ModelDraftEngine(cfg, tparams, 1, device="cpu", **kw)
    ctx = [int(x) for x in np.random.RandomState(3).randint(0, 97, 11)]
    d1 = teng.propose({0: (7, ctx, 3)})[0]
    assert d1 == jeng.propose({0: (7, ctx, 3)})[0] and len(d1) == 3
    ctx2 = ctx + [d1[0], (d1[1] + 1) % 97]
    ctx3 = ctx[:5]
    for c, k in ((ctx2, 3), (ctx3, 2)):
        got = teng.propose({0: (7, c, k)})[0]
        assert got == jeng.propose({0: (7, c, k)})[0]
        fresh = tdraft.ModelDraftEngine(cfg, tparams, 1, device="cpu", **kw)
        assert got == fresh.propose({0: (7, c, k)})[0] and len(got) == k
    # the pool holds the context but its last token, and the drafts but
    # the last one
    assert teng.cache.seq_len(teng._lanes[7]["slot"]) == len(ctx3) - 1 + 2
    assert teng.model_steps == jeng.model_steps
    assert teng.trace_count == 3      # catch-up, the chains of k 3 and 2
    teng.release(7)
    assert teng.cache.available_page_count == teng.cache.num_pages
