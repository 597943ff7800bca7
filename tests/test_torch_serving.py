"""Port serving (unified step + synchronous ServingPredictor) against the
JAX package's ``ServingPredictor(use_kernel=False, async_engine=False)``.

The weights use ``initializer_range 0.5``: at the reference's 0.02 a model
this small emits one token forever, and a parity check over constant
streams would check nothing.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.jit.api import _named_state
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference import ServingPredictor
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import random_state, state_from_jax_numpy

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=96, initializer_range=0.5)


def _pair(seed=3):
    named = random_state(tgpt.GPTConfig(**TINY), seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY))
    jm.eval()
    for name, t in _named_state(jm).items():
        t.set_value(named[name])
    tm = state_from_jax_numpy(named, tgpt.GPTConfig(**TINY), device="cpu")
    tm.eval()
    return jm, tm


def _churn():
    rng = np.random.RandomState(11)
    p0 = [int(x) for x in rng.randint(0, 97, 30)]
    return [p0,
            [int(x) for x in rng.randint(0, 97, 9)],
            [int(x) for x in rng.randint(0, 97, 17)],
            list(p0),                                  # duplicate: CoW
            p0[:20] + [int(x) for x in rng.randint(0, 97, 6)],  # shared
            [int(x) for x in rng.randint(0, 97, 3)]]


def test_predictor_matches_jax_sync_engine():
    jm, tm = _pair()
    kw = dict(max_batch=3, page_size=8, chunk=8, num_pages=10)
    jsp = JaxPredictor(jm, use_kernel=False, async_engine=False, **kw)
    tsp = ServingPredictor(tm, device="cpu", **kw)
    want = jsp.generate(_churn(), max_new_tokens=12)
    got = tsp.generate(_churn(), max_new_tokens=12)
    assert all(want) and len({t for s in want for t in s}) > 3
    assert got == want
    jt, tt = jsp.telemetry(), tsp.telemetry()
    for key in ("serving_preemptions", "kv_cow_copies",
                "kv_prefix_hit_tokens", "serving_steps",
                "serving_tokens_emitted"):
        assert tt[key] == jt[key], key
    assert tt["serving_preemptions"] > 0 and tt["kv_cow_copies"] > 0
    assert tsp.cache.available_page_count == tsp.cache.num_pages


def _step_args(lanes, b, t):
    """Packed step arrays for ``lanes``: slot -> (kv_len, tokens)."""
    tok_ids = np.zeros(t, np.int32)
    tok_slot = np.full(t, -1, np.int32)
    tok_pos = np.zeros(t, np.int32)
    q_lens = np.zeros(b, np.int32)
    kv_lens = np.zeros(b, np.int32)
    last_idx = np.full(b, t, np.int32)
    emit = np.zeros(b, np.int32)
    w = 0
    for slot, (kv_len, toks) in sorted(lanes.items()):
        n = len(toks)
        tok_ids[w:w + n] = toks
        tok_slot[w:w + n] = slot
        tok_pos[w:w + n] = np.arange(kv_len, kv_len + n)
        q_lens[slot], kv_lens[slot] = n, kv_len
        last_idx[slot] = w + n - 1
        emit[slot] = 1
        w += n
    return tok_ids, tok_slot, tok_pos, q_lens, kv_lens, last_idx, emit


def test_fused_mlp_config_serves_the_same_tokens():
    """The serving step keeps its per-op MLP whatever ``fused_mlp`` says (as
    the reference's does): a fused_mlp config serves the unfused config's
    greedy streams, and its first token is the fused full forward's argmax
    over the prompt."""
    named = random_state(tgpt.GPTConfig(**TINY), 3)
    models = [state_from_jax_numpy(named, tgpt.GPTConfig(**TINY, **over),
                                   device="cpu").eval()
              for over in ({}, {"fused_mlp": True})]
    kw = dict(max_batch=3, page_size=8, chunk=8, num_pages=10)
    outs = [ServingPredictor(m, device="cpu", **kw).generate(
        _churn(), max_new_tokens=8) for m in models]
    assert all(outs[0]) and len({t for s in outs[0] for t in s}) > 3
    assert outs[1] == outs[0]
    with torch.no_grad():
        for prompt, stream in zip(_churn(), outs[1]):
            logits = models[1](torch.tensor([prompt]))[0, -1]
            assert int(logits.argmax()) == stream[0]


def test_unified_step_matches_jax():
    """Two steps: two prefill chunks, then a decode lane, a continuing
    chunk and a copy-on-write lane reading the copied page."""
    jm, tm = _pair(seed=5)
    cfg = tgpt.GPTConfig(**TINY)
    ps, chunk, b, t, num_pages = 4, 4, 3, 8, 6
    shape = (cfg.num_layers, num_pages, ps, cfg.num_heads, cfg.head_dim)
    jk = jnp.zeros(shape, jnp.float32)
    jv = jnp.zeros(shape, jnp.float32)
    tk = torch.zeros((shape[0], num_pages + 1) + shape[2:])
    tv = torch.zeros_like(tk)
    jstep = jgpt.build_unified_step(jgpt.GPTConfig(**TINY), ps, chunk,
                                    use_kernel=False)
    tstep = tgpt.build_unified_step(cfg, ps, chunk)
    jparams, tparams = jgpt.serving_params(jm), tgpt.serving_params(tm)
    zb, zt = np.zeros(b, np.int32), np.zeros(t, np.int32)
    rounds = [
        (np.array([[1, 3], [0, 2], [-1, -1]], np.int32),
         {0: (0, [5, 6, 7, 8]), 1: (0, [9, 10, 11])},
         np.full(b, num_pages, np.int32), np.full(b, num_pages, np.int32)),
        (np.array([[1, 3], [0, 2], [4, -1]], np.int32),
         {0: (4, [12]), 1: (3, [13, 14]), 2: (3, [15])},
         np.array([0, 0, 1], np.int32),
         np.array([num_pages, num_pages, 4], np.int32)),
    ]
    for pt, lanes, cow_src, cow_dst in rounds:
        ids, slot, pos, ql, kl, last, emit = _step_args(lanes, b, t)
        jout, jlog, jk, jv = jstep(
            jparams, *(jnp.asarray(a) for a in
                       (ids, slot, pos, ql, kl, last, zt, zb, emit, zb)),
            jk, jv, jnp.asarray(pt), jnp.asarray(cow_src),
            jnp.asarray(cow_dst), jnp.zeros((b, 2), jnp.uint32),
            jnp.zeros(b, jnp.float32), jnp.zeros(b, jnp.int32),
            jnp.ones(b, jnp.float32))
        tout, tlog, tk, tv = tstep(
            tparams, *(torch.from_numpy(a) for a in
                       (ids, slot, pos, ql, kl, last, zt, zb, emit, zb)),
            tk, tv, torch.from_numpy(pt), torch.from_numpy(cow_src),
            torch.from_numpy(cow_dst), torch.zeros(b, dtype=torch.int64),
            torch.zeros(b), torch.zeros(b, dtype=torch.int32),
            torch.ones(b))
        rows = sorted(lanes)
        np.testing.assert_allclose(tlog.numpy()[rows],
                                   np.asarray(jlog)[rows], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_array_equal(tout.numpy()[rows],
                                      np.asarray(jout)[rows])
        np.testing.assert_allclose(tk[:, :num_pages].numpy(), np.asarray(jk),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tv[:, :num_pages].numpy(), np.asarray(jv),
                                   atol=1e-5, rtol=1e-5)


def _port_predictor(tm):
    return ServingPredictor(tm, max_batch=3, page_size=8, chunk=8,
                            device="cpu")


def test_sampling_within_port():
    """The reference samples with threefry keys torch cannot reproduce, so
    sampling holds to the port's own contracts: a seed fixes the stream,
    temperature 0 (and top_k 1) is greedy, seeds differ."""
    _, tm = _pair()
    prompts = _churn()[:3]
    greedy = _port_predictor(tm).generate(prompts, max_new_tokens=10)
    zero_t = _port_predictor(tm).generate(prompts, max_new_tokens=10,
                                          temperature=0.0, seed=1)
    top1 = _port_predictor(tm).generate(prompts, max_new_tokens=10,
                                        temperature=1.0, top_k=1, seed=1)
    assert zero_t == greedy and top1 == greedy
    runs = {s: _port_predictor(tm).generate(prompts, max_new_tokens=10,
                                            temperature=1.0, top_p=0.9,
                                            seed=s)
            for s in (1, 2, 3)}
    again = _port_predictor(tm).generate(prompts, max_new_tokens=10,
                                         temperature=1.0, top_p=0.9, seed=1)
    assert again == runs[1]
    assert len({str(r) for r in runs.values()}) > 1
    assert all(0 <= t < TINY["vocab_size"] for r in runs.values()
               for s in r for t in s)


def test_unported_engines_raise():
    _, tm = _pair()
    # the async engine is ported; the legacy path refuses it, as the
    # reference's does
    with pytest.raises(ValueError, match="async"):
        ServingPredictor(tm, async_engine=True, unified=False, device="cpu")
    # speculation is ported; its verify rows must fit the chunk block, as
    # in the reference, and its MoE composition is a later slice
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY, spec_decode_k=2),
                                device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        ServingPredictor(model, chunk=2, device="cpu")
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY, spec_decode_k=2,
                                               moe_experts=2), device="cpu")
    with pytest.raises(NotImplementedError, match="speculative"):
        ServingPredictor(model, device="cpu")
    # mega is ported; int4 weights are what it cannot serve, as in the
    # reference
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY, mega_decode=True,
                                               weight_dtype="int4"),
                                device="cpu")
    with pytest.raises(ValueError, match="int4"):
        ServingPredictor(model, device="cpu")
