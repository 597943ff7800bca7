"""The port's BERT (``paddle_tpu_torch.models.bert``, CPU) against the JAX
package's ``BertForPretraining`` / ``BertForSequenceClassification`` on the
same weights (``random_bert_state``, numpy seed) and inputs (ids, token
types, a padded 1/0 ``attention_mask``, MLM labels with ``-100`` entries,
NSP labels, numpy seed), after ``bert_from_jax_numpy``:

- the MLM and NSP logits and the pretraining loss;
- every parameter's gradient of that loss (``jax.value_and_grad`` through
  ``functional_call`` on the reference's side, as ``bench.py``'s
  ``bench_bert_jit`` takes it), named back by ``bert_to_numpy``;
- the sequence classifier's logits and loss.

Configs: ``bert-tiny`` at seq 32 and a 2-layer config with four heads of 64
at seq 128, dropout 0 (as the benchmark sets it). fp32 on both sides, the
same math in other op orders: logits and losses ``rtol 1e-5, atol 1e-5``;
each gradient leaf's max abs error over its max ``|grad|`` to ``1e-5``.
"""
import contextlib
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.jit.api import functional_call
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models.bert import BERT_CONFIGS, BertConfig
from paddle_tpu_torch.models.convert import (bert_from_jax_numpy,
                                             bert_to_numpy, random_bert_state)
from paddle_tpu_torch.nn.functional.attention import plain_attention

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5
CONFIGS = {
    "bert-tiny s32": (replace(BERT_CONFIGS["bert-tiny"], hidden_dropout=0.0,
                              attn_dropout=0.0), 3, 32),
    "2 layers, heads of 64, s128": (BertConfig(
        vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
        intermediate_size=1024, max_position_embeddings=128,
        hidden_dropout=0.0, attn_dropout=0.0), 2, 128),
}


def _jax_config(cfg):
    return jbert.BertConfig(**vars(cfg))


def _batch(cfg, b, s, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int64)
    types = (np.arange(s)[None] >= s // 2).astype(np.int64).repeat(b, 0)
    lens = rng.randint(s // 4, s + 1, b)
    lens[0] = s
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int64)
    labels = np.where(rng.rand(b, s) < 0.3, ids, -100)
    labels[:, 0] = ids[:, 0]             # at least one label a row
    nsp = rng.randint(0, 2, b).astype(np.int64)
    return ids, types, mask, labels, nsp


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pretraining_matches_jax(name):
    cfg, b, s = CONFIGS[name]
    named = random_bert_state(cfg, seed=3)
    ids, types, mask, labels, nsp = _batch(cfg, b, s, seed=4)
    paddle.seed(0)
    jm = jbert.BertForPretraining(_jax_config(cfg))
    params = {k: jnp.asarray(v) for k, v in named.items()}
    T = paddle.Tensor

    def jrun(p, **kw):
        from paddle_tpu.autograd import no_grad

        with no_grad():
            return functional_call(jm, p, T(jnp.asarray(ids)),
                                   token_type_ids=T(jnp.asarray(types)),
                                   attention_mask=T(jnp.asarray(mask)), **kw)

    jmlm, jnsp = (np.asarray(x._data) for x in jrun(params))
    jloss, jgrads = jax.value_and_grad(lambda p: jrun(
        p, masked_lm_labels=T(jnp.asarray(labels)),
        next_sentence_label=T(jnp.asarray(nsp)))._data)(params)

    model = bert_from_jax_numpy(named, cfg, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in (
        ("ids", ids), ("types", types), ("mask", mask), ("labels", labels),
        ("nsp", nsp))}
    with torch.no_grad():
        mlm, nsp_logits = model(t["ids"], t["types"],
                                attention_mask=t["mask"])
    np.testing.assert_allclose(mlm.numpy(), jmlm, **TOL)
    np.testing.assert_allclose(nsp_logits.numpy(), jnsp, **TOL)
    loss = model(t["ids"], t["types"], attention_mask=t["mask"],
                 masked_lm_labels=t["labels"], next_sentence_label=t["nsp"])
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    loss.backward()
    got = bert_to_numpy({n: p.grad for n, p in model.named_parameters()})
    assert set(got) == set(jgrads) == set(named)
    for n, w in jgrads.items():
        w = np.asarray(w)
        err = np.abs(got[n] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (n, err)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_classifier_matches_jax(name):
    cfg, b, s = CONFIGS[name]
    named = random_bert_state(cfg, seed=5, num_classes=3)
    ids, types, mask, _, _ = _batch(cfg, b, s, seed=6)
    cls = np.arange(b) % 3
    paddle.seed(0)
    jm = jbert.BertForSequenceClassification(_jax_config(cfg), num_classes=3)
    params = {k: jnp.asarray(v) for k, v in named.items()}
    T = paddle.Tensor
    from paddle_tpu.autograd import no_grad

    with no_grad():
        jlogits = functional_call(jm, params, T(jnp.asarray(ids)),
                                  token_type_ids=T(jnp.asarray(types)),
                                  attention_mask=T(jnp.asarray(mask)))
        jloss = functional_call(jm, params, T(jnp.asarray(ids)),
                                token_type_ids=T(jnp.asarray(types)),
                                attention_mask=T(jnp.asarray(mask)),
                                labels=T(jnp.asarray(cls)))
    model = bert_from_jax_numpy(named, cfg, device="cpu")
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(ids), torch.from_numpy(types),
                       attention_mask=torch.from_numpy(mask))
        loss = model(torch.from_numpy(ids), torch.from_numpy(types),
                     attention_mask=torch.from_numpy(mask),
                     labels=torch.from_numpy(cls))
    assert logits.shape == (b, 3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits._data),
                               **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss._data), **TOL)


def test_flash_and_plain_attention_agree_on_cpu():
    """``plain_attention()`` only picks the route: on the CPU both run
    plain attention, and the mask reaches both."""
    cfg = CONFIGS["bert-tiny s32"][0]
    named = random_bert_state(cfg, seed=7)
    ids, types, mask, _, _ = _batch(cfg, 2, 32, seed=8)
    model = bert_from_jax_numpy(named, cfg, device="cpu")
    outs = []
    for flash in (True, False):
        with torch.no_grad(), (contextlib.nullcontext() if flash
                               else plain_attention()):
            outs.append(model(torch.from_numpy(ids), torch.from_numpy(types),
                              attention_mask=torch.from_numpy(mask))[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with torch.no_grad():          # the padding mask changes the logits
        unmasked = model(torch.from_numpy(ids), torch.from_numpy(types))[0]
    assert not torch.allclose(unmasked[1], outs[1][1])
