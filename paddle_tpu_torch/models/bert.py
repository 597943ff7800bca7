"""BERT model family — port of ``paddle_tpu/models/bert.py`` (the
reference's BASELINE config 2, BERT-base pretraining).

Post-LN encoder blocks with a fused QKV projection split ``[3, nh, hd]``,
exact GELU, learned positions and token types; pretraining heads MLM (the
decoder tied to the word embeddings) + NSP; a sequence classifier on the
pooled ``[CLS]`` row. ``BertModel`` turns a ``[b, s]`` 1/0
``attention_mask`` into the additive ``(1 - m) * -1e9`` fp32 mask ``[b, 1,
1, s]``, and every layer's attention goes through
``nn.functional.scaled_dot_product_attention`` non-causal with that mask:
on a CUDA tensor the flash kernels' mask branch, forward and backward.

Linear weights keep the JAX layout ``[in, out]`` and the module tree uses
the reference's names (``bert.encoder.{i}.attention.qkv.weight``,
``cls.decoder_bias``, ...), so weights cross key for key
(``models/convert.py``). Dropout draws from the model's
``torch.Generator`` (seeded with ``seed``); inside
``nn.functional.attention.plain_attention()`` every layer runs the plain
``_sdpa_ref`` (the kernels' oracle). LayerNorm, GELU and cross entropy
are PyTorch's plain ops, as the reference leaves them to XLA.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .._device import resolve_device
from ..nn import functional as F
from .gpt import LayerNorm, Linear


@dataclass
class BertConfig:
    """Same fields and defaults as the reference ``BertConfig``."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        h, f, v, l = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_layers)
        emb = (v + self.max_position_embeddings + self.type_vocab_size) * h \
            + 2 * h
        layer = 4 * h * h + 4 * h + 2 * h * f + h + f + 4 * h
        return emb + l * layer + h * h + h


BERT_CONFIGS = {
    "bert-base": BertConfig(),
    "bert-large": BertConfig(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096),
    "bert-tiny": BertConfig(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=512, max_position_embeddings=128),
}


class Dropout(nn.Module):
    """Inverted dropout drawing its keep mask from ``generator``."""

    def __init__(self, p: float, generator):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0).to(x.dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, generator, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h, **kw)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h,
                                                  **kw)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, **kw)
        self.dropout = Dropout(config.hidden_dropout, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, generator, *, device=None,
                 dtype=None):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.generator = generator
        self.qkv = Linear(h, 3 * h, device=device, dtype=dtype)
        self.out = Linear(h, h, device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout, generator)

    def forward(self, x, attn_mask=None):
        cfg = self.config
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv(x).reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        drop = cfg.attn_dropout if self.training else 0.0
        o = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=False, dropout_p=drop,
            training=self.training, generator=self.generator)
        o = o.reshape(b, s, cfg.num_heads * cfg.head_dim)
        return self.dropout(self.out(o))


class BertLayer(nn.Module):
    """Post-LN encoder block (original BERT)."""

    def __init__(self, config: BertConfig, generator, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = BertSelfAttention(config, generator, **kw)
        self.ln1 = LayerNorm(h, eps, **kw)
        self.fc1 = Linear(h, config.intermediate_size, **kw)
        self.fc2 = Linear(config.intermediate_size, h, **kw)
        self.ln2 = LayerNorm(h, eps, **kw)
        self.dropout = Dropout(config.hidden_dropout, generator)

    def forward(self, x, attn_mask=None):
        x = self.ln1(x + self.attention(x, attn_mask))
        y = self.dropout(self.fc2(torch.nn.functional.gelu(
            self.fc1(x), approximate="none")))
        return self.ln2(x + y)


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig, *, device=None, dtype=None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            device=device, dtype=dtype)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


def _init_weights(model, std, generator):
    """N(0, ``std``) weight matrices and embeddings, zero biases, unit LN
    scales (the reference's initializers), drawn from ``generator``."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and "layer_norm" not in name \
                    and ".ln" not in name:
                p.normal_(0.0, std, generator=generator)


class BertModel(nn.Module):
    """Embeddings + encoder stack + pooler. Built on ``device`` (``None`` =
    ``cuda:0``, raising without a card); weights and dropout draw from a
    ``torch.Generator`` seeded with ``seed`` (or from ``generator``, a
    parent model's, which then draws the weights)."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32, seed: int = 0, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        own = generator is None   # a top-level model: draw its own weights
        if own:
            generator = torch.Generator(device=device).manual_seed(int(seed))
        kw = dict(device=device, dtype=dtype)
        self.embeddings = BertEmbeddings(config, generator, **kw)
        self.encoder = nn.ModuleList(BertLayer(config, generator, **kw)
                                     for _ in range(config.num_layers))
        self.pooler = BertPooler(config, **kw)
        if own:
            _init_weights(self, config.initializer_range, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None:
            # [b, s] 1/0 -> additive [b, 1, 1, s] in fp32
            m = (1.0 - attention_mask.float()) * -1e9
            attention_mask = m.reshape(m.shape[0], 1, 1, m.shape[-1])
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            x = layer(x, attention_mask)
        return x, self.pooler(x)


class BertPretrainingHeads(nn.Module):
    """MLM transform + decoder tied to the word embeddings (read through
    ``embeddings``, so the weight stays one tensor) + NSP classifier."""

    def __init__(self, config: BertConfig, embeddings, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = config.hidden_size
        self._tied = (embeddings,)   # a tuple: not registered twice
        self.transform = Linear(h, h, **kw)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, **kw)
        self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size,
                                                     **kw))
        self.seq_relationship = Linear(h, 2, **kw)

    def forward(self, sequence_output, pooled_output):
        x = self.layer_norm(torch.nn.functional.gelu(
            self.transform(sequence_output), approximate="none"))
        mlm_logits = x @ self._tied[0].weight.T + self.decoder_bias
        return mlm_logits, self.seq_relationship(pooled_output)


class BertForPretraining(nn.Module):
    """MLM + NSP pretraining objective: the mean cross entropy of the MLM
    logits over labels other than -100, plus the NSP one."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        gen = torch.Generator(device=device).manual_seed(int(seed))
        kw = dict(device=device, dtype=dtype)
        self.bert = BertModel(config, generator=gen, **kw)
        self.cls = BertPretrainingHeads(
            config, self.bert.embeddings.word_embeddings, **kw)
        _init_weights(self, config.initializer_range, gen)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_label=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        mlm_logits, nsp_logits = self.cls(seq, pooled)
        if masked_lm_labels is None:
            return mlm_logits, nsp_logits
        ce = torch.nn.functional.cross_entropy
        loss = ce(mlm_logits.reshape(-1, self.config.vocab_size),
                  masked_lm_labels.reshape(-1), ignore_index=-100)
        if next_sentence_label is not None:
            loss = loss + ce(nsp_logits, next_sentence_label.reshape(-1))
        return loss


class BertForSequenceClassification(nn.Module):
    def __init__(self, config: BertConfig, num_classes: int = 2, *,
                 device=None, dtype=torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        kw = dict(device=device, dtype=dtype)
        self.bert = BertModel(config, generator=gen, **kw)
        self.dropout = Dropout(config.hidden_dropout, gen)
        self.classifier = Linear(config.hidden_size, num_classes, **kw)
        _init_weights(self, config.initializer_range, gen)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return torch.nn.functional.cross_entropy(logits, labels)
