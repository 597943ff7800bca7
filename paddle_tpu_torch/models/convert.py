"""Weight carry-over between the reference and the port.

Eager model weights cross as a dict of numpy arrays keyed the way the
reference's ``jit.api._named_state`` names them (``gpt.embeddings
.word_embeddings.weight``, ``gpt.layers.{i}.attn.qkv_proj.weight``, ...).
The port's module tree uses the same names and the same ``[in, out]``
linear layout, so loading is a key-for-key copy: no transpose anywhere.

Serving params cross as the reference's serving pytree in numpy, fp or
weight-only quantized, dense or with MoE expert stacks ``[L, E, ...]``, bit
for bit (:func:`serving_params_from_jax_numpy`).

BERT weights (``models/bert.py``) cross the same way, under the names of
the reference's ``BertForPretraining`` / ``BertForSequenceClassification``
(the MLM decoder is the word embeddings, one tensor under one name):
:func:`bert_from_jax_numpy`, :func:`bert_to_numpy` (the inverse, for
weights and gradients), :func:`random_bert_state`.

Training params (``models/gpt_spmd.py``) cross as the reference's
``gpt_spmd.init_params`` pytree in numpy: the same keys, with the stage
leaves ``[pp, L/pp, ...]`` on the reference's side and ``[L, ...]`` on the
port's (one device, ``pp = 1``).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

from . import gpt_spmd
from .bert import BertConfig, BertForPretraining, BertForSequenceClassification
from .gpt import GPTConfig, GPTForCausalLM


def state_from_jax_numpy(named: dict, config: GPTConfig, *, device=None,
                         dtype=torch.float32) -> GPTForCausalLM:
    """A ``GPTForCausalLM`` on ``device`` holding exactly ``named``'s
    weights (cast to ``dtype``). Raises on any missing, extra or wrongly
    shaped key."""
    return _load_named(GPTForCausalLM(config, device=device, dtype=dtype),
                       named, dtype)


def _load_named(model, named: dict, dtype):
    """``model`` with exactly ``named``'s weights (cast to ``dtype``).
    Raises on any missing, extra or wrongly shaped key."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(want) - set(named))
    extra = sorted(set(named) - set(want))
    bad = sorted(k for k in set(want) & set(named)
                 if tuple(np.shape(named[k])) != want[k])
    if missing or extra or bad:
        raise ValueError(
            "state_from_jax_numpy: "
            + "; ".join(f"{what}: {keys}" for what, keys in
                        (("missing", missing), ("extra", extra),
                         ("wrong shape", [(k, np.shape(named[k]), want[k])
                                          for k in bad])) if keys))
    dev = next(model.parameters()).device
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)).to(dev, dtype)
                           for k, v in named.items()})
    return model


def bert_from_jax_numpy(named: dict, config: BertConfig, *, device=None,
                        dtype=torch.float32):
    """The port's BERT on ``device`` holding exactly ``named``'s weights
    (the reference's ``_named_state`` as numpy, cast to ``dtype``): a
    ``BertForPretraining`` when ``named`` has the pretraining heads
    (``cls.*``), else a ``BertForSequenceClassification`` with as many
    classes as ``classifier.bias`` has. Raises on any missing, extra or
    wrongly shaped key."""
    if "cls.decoder_bias" in named:
        model = BertForPretraining(config, device=device, dtype=dtype)
    else:
        model = BertForSequenceClassification(
            config, len(np.asarray(named["classifier.bias"])), device=device,
            dtype=dtype)
    return _load_named(model, named, dtype)


def bert_to_numpy(tensors: dict) -> dict:
    """The inverse of :func:`bert_from_jax_numpy`: ``{name: tensor}`` (a
    model's ``state_dict()``, or its parameters' gradients by name) as fp32
    numpy under the same names, the reference's."""
    return {k: t.detach().float().cpu().numpy() for k, t in tensors.items()}


def random_bert_state(config: BertConfig, seed: int = 0,
                      num_classes: int | None = None) -> dict:
    """Seeded numpy BERT weights under the reference's names and init
    scheme: N(0, initializer_range) embeddings and weight matrices, zero
    biases, unit LN scales; the pretraining heads, or with ``num_classes``
    the sequence classifier."""
    rng = np.random.default_rng(seed)
    h, f, std = (config.hidden_size, config.intermediate_size,
                 config.initializer_range)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * std

    def ln(prefix):
        return {prefix + ".weight": np.ones(h, np.float32),
                prefix + ".bias": np.zeros(h, np.float32)}

    def linear(prefix, i, o):
        return {prefix + ".weight": normal(i, o),
                prefix + ".bias": np.zeros(o, np.float32)}

    e = "bert.embeddings."
    out = {e + "word_embeddings.weight": normal(config.vocab_size, h),
           e + "position_embeddings.weight":
               normal(config.max_position_embeddings, h),
           e + "token_type_embeddings.weight":
               normal(config.type_vocab_size, h),
           **ln(e + "layer_norm")}
    for i in range(config.num_layers):
        p = f"bert.encoder.{i}."
        out.update({**linear(p + "attention.qkv", h, 3 * h),
                    **linear(p + "attention.out", h, h), **ln(p + "ln1"),
                    **linear(p + "fc1", h, f), **linear(p + "fc2", f, h),
                    **ln(p + "ln2")})
    out.update(linear("bert.pooler.dense", h, h))
    if num_classes is None:
        out.update({"cls.decoder_bias": np.zeros(config.vocab_size,
                                                 np.float32),
                    **linear("cls.transform", h, h), **ln("cls.layer_norm"),
                    **linear("cls.seq_relationship", h, 2)})
    else:
        out.update(linear("classifier", h, num_classes))
    return out


def random_state(config: GPTConfig, seed: int = 0) -> dict:
    """Seeded numpy weights under the reference's names and init scheme:
    N(0, initializer_range) embeddings, weight matrices, router weights and
    expert stacks, zero biases, unit LN scales — what both packages load
    in tests and on the card."""
    rng = np.random.default_rng(seed)
    h, f, v = config.hidden_size, config.ffn_size, config.vocab_size
    e = config.moe_experts
    std = config.initializer_range

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * std)

    out = {"gpt.embeddings.word_embeddings.weight": normal(v, h),
           "gpt.embeddings.position_embeddings.weight":
               normal(config.max_seq_len, h)}
    for i in range(config.num_layers):
        p = f"gpt.layers.{i}."
        out.update({
            p + "ln_1.weight": np.ones(h, np.float32),
            p + "ln_1.bias": np.zeros(h, np.float32),
            p + "attn.qkv_proj.weight": normal(h, 3 * h),
            p + "attn.qkv_proj.bias": np.zeros(3 * h, np.float32),
            p + "attn.out_proj.weight": normal(h, h),
            p + "attn.out_proj.bias": np.zeros(h, np.float32),
            p + "ln_2.weight": np.ones(h, np.float32),
            p + "ln_2.bias": np.zeros(h, np.float32),
        })
        if e:
            out.update({
                p + "mlp.gate_weight": normal(h, e),
                p + "mlp.w1": normal(e, h, f),
                p + "mlp.b1": np.zeros((e, f), np.float32),
                p + "mlp.w2": normal(e, f, h),
                p + "mlp.b2": np.zeros((e, h), np.float32),
            })
        else:
            out.update({
                p + "mlp.fc1.weight": normal(h, f),
                p + "mlp.fc1.bias": np.zeros(f, np.float32),
                p + "mlp.fc2.weight": normal(f, h),
                p + "mlp.fc2.bias": np.zeros(h, np.float32),
            })
    out["gpt.ln_f.weight"] = np.ones(h, np.float32)
    out["gpt.ln_f.bias"] = np.zeros(h, np.float32)
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = normal(h, v)
    return out


def _tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (bf16 as the ``ml_dtypes`` type JAX exports) as a
    tensor of the same dtype and bits on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def serving_params_from_jax_numpy(tree: dict, *, device=None) -> dict:
    """The port's serving params on ``device`` from the reference's serving
    pytree (``models.gpt.serving_params``, optionally quantized by
    ``inference.quantize``) with numpy leaves: the same keys and layouts,
    every leaf bit for bit in its own dtype (quantized stacks, dense
    ``[L, K, N]`` or expert ``[L, E, K, N]``, keep their ``{"q", "s"}``
    form)."""
    dev = resolve_device(device)

    def leaf(a):
        if isinstance(a, dict):
            return {k: leaf(v) for k, v in a.items()}
        return _tensor_from_numpy(a, dev)

    return leaf(tree)


def train_params_from_jax_numpy(tree: dict, *, device=None,
                                dtype=torch.float32) -> dict:
    """Port training params on ``device`` from the reference's
    ``gpt_spmd.init_params`` pytree (numpy leaves): the stage leaves drop
    their ``pp = 1`` dim. Raises for ``pp > 1``."""
    dev = resolve_device(device)

    def leaf(path, a):
        a = np.asarray(a)
        if path.startswith("stages/"):
            if a.shape[0] != 1:
                raise ValueError(f"{path}: pp = {a.shape[0]} stages; the "
                                 "port trains on one device (pp = 1)")
            a = a[0]
        return path, torch.from_numpy(np.array(a)).to(dev, dtype)

    return gpt_spmd.unflatten(leaf(p, a)
                              for p, a in gpt_spmd.leaves(tree))


def train_params_to_numpy(params: dict) -> dict:
    """The inverse of :func:`train_params_from_jax_numpy`: numpy leaves in
    the reference's layout (stage leaves regain their ``pp = 1`` dim)."""
    def leaf(path, t):
        a = t.detach().float().cpu().numpy()
        return path, a[None] if path.startswith("stages/") else a

    return gpt_spmd.unflatten(leaf(p, t) for p, t in gpt_spmd.leaves(params))


def random_train_params(config: GPTConfig, seed: int = 0) -> dict:
    """Seeded numpy training params in the port's layout (stage leaves
    ``[L, ...]``): N(0, initializer_range) embeddings and weight matrices,
    zero biases, unit LN scales — what ``build_spmd_train_step(params=)``
    takes where no reference is at hand."""
    rng = np.random.default_rng(seed)
    std = np.float32(config.initializer_range)

    def leaf(path, shape):
        name = path.rsplit("/", 1)[-1]
        if name.endswith("_g"):
            return path, np.ones(shape, np.float32)
        if name.startswith("b") or name.endswith("_b"):
            return path, np.zeros(shape, np.float32)
        return path, rng.standard_normal(shape, dtype=np.float32) * std

    return gpt_spmd.unflatten(
        leaf(p, shape) for p, shape in gpt_spmd.leaves(
            gpt_spmd.param_shapes(config)))
