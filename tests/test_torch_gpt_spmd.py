"""Port GPT training step (``models/gpt_spmd.py``) against the JAX package's
``gpt_spmd`` on the CPU, on the same params carried across by
``models/convert.py`` and the same seeded numpy ids and labels.

- ``jax.value_and_grad(gpt_spmd.loss_fn)`` against the port's
  ``value_and_grad`` for the loss and every gradient leaf, with
  ``force_flash`` on (the JAX Pallas kernels in interpret mode; the port's
  flash custom op on its plain twins) and off, ``recompute`` on and off.
  fp32; ``rtol 1e-5, atol 1e-5`` (the same fp32 math, sums in another
  order; gradients here are <= ~0.1).
- A 3-step ``build_spmd_train_step`` run on ``_gpt_case(1)``'s config
  (batch 4, seq 32, num_micro 2, lr 0.05): the three losses and the updated
  params and momentum, same tolerance.
- ``remat_save_attn``: under ``recompute`` the flash forward runs once per
  layer per step when its outputs are saved and twice when they are not.
- ``fused_mlp=True, force_fused_mlp=True``: the reference runs its fused
  LN / GELU Pallas kernels in interpret mode, the port its fused custom ops
  on their plain versions; the loss, every gradient and a 3-step
  trajectory at the same tolerance, with and without ``recompute`` /
  ``remat_save_ln`` (which keeps the fused LN ops' outputs, so their
  forward runs once per layer per step instead of twice).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt_spmd as jspmd
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu_torch.models import gpt_spmd as tspmd
from paddle_tpu_torch.models.convert import (random_train_params,
                                             train_params_from_jax_numpy,
                                             train_params_to_numpy)
from paddle_tpu_torch.models.gpt import GPTConfig as TConfig
from paddle_tpu_torch.observability import default_registry
from paddle_tpu_torch.ops import flash_attention as tflash
from paddle_tpu_torch.ops import fused_mlp as tfm

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=128, initializer_range=0.2)
CASE1 = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
             max_seq_len=64)      # __graft_entry__._gpt_case(1)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _assert_trees_close(got, want, what):
    got, want = dict(tspmd.leaves(got)), dict(tspmd.leaves(want))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], **TOL,
                                   err_msg=f"{what} {path}")


def _batch(cfg, b, s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg["vocab_size"], (b, s)),
            rng.randint(0, cfg["vocab_size"], (b, s)))


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("force_flash", [False, True])
def test_loss_and_grads_match_jax(force_flash, recompute):
    over = dict(force_flash=force_flash, recompute=recompute)
    jcfg, tcfg = JConfig(**SMALL, **over), TConfig(**SMALL, **over)
    mesh = jspmd.make_mesh(1)
    params = jspmd.init_params(jcfg, mesh)
    ids, labels = _batch(SMALL, 2, 128, seed=1)
    with jax.set_mesh(mesh):
        fn = jax.jit(lambda p, i, l: jax.value_and_grad(jspmd.loss_fn)(
            p, i, l, jcfg, mesh, 2))
        want_loss, want_grads = fn(params, jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(labels, jnp.int32))
    tparams = train_params_from_jax_numpy(_np_tree(params), device="cpu")
    loss, grads = tspmd.value_and_grad(tparams, torch.from_numpy(ids),
                                       torch.from_numpy(labels), tcfg, 2)
    assert np.isfinite(float(want_loss))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    _assert_trees_close(train_params_to_numpy(grads), _np_tree(want_grads),
                        "grad")


FUSED = dict(fused_mlp=True, force_fused_mlp=True)


@pytest.mark.parametrize("recompute,save_ln,force_flash", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, True, True)])
def test_fused_mlp_loss_and_grads_match_jax(recompute, save_ln, force_flash):
    over = dict(FUSED, recompute=recompute, remat_save_ln=save_ln,
                force_flash=force_flash)
    jcfg, tcfg = JConfig(**SMALL, **over), TConfig(**SMALL, **over)
    mesh = jspmd.make_mesh(1)
    params = jspmd.init_params(jcfg, mesh)
    ids, labels = _batch(SMALL, 2, 128, seed=2)
    with jax.set_mesh(mesh):
        fn = jax.jit(lambda p, i, l: jax.value_and_grad(jspmd.loss_fn)(
            p, i, l, jcfg, mesh, 2))
        want_loss, want_grads = fn(params, jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(labels, jnp.int32))
    tparams = train_params_from_jax_numpy(_np_tree(params), device="cpu")
    loss, grads = tspmd.value_and_grad(tparams, torch.from_numpy(ids),
                                       torch.from_numpy(labels), tcfg, 2)
    assert np.isfinite(float(want_loss))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    _assert_trees_close(train_params_to_numpy(grads), _np_tree(want_grads),
                        "grad")


@pytest.mark.parametrize("recompute,save_ln,per_ln", [
    (False, False, 1), (True, False, 2), (True, True, 1)])
def test_fused_mlp_op_counts_under_remat(monkeypatch, recompute, save_ln,
                                         per_ln):
    """Two fused LNs and one bias-GELU a layer: under ``recompute`` their
    forwards run again in the backward unless ``remat_save_ln`` keeps the
    LN ops' outputs (the GELU is always recomputed); one backward each."""
    calls = {}
    for name in ("ln_fwd_reference", "ln_bwd_reference",
                 "gelu_fwd_reference", "gelu_bwd_reference"):
        plain = getattr(tfm, name)
        monkeypatch.setattr(tfm, name, lambda *a, _p=plain, _n=name: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1) or _p(*a)))
    cfg = TConfig(**SMALL, **FUSED, recompute=recompute,
                  remat_save_ln=save_ln)
    step, params, mom, (ids, labels) = tspmd.build_spmd_train_step(
        cfg, batch_size=2, seq_len=16, num_micro=1, device="cpu")
    step(params, mom, ids, labels)
    L = cfg.num_layers
    assert calls == {"ln_fwd_reference": 2 * L * per_ln,
                     "ln_bwd_reference": 2 * L,
                     "gelu_fwd_reference": L * (2 if recompute else 1),
                     "gelu_bwd_reference": L}


def test_train_trajectory_matches_jax_gpt_case_1():
    _check_trajectory({})


def test_fused_mlp_train_trajectory_matches_jax():
    _check_trajectory(FUSED)


def _check_trajectory(over):
    mesh = jspmd.make_mesh(1)
    jstep, jparams, jmom, (jids, jlabels) = jspmd.build_spmd_train_step(
        JConfig(**CASE1, **over), mesh, batch_size=4, seq_len=32,
        num_micro=2, lr=0.05)
    start = _np_tree(jparams)
    step, params, mom, (ids, labels) = tspmd.build_spmd_train_step(
        TConfig(**CASE1, **over), batch_size=4, seq_len=32, num_micro=2,
        lr=0.05, device="cpu",
        params=train_params_from_jax_numpy(start, device="cpu"))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    want_losses, losses = [], []
    for _ in range(3):
        jparams, jmom, jloss = jstep(jparams, jmom, jids, jlabels)
        params, mom, loss = step(params, mom, ids, labels)
        want_losses.append(float(jloss))
        losses.append(float(loss))
    # a dead oracle (nan, or a loss that never moves) would pass any parity
    assert np.isfinite(want_losses).all()
    assert len(set(want_losses)) == 3 and want_losses[2] < want_losses[0]
    np.testing.assert_allclose(losses, want_losses, **TOL)
    _assert_trees_close(train_params_to_numpy(params), _np_tree(jparams),
                        "param")
    _assert_trees_close(train_params_to_numpy(mom), _np_tree(jmom), "mom")


@pytest.mark.parametrize("recompute,save_attn,per_layer", [
    (True, True, 1), (True, False, 2), (False, True, 1)])
def test_remat_save_attn_counts_flash_forwards(monkeypatch, recompute,
                                               save_attn, per_layer):
    calls = []
    plain = tflash.flash_attention_reference
    monkeypatch.setattr(tflash, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    cfg = TConfig(**SMALL, force_flash=True, recompute=recompute,
                  remat_save_attn=save_attn)
    step, params, mom, (ids, labels) = tspmd.build_spmd_train_step(
        cfg, batch_size=2, seq_len=16, num_micro=1, device="cpu")
    step(params, mom, ids, labels)
    assert len(calls) == per_layer * cfg.num_layers


def test_step_counters_and_in_place_update():
    steps = default_registry.counter("train_steps")
    secs = default_registry.counter("train_dispatch_seconds")
    n0, s0 = steps.value, secs.value
    cfg = TConfig(**SMALL)
    step, params, mom, batch = tspmd.build_spmd_train_step(
        cfg, batch_size=2, seq_len=16, device="cpu")
    wqkv = params["stages"]["wqkv"]
    before = wqkv.detach().clone()
    out_params, out_mom, loss = step(params, mom, *batch)
    assert out_params is params and out_mom is mom
    assert out_params["stages"]["wqkv"] is wqkv          # updated in place
    assert not torch.equal(wqkv.detach(), before)
    assert steps.value == n0 + 1 and secs.value == s0    # 1st call untimed
    step(params, mom, *batch)
    assert steps.value == n0 + 2 and secs.value > s0


def test_init_params_layout_and_seed():
    cfg = TConfig(**SMALL)
    a = tspmd.init_params(cfg, seed=5, device="cpu")
    b = tspmd.init_params(cfg, seed=5, device="cpu")
    shapes = dict(tspmd.leaves(tspmd.param_shapes(cfg)))
    jshapes = {p: s[1:] if p.startswith("stages/") else s
               for p, s in tspmd.leaves(jax.tree.map(
                   lambda x: x.shape,
                   jspmd.init_params(JConfig(**SMALL), jspmd.make_mesh(1))))}
    assert shapes == jshapes
    for path, t in tspmd.leaves(a):
        assert tuple(t.shape) == shapes[path]
        assert torch.equal(t, dict(tspmd.leaves(b))[path])
    assert abs(a["tok_emb"].std().item() - 0.2) < 0.01
    assert torch.equal(a["stages"]["ln1_g"], torch.ones(2, 64))
    assert not a["stages"]["b1"].any()


def test_convert_round_trip_and_random_params():
    cfg = TConfig(**SMALL)
    tree = _np_tree(jspmd.init_params(JConfig(**SMALL), jspmd.make_mesh(1)))
    back = train_params_to_numpy(train_params_from_jax_numpy(tree,
                                                             device="cpu"))
    _assert_trees_close(back, tree, "round trip")
    rand = random_train_params(cfg, seed=0)
    assert {p: a.shape for p, a in tspmd.leaves(rand)} == dict(
        tspmd.leaves(tspmd.param_shapes(cfg)))
    step, params, _, _ = tspmd.build_spmd_train_step(
        cfg, batch_size=2, seq_len=16, device="cpu", params=rand)
    np.testing.assert_array_equal(params["stages"]["w1"].numpy(),
                                  rand["stages"]["w1"])
    bad = dict(rand, lnf_g=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="lnf_g"):
        tspmd.build_spmd_train_step(cfg, batch_size=2, seq_len=16,
                                    device="cpu", params=bad)


def test_unported_options_raise():
    cfg = TConfig(**SMALL)
    kw = dict(batch_size=2, seq_len=16, device="cpu")
    for mesh in ({"dp": 2, "pp": 1, "mp": 1}, {"dp": 1, "pp": 2, "mp": 1},
                 {"dp": 1, "pp": 1, "mp": 2}):
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            tspmd.build_spmd_train_step(cfg, mesh, **kw)
    with pytest.raises(NotImplementedError, match="zero_stage"):
        tspmd.build_spmd_train_step(cfg, zero_stage=1, **kw)
    with pytest.raises(NotImplementedError, match="comm_quant"):
        tspmd.build_spmd_train_step(cfg, comm_quant="int8", **kw)
    for over in (dict(moe_experts=2),
                 dict(recompute=True, remat_save_ln=True)):
        with pytest.raises(NotImplementedError, match="later|slice"):
            tspmd.build_spmd_train_step(TConfig(**SMALL, **over), **kw)
    tspmd.build_spmd_train_step(cfg, {"dp": 1, "pp": 1, "mp": 1}, **kw)
    tspmd.build_spmd_train_step(
        TConfig(**SMALL, **FUSED, recompute=True, remat_save_ln=True), **kw)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tspmd.build_spmd_train_step(TConfig(**SMALL), batch_size=2,
                                    seq_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tspmd.init_params(TConfig(**SMALL))
