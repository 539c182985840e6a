"""wav2vec-S pre-training on ``attention_impl="flash"``: the port against
the JAX package, and against its own dense attention.

The setting of ``tests/test_torch_port_pretrain.py`` with an encoder 32
wide of 4 heads (dh 8), so that the JAX side runs its Pallas forward and
backward kernels in interpret mode; the port runs the flash twins through
the wrapper's ``torch.autograd.Function``.

- dropout off, the JAX draw sites planted with the port's draws: logits,
  loss and logs, every gradient at context buckets (8, 4) and (12, 6), and
  the parameters after two Adam updates, at the dense file's tolerances;
- the recipe's dropouts on (dropout_input, dropout_features, the encoder's
  three sites, layerdrop): flash equals dense in the port under one seed,
  the two runs consuming the same dropout sites.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_pretrain import (
    JAX_RNG, W2V, Draws, _assert_grads_equal, _loss_logs_equal, jax_w2v,
    make_batch, port_w2v, to_jax, to_torch)
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu.train.optim import OptimConfig as JaxOptimConfig
from wav2vec_s_tpu.train.optim import build_optimizer as jax_build_optimizer
from wav2vec_s_tpu.train.step import TrainState as JaxTrainState
from wav2vec_s_tpu.train.step import make_train_step as jax_make_train_step
from wav2vec_s_tpu_torch.checkpoint.convert import (
    wav2vec2_state_dict_from_jax)
from wav2vec_s_tpu_torch.ops import dropout as port_dropout
from wav2vec_s_tpu_torch.train import recipes
from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
from wav2vec_s_tpu_torch.train.recipes import make_pretrain_loss_fn
from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

FLASH = dataclasses.replace(W2V, encoder_embed_dim=32,
                            encoder_ffn_embed_dim=64, attention_impl="flash")


@pytest.mark.parametrize("ctx", [(8, 4), (12, 6)], ids=["8-4", "12-6"])
def test_flash_loss_logs_and_gradients_match_jax(ctx, monkeypatch):
    mc, rc = ctx
    model_j, params = jax_w2v(FLASH)
    batch = make_batch(3)
    draws = Draws(monkeypatch)
    model = port_w2v(params, FLASH)
    loss, n, logs = make_pretrain_loss_fn(model, mc, rc)(
        to_torch(batch), torch.Generator().manual_seed(1), 2)
    loss.backward()
    draws.plant()
    loss_fn = jax_recipes.make_pretrain_loss_fn(model_j, mc, rc)
    (want_loss, (want_n, want_logs)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        params, to_jax(batch), JAX_RNG, 2)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert n == int(want_n)
    _loss_logs_equal(logs, want_logs)
    _assert_grads_equal(model, jax.device_get(want_grads))


def test_flash_params_after_two_updates_match_jax(monkeypatch):
    kw = dict(lr=1e-3, weight_decay=0.01, lr_scheduler="inverse_sqrt",
              warmup_updates=2, total_updates=10)
    model_j, params = jax_w2v(FLASH)
    batches = [make_batch(seed) for seed in (4, 5)]
    draws = Draws(monkeypatch)
    model = port_w2v(params, FLASH)
    opt = build_optimizer(OptimConfig(**kw))
    state = TrainState.create(model, opt)
    step = make_train_step(make_pretrain_loss_fn(model, 12, 6), opt)
    port_logs = []
    for b in batches:
        state, logs = step(state, to_torch(b),
                           torch.Generator().manual_seed(0))
        port_logs.append(logs)
    draws.plant()
    jopt = jax_build_optimizer(JaxOptimConfig(**kw))
    jstep = jax.jit(jax_make_train_step(
        jax_recipes.make_pretrain_loss_fn(model_j, 12, 6), jopt))
    jstate = JaxTrainState.create(params, jopt)
    for b, logs in zip(batches, port_logs):
        jstate, jlogs = jstep(jstate, to_jax(b), JAX_RNG)
        for k in ("loss_total", "grad_norm", "loss_infonce", "correct"):
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       rtol=1e-5, err_msg=k)
    want = wav2vec2_state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-2 * kw["lr"],
                                   err_msg=name)


@pytest.mark.parametrize("layerdrop", [0.0, 0.5])
def test_flash_equals_dense_with_dropout_on_under_one_seed(layerdrop,
                                                           monkeypatch):
    rates = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
                 encoder_layerdrop=layerdrop, dropout_input=0.1,
                 dropout_features=0.1)
    _, params = jax_w2v(FLASH)
    contexts = []

    class Recorded(port_dropout.DropoutContext):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            contexts.append(self)

    monkeypatch.setattr(recipes, "DropoutContext", Recorded)
    runs = {}
    for impl in ("flash", "dense"):
        cfg = dataclasses.replace(FLASH, attention_impl=impl, **rates)
        model = port_w2v(params, cfg)
        loss, _, _ = make_pretrain_loss_fn(model, 8, 4)(
            to_torch(make_batch()), torch.Generator().manual_seed(7), 0)
        loss.backward()
        runs[impl] = (loss.item(), {k: p.grad for k, p in
                                    model.named_parameters()})
    assert contexts[0].seed == contexts[1].seed
    assert contexts[0].sites == contexts[1].sites >= 3
    (lf, gf), (ld, gd) = runs["flash"], runs["dense"]
    np.testing.assert_allclose(lf, ld, rtol=1e-5)
    scale = max(float(g.abs().max()) for g in gd.values() if g is not None)
    for name, g in gd.items():
        if g is None:                 # a layer that layerdrop skipped
            assert gf[name] is None, name
            continue
        np.testing.assert_allclose(gf[name].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)
