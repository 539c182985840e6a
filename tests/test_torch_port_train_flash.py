"""CAAT fine-tuning on ``attention_impl="flash"``: the port against the JAX
package, and against its own dense attention.

Tiny dims, float32, seeded numpy weights through ``checkpoint/convert.py``;
the encoder is 32 wide with 4 heads (dh 8), so that the JAX side runs its
Pallas forward and backward kernels in interpret mode (at dh 6 it takes
its jnp fallback); the port runs the flash twins through the wrapper's
``torch.autograd.Function``.

- dropout off (the two packages draw from different streams): ``joint_h``,
  the loss, every parameter's gradient and the parameters after 2 updates
  equal the JAX package's, at the tolerances ``test_torch_port_train.py``
  uses for dense attention (loss rtol 1e-5; gradients rtol 1e-4 with an
  atol of 1e-6 of the largest gradient; parameters atol 1e-2 * lr);
- dropout ON, the recipe's rates: flash training equals dense training in
  the port under one seed (the flash kernels' mask is the one the dense
  branch draws at that site): loss rtol 1e-5, gradients as above, and the
  two runs consume the same number of dropout sites.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_import import jax_caat, port_caat
from tests.test_torch_port_oneshot import W2V_DH8
from tests.test_torch_port_train import (
    CAAT, JAX_RNG, _assert_grads_equal, _optim, make_batch, prev_tokens,
    to_jax, to_torch)
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu.train.optim import build_optimizer as jax_build_optimizer
from wav2vec_s_tpu.train.step import TrainState as JaxTrainState
from wav2vec_s_tpu.train.step import make_train_step as jax_make_train_step
from wav2vec_s_tpu_torch.checkpoint.convert import caat_state_dict_from_jax
from wav2vec_s_tpu_torch.ops import dropout as port_dropout
from wav2vec_s_tpu_torch.train import recipes
from wav2vec_s_tpu_torch.train.optim import build_optimizer
from wav2vec_s_tpu_torch.train.recipes import make_caat_loss_fn
from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
               encoder_layerdrop=0.0)
FLASH = dataclasses.replace(W2V_DH8, attention_impl="flash", **NO_DROP)
DENSE = dataclasses.replace(FLASH, attention_impl="dense")


def test_flash_joint_h_loss_and_gradients_match_jax():
    model_j, params = jax_caat(FLASH, CAAT)
    batch = make_batch()
    prev = prev_tokens(batch["targets"])
    want_h, _ = jax.jit(lambda p, s, t, m: model_j.apply(
        {"params": p}, s, t, padding_mask=m, train=True,
        rngs={"dropout": JAX_RNG, "layerdrop": JAX_RNG,
              "rand_pos": JAX_RNG}))(
        params, jnp.asarray(batch["source"]), jnp.asarray(prev),
        jnp.asarray(batch["padding_mask"]))
    model = port_caat(params, FLASH, CAAT)
    got_h, _ = model(torch.from_numpy(batch["source"]),
                     torch.from_numpy(prev).long(),
                     torch.from_numpy(batch["padding_mask"]))
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h),
                               rtol=1e-4, atol=1e-5)

    loss_fn = jax_recipes.make_caat_loss_fn(model_j, CAAT)
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, to_jax(batch), JAX_RNG, 0)
    loss, _, _ = make_caat_loss_fn(model, CAAT)(
        to_torch(batch), torch.Generator().manual_seed(0), 0)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    _assert_grads_equal(model, jax.device_get(want_grads))


def test_flash_params_after_two_updates_match_jax():
    jcfg, cfg = _optim("inverse_sqrt")
    model_j, params = jax_caat(FLASH, CAAT)
    jopt = jax_build_optimizer(jcfg)
    jstep = jax.jit(jax_make_train_step(
        jax_recipes.make_caat_loss_fn(model_j, CAAT), jopt))
    jstate = JaxTrainState.create(params, jopt)
    model = port_caat(params, FLASH, CAAT)
    opt = build_optimizer(cfg)
    state = TrainState.create(model, opt)
    step = make_train_step(make_caat_loss_fn(model, CAAT), opt)
    gen = torch.Generator().manual_seed(0)
    for seed in range(2):
        b = make_batch(seed)
        jstate, jlogs = jstep(jstate, to_jax(b), JAX_RNG)
        state, logs = step(state, to_torch(b), gen)
        for k in ("loss_total", "sample_size", "grad_norm", "skipped"):
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       rtol=1e-5, err_msg=k)
    want = caat_state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-2 * jcfg.lr, err_msg=name)


@pytest.mark.parametrize("layerdrop", [0.0, 0.5])
def test_flash_equals_dense_with_dropout_on_under_one_seed(layerdrop,
                                                           monkeypatch):
    rates = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
                 encoder_layerdrop=layerdrop)
    caat = dataclasses.replace(CAAT, rand_pos_decoder=30, dropout=0.3,
                               attention_dropout=0.1, activation_dropout=0.1)
    _, params = jax_caat(FLASH, CAAT)
    contexts = []

    class Recorded(port_dropout.DropoutContext):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            contexts.append(self)

    monkeypatch.setattr(recipes, "DropoutContext", Recorded)
    runs = {}
    for impl in ("flash", "dense"):
        w2v = dataclasses.replace(FLASH, attention_impl=impl, **rates)
        model = port_caat(params, w2v, caat)
        loss, n, _ = make_caat_loss_fn(model, caat)(
            to_torch(make_batch()), torch.Generator().manual_seed(7), 0)
        loss.backward()
        runs[impl] = (loss.item(), {k: p.grad for k, p in
                                    model.named_parameters()})
    assert contexts[0].seed == contexts[1].seed
    assert contexts[0].sites == contexts[1].sites >= 18
    (lf, gf), (ld, gd) = runs["flash"], runs["dense"]
    np.testing.assert_allclose(lf, ld, rtol=1e-5)
    scale = max(float(g.abs().max()) for g in gd.values() if g is not None)
    for name, g in gd.items():
        if g is None:                 # a layer that layerdrop skipped
            assert gf[name] is None, name
            continue
        np.testing.assert_allclose(gf[name].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)
