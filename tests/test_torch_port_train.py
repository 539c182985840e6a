"""The CAAT fine-tuning step of the torch port against the JAX package.

Tiny dims (``tests/test_caat.py`` W2V_TINY/CAAT_TINY), float32, seeded
numpy weights converted by ``checkpoint/convert.py``.  Every dropout,
layerdrop and ``rand_pos_decoder`` is 0: the two packages draw their
randomness from different streams by design (PARITY.md:222), so parity
holds with it off.  ``feature_grad_mult`` is 0.1 in the cases named
``fgm``, 1.0 elsewhere.

- ``joint_h`` of ``W2V2CaatModel.forward`` against JAX
  ``model.apply(train=True)``;
- ``caat_loss`` and its logs against JAX, and their invariance to
  ``tokens_per_step`` (the chunking);
- every parameter's gradient against ``jax.grad``;
- the parameters after 2 updates against JAX ``make_train_step`` (clip 2.0,
  weight decay 0.01, ``inverse_sqrt`` and ``polynomial_decay``), with and
  without 2-step accumulation;
- the non-finite skip, the four LR schedules, ``sample_context_bucket``
  and the freeze mask.

Tolerances: losses rtol 1e-5; gradients rtol 1e-4 with an atol of 1e-6 of
the largest gradient (the k-projection biases have a true gradient of 0,
so both packages give rounding noise there); parameters after the updates
atol 1e-2 * lr, a hundredth of one step.
"""

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_import import jax_caat, port_caat
from wav2vec_s_tpu.train import lr_schedules as jax_schedules
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu.train.optim import OptimConfig as JaxOptimConfig
from wav2vec_s_tpu.train.optim import build_optimizer as jax_build_optimizer
from wav2vec_s_tpu.train.step import TrainState as JaxTrainState
from wav2vec_s_tpu.train.step import make_train_step as jax_make_train_step
from wav2vec_s_tpu_torch.checkpoint.convert import caat_state_dict_from_jax
from wav2vec_s_tpu_torch.models.caat.transducer_model import caat_loss
from wav2vec_s_tpu_torch.train import lr_schedules
from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
from wav2vec_s_tpu_torch.train.recipes import (
    DEFAULT_CONTEXT_BUCKETS, make_caat_loss_fn, make_freeze_mask,
    sample_context_bucket)
from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

W2V = dataclasses.replace(W2V_TINY, dropout=0.0, attention_dropout=0.0,
                          activation_dropout=0.0, encoder_layerdrop=0.0)
W2V_FGM = dataclasses.replace(W2V, feature_grad_mult=0.1)
CAAT = dataclasses.replace(CAAT_TINY, rand_pos_decoder=0)
JAX_RNG = jax.random.PRNGKey(0)


def make_batch(seed=0, B=3, S=2400, U=6):
    """Seeded noise audio (row 2 padded from sample 1800) and random
    targets ending in eos (row 1 three labels shorter)."""
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((B, S)) * 0.3).astype(np.float32)
    tgt = rng.integers(4, CAAT.vocab_size, (B, U)).astype(np.int32)
    tgt[:, -1] = CAAT.eos
    tgt[1, 3:] = CAAT.pad
    tgt[1, 2] = CAAT.eos
    pad = np.zeros((B, S), bool)
    pad[2, 1800:] = True
    return {"source": src, "targets": tgt, "padding_mask": pad}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def prev_tokens(tgt):
    return np.concatenate([np.full((tgt.shape[0], 1), CAAT.bos, np.int32),
                           tgt], axis=1)


@functools.lru_cache(maxsize=None)
def jax_grads(w2v):
    """JAX (loss, logs, grads) of the CAAT recipe's loss on make_batch()."""
    model, params = jax_caat(w2v, CAAT)
    loss_fn = jax_recipes.make_caat_loss_fn(model, CAAT)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, (n, logs)), grads = grad_fn(params, to_jax(make_batch()), JAX_RNG,
                                       0)
    return float(loss), float(n), jax.device_get(logs), jax.device_get(grads)


def port_loss(model, batch, tokens_per_step=CAAT.tokens_per_step):
    cfg = dataclasses.replace(CAAT, tokens_per_step=tokens_per_step)
    tb = to_torch(batch)
    prev = torch.from_numpy(prev_tokens(batch["targets"])).long()
    joint_h, glens = model(tb["source"], prev, tb["padding_mask"])
    tgt_lens = (tb["targets"] != CAAT.pad).sum(1).to(torch.int32)
    return caat_loss(joint_h, model.decoder.lm.embed_tokens.weight,
                     tb["targets"], glens, tgt_lens, cfg)


def test_joint_h_matches_jax():
    model_j, params = jax_caat(W2V, CAAT)
    batch = make_batch()
    prev = prev_tokens(batch["targets"])
    want, want_g = jax.jit(lambda p, s, t, m: model_j.apply(
        {"params": p}, s, t, padding_mask=m, train=True,
        rngs={"dropout": JAX_RNG, "layerdrop": JAX_RNG,
              "rand_pos": JAX_RNG}))(
        params, jnp.asarray(batch["source"]), jnp.asarray(prev),
        jnp.asarray(batch["padding_mask"]))
    model = port_caat(params, W2V, CAAT)
    got, got_g = model(torch.from_numpy(batch["source"]),
                       torch.from_numpy(prev).long(),
                       torch.from_numpy(batch["padding_mask"]))
    assert got.shape == want.shape == (3, 15, 7, CAAT.jointer_embed_dim)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))


def test_output_logits_match_jax():
    caat = CAAT                   # the JAX init builds no untied out_proj
    model_j, params = jax_caat(W2V, caat)
    h = np.random.default_rng(5).standard_normal(
        (2, 3, 4, caat.decoder_embed_dim)).astype(np.float32)
    want = model_j.apply({"params": params}, jnp.asarray(h),
                         method=type(model_j).output_logits)
    got = port_caat(params, W2V, caat).output_logits(torch.from_numpy(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# chunk_b = 1 (200 // (15 * 7)), 1 (a budget under one row), 3 (all rows)
@pytest.mark.parametrize("tokens_per_step", [200, 30, 6000])
def test_caat_loss_and_logs_match_jax(tokens_per_step):
    want_loss, want_n, want_logs, _ = jax_grads(W2V)
    model = port_caat(jax_caat(W2V, CAAT)[1], W2V, CAAT)
    loss, logs = port_loss(model, make_batch(), tokens_per_step)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert logs.pop("sample_size").item() == want_n == 15
    assert sorted(logs) == sorted(want_logs)
    for k, v in logs.items():
        np.testing.assert_allclose(v.item(), want_logs[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def _assert_grads_equal(model, want_tree):
    want = caat_state_dict_from_jax(want_tree)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    named = dict(model.named_parameters())
    assert named.keys() == want.keys() - {"decoder.lm.version",
                                          "decoder.transducer_out."
                                          "output_proj.weight"}
    for name, p in named.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(g, want[name].numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)


@pytest.mark.parametrize("w2v", [W2V, W2V_FGM], ids=["plain", "fgm"])
def test_every_gradient_matches_jax(w2v):
    _, _, _, want = jax_grads(w2v)
    model = port_caat(jax_caat(w2v, CAAT)[1], w2v, CAAT)
    loss, _ = port_loss(model, make_batch())
    loss.backward()
    _assert_grads_equal(model, want)


def _optim(sched):
    kw = dict(lr=1e-3, clip_norm=2.0, weight_decay=0.01,
              lr_scheduler=sched, warmup_updates=2, total_updates=10)
    return JaxOptimConfig(**kw), OptimConfig(**kw)


@pytest.mark.parametrize("sched,accum,w2v", [
    ("inverse_sqrt", 1, W2V_FGM), ("polynomial_decay", 1, W2V),
    ("inverse_sqrt", 2, W2V)], ids=["inverse_sqrt-fgm", "polynomial_decay",
                                    "inverse_sqrt-accum2"])
def test_params_after_two_updates_match_jax(sched, accum, w2v):
    jcfg, cfg = _optim(sched)
    model_j, params = jax_caat(w2v, CAAT)
    batches = [make_batch(seed) for seed in range(2 * accum)]

    def stack(bs):
        return {k: np.stack([b[k] for b in bs]) for k in bs[0]}

    jopt = jax_build_optimizer(jcfg)
    jstep = jax.jit(jax_make_train_step(
        jax_recipes.make_caat_loss_fn(model_j, CAAT), jopt,
        accum_steps=accum))
    jstate = JaxTrainState.create(params, jopt)
    model = port_caat(params, w2v, CAAT)
    opt = build_optimizer(cfg)
    state = TrainState.create(model, opt)
    step = make_train_step(make_caat_loss_fn(model, CAAT), opt,
                           accum_steps=accum)
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        mb = batches[i * accum:(i + 1) * accum]
        b = mb[0] if accum == 1 else stack(mb)
        jstate, jlogs = jstep(jstate, to_jax(b), JAX_RNG)
        state, logs = step(state, to_torch(b), gen)
        for k in ("loss_total", "sample_size", "grad_norm", "skipped"):
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       rtol=1e-5, err_msg=k)
        assert float(logs["grad_norm"]) > jcfg.clip_norm     # clip active
    assert state.step == 2 and state.opt_state.count == 2
    want = caat_state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-2 * jcfg.lr,
                                   err_msg=name)


def test_skip_nonfinite_leaves_params_and_optimizer_untouched():
    _, cfg = _optim("polynomial_decay")
    model = port_caat(jax_caat(W2V, CAAT)[1], W2V, CAAT)
    opt = build_optimizer(cfg)
    state = TrainState.create(model, opt)
    loss_fn = make_caat_loss_fn(model, CAAT)
    poison = [False]

    def maybe_nan(batch, gen, step):
        loss, n, logs = loss_fn(batch, gen, step)
        return (loss * float("nan") if poison[0] else loss), n, logs

    step = make_train_step(maybe_nan, opt)
    gen = torch.Generator().manual_seed(0)
    batch = to_torch(make_batch())
    for _ in range(2):            # sched(0) = 0 under the warmup: 2 steps
        state, logs = step(state, batch, gen)
        assert logs["skipped"].item() == 0.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [t.clone() for t in state.opt_state.mu + state.opt_state.nu]
    poison[0] = True
    state, logs = step(state, batch, gen)
    assert logs["skipped"].item() == 1.0
    assert not np.isfinite(logs["grad_norm"].item())
    assert state.step == 3 and state.opt_state.count == 2
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    assert all(torch.equal(a, b) for a, b in zip(
        moments, state.opt_state.mu + state.opt_state.nu))
    assert all(p.grad is None for p in model.parameters())
    # the next good update applies sched(2), not sched(3)
    assert state.opt_state.count == 2         # next lr: schedule(2)
    poison[0] = False
    state, logs = step(state, batch, gen)
    assert logs["skipped"].item() == 0.0 and state.opt_state.count == 3


SCHEDULE_ARGS = {
    "polynomial_decay": (5e-4, 10, 100),
    "inverse_sqrt": (5e-4, 10, 1e-7),
    "cosine": (5e-4, 10, 100),
    "tri_stage": (5e-4, 10, 30, 60),
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_ARGS))
def test_lr_schedules_match_jax(name):
    args = SCHEDULE_ARGS[name]
    mine = lr_schedules.SCHEDULES[name](*args)
    theirs = jax_schedules.SCHEDULES[name](*args)
    for step in (0, 1, 5, 9, 10, 11, 39, 40, 55, 99, 100, 150):
        # JAX evaluates in float32 (1 + cos near pi cancels): atol a
        # millionth of the peak rate
        np.testing.assert_allclose(mine(step), float(theirs(step)),
                                   rtol=1e-6, atol=1e-6 * args[0],
                                   err_msg=f"{name} step {step}")


def test_sample_context_bucket_matches_jax():
    a, b = random.Random(7), random.Random(7)
    for _ in range(300):
        assert (sample_context_bucket(a, DEFAULT_CONTEXT_BUCKETS)
                == jax_recipes.sample_context_bucket(
                    b, jax_recipes.DEFAULT_CONTEXT_BUCKETS))
    assert DEFAULT_CONTEXT_BUCKETS == jax_recipes.DEFAULT_CONTEXT_BUCKETS


@pytest.mark.parametrize("freeze_enc,freeze_updates,step", [
    (1, 0, 0), (0, 5, 3), (0, 5, 5), (1, 5, 7)])
def test_freeze_mask_matches_jax(freeze_enc, freeze_updates, step):
    _, params = jax_caat(W2V, CAAT)
    ones = jax.tree_util.tree_map(np.ones_like, params)
    want = caat_state_dict_from_jax(jax.device_get(
        jax_recipes.make_freeze_mask(freeze_enc, freeze_updates)(ones,
                                                                 step)))
    model = port_caat(params, W2V, CAAT)
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    make_freeze_mask(model, freeze_enc, freeze_updates)(grads, step)
    for name, g in grads.items():
        np.testing.assert_array_equal(g.numpy(), want[name].numpy(),
                                      err_msg=name)
    frozen = sum(int(g.sum() == 0) for g in grads.values())
    assert 0 < frozen < len(grads) or (freeze_updates and step >= 5
                                       and not freeze_enc)
