"""wav2vec-S pre-training in the torch port against the JAX package.

Tiny dims (``tests/test_caat.py`` W2V_TINY: conv hop 20, 2 layers of 24
wide, 4 heads), float32, seeded numpy weights carried across by
``checkpoint.convert.wav2vec2_state_dict_from_jax``; 3 rows of 2400
samples (119 frames), 56 masked frames per row, 10 negatives, a codebook
of 2 groups of 4 codes, so that distractors with the positive's codes are
common (their logits are ``-inf`` in both packages).  Every dropout and
layerdrop is off.  The two packages draw their randomness differently, so
the JAX draw sites are patched in the test process to return the port's
draws: ``Wav2Vec2Model._negative_indices`` (the negatives) and the
quantizer module's ``jax.random.uniform`` (the Gumbel uniforms).  The port
takes them from one host generator, reset to one seed before each update,
so the same draws serve both updates of the JAX step, jitted once.

- the forward's logits and diagnostics, the loss and its logs, every
  gradient, at context buckets (8, 4) and (12, 6), with quantized targets
  and (through the criterion with one loss weight, as the JAX recipe's
  default weights refuse them) unquantized ones;
- the parameters after two Adam updates of ``make_pretrain_loss_fn`` +
  ``make_train_step``;
- eval mode (hard codes, no noise): the forward and the loss;
- the contrastive head on planted duplicates: code indices, and vectors
  without a quantizer.

The quantizer alone: ``tests/test_torch_port_quantizer.py``.

Tolerances: logits and losses rtol 1e-5; gradients rtol 1e-5 with an atol
of 1e-6 of the largest gradient (the k-projection biases have a true
gradient of 0: both packages give rounding noise there); parameters after
the updates atol 1e-2 * lr.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import W2V_TINY
from tests.test_torch_port_import import port_cfg
from wav2vec_s_tpu.models import quantizer as jax_quantizer
from wav2vec_s_tpu.models.wav2vec2 import Wav2Vec2Model as JaxW2V
from wav2vec_s_tpu.train import criterion as jax_criterion
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu.train.optim import OptimConfig as JaxOptimConfig
from wav2vec_s_tpu.train.optim import build_optimizer as jax_build_optimizer
from wav2vec_s_tpu.train.step import TrainState as JaxTrainState
from wav2vec_s_tpu.train.step import make_train_step as jax_make_train_step
from wav2vec_s_tpu.utils.masking import (
    compute_span_mask_np, expected_mask_count)
from wav2vec_s_tpu_torch.checkpoint.convert import (
    wav2vec2_state_dict_from_jax)
from wav2vec_s_tpu_torch.models import Wav2Vec2Config, Wav2Vec2Model
from wav2vec_s_tpu_torch.models import wav2vec2 as port_wav2vec2
from wav2vec_s_tpu_torch.ops import dropout as port_dropout
from wav2vec_s_tpu_torch.train.criterion import wav2vec_loss
from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
from wav2vec_s_tpu_torch.train.recipes import make_pretrain_loss_fn
from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

torch.set_num_threads(1)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
               encoder_layerdrop=0.0, dropout_input=0.0,
               dropout_features=0.0)
W2V = dataclasses.replace(W2V_TINY, latent_vars=4, n_negatives=10,
                          feature_grad_mult=0.1, **NO_DROP)
W2V_UNQ = dataclasses.replace(W2V, quantize_targets=False)
B, S = 3, 2400
JAX_RNG = jax.random.PRNGKey(0)


@functools.lru_cache(maxsize=None)
def jax_w2v(cfg=W2V, seed=2):
    """(flax pre-training model, numpy params) filled like
    ``test_torch_port_import.jax_caat``."""
    model = JaxW2V(cfg, encoder_type="blockwise")
    shapes = jax.eval_shape(lambda: model.init(
        {n: jax.random.PRNGKey(0) for n in
         ("params", "dropout", "gumbel", "negatives", "layerdrop")},
        jnp.zeros((1, S)), jnp.zeros((1, 4), jnp.int32), 0,
        train=False))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:
            return n * float(np.prod(leaf.shape[:-1])) ** -0.5
        scale = getattr(path[-1], "key", None) == "scale"
        return (1.0 if scale else 0.0) + 0.2 * n

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def port_w2v(params, cfg=W2V) -> Wav2Vec2Model:
    model = Wav2Vec2Model(port_cfg(Wav2Vec2Config, cfg), pretraining=True)
    model.load_state_dict(wav2vec2_state_dict_from_jax(params), strict=True)
    return model


def make_batch(seed=0, cfg=W2V):
    """Seeded noise audio and masked positions of one exact count per row
    (the batcher's masker)."""
    from wav2vec_s_tpu.models.feature_extractor import conv_output_length

    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((B, S)) * 0.3).astype(np.float32)
    frames = conv_output_length(S, cfg.conv_feature_layers)
    M = expected_mask_count(frames)
    mask = compute_span_mask_np((B, frames), None, 0.65, 10, rng,
                                exact_count=M)
    pos = np.stack([np.flatnonzero(r)[:M] for r in mask]).astype(np.int32)
    return {"source": src, "mask_positions": pos}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class Draws:
    """Records the port's host draws (Gumbel uniforms, negatives) and
    plants the same ones at the JAX package's draw sites."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.uniform = self.negatives = None
        real_uniform = port_dropout.DropoutContext.uniform
        real_neg = port_wav2vec2.Wav2Vec2Model._negative_indices

        def uniform(ctx, shape):
            self.uniform = real_uniform(ctx, shape)
            return self.uniform

        def negatives(model, B_, M, ctx, shard=None):
            self.negatives = real_neg(model, B_, M, ctx, shard)
            return self.negatives

        monkeypatch.setattr(port_dropout.DropoutContext, "uniform", uniform)
        monkeypatch.setattr(port_wav2vec2.Wav2Vec2Model,
                            "_negative_indices", negatives)

    def plant(self):
        """The recorded draws at the JAX draw sites."""
        neg = jnp.asarray(self.negatives.numpy().astype(np.int32))
        self.mp.setattr(JaxW2V, "_negative_indices",
                        lambda model, B_, M: neg)
        if self.uniform is not None:
            plant_uniform(self.mp, self.uniform.numpy())


def plant_uniform(monkeypatch, u):
    """The JAX quantizer's ``jax.random.uniform`` returns ``u``."""
    u = jnp.asarray(u)

    class Random:
        def __getattr__(self, name):
            return getattr(jax.random, name)

        def uniform(self, key, shape, minval=0.0, maxval=1.0):
            assert tuple(shape) == u.shape, (shape, u.shape)
            return u

    class Jax:
        random = Random()

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(jax_quantizer, "jax", Jax())


def _jax_rngs():
    return {n: JAX_RNG for n in ("dropout", "gumbel", "negatives",
                                 "layerdrop")}


def _assert_grads_equal(model, want_tree):
    want = wav2vec2_state_dict_from_jax(want_tree)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    named = dict(model.named_parameters())
    assert named.keys() == want.keys()
    for name, p in named.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(g, want[name].numpy(), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=name)


def _loss_logs_equal(logs, want_logs):
    assert sorted(logs) == sorted(k for k, v in want_logs.items()
                                  if k != "sample_size")
    for k, v in logs.items():
        np.testing.assert_allclose(float(v), float(want_logs[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("ctx", [(8, 4), (12, 6)], ids=["8-4", "12-6"])
def test_logits_loss_logs_and_gradients_match_jax(ctx, monkeypatch):
    mc, rc = ctx
    model_j, params = jax_w2v()
    batch = make_batch()
    draws = Draws(monkeypatch)
    model = port_w2v(params)
    gen = torch.Generator().manual_seed(0)
    out = model(*to_torch(batch).values(), 3, main_context=mc,
                right_context=rc,
                ctx=port_dropout.DropoutContext(gen))
    draws.plant()
    want = jax.jit(lambda p, s, m: model_j.apply(
        {"params": p}, s, m, 3, main_context=mc, right_context=rc,
        train=True, rngs=_jax_rngs()))(params, *to_jax(batch).values())
    logits = out["logits"].detach().numpy()
    assert logits.shape == (B, 56, 11)
    np.testing.assert_array_equal(np.isinf(logits),
                                  np.isinf(np.asarray(want["logits"])))
    assert 0 < np.isinf(logits).sum() < logits.size // 2     # duplicates
    np.testing.assert_allclose(logits, np.asarray(want["logits"]),
                               rtol=1e-5, atol=1e-5)
    for k in ("features_pen", "prob_perplexity", "code_perplexity", "temp"):
        np.testing.assert_allclose(float(out[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)

    loss_fn = jax_recipes.make_pretrain_loss_fn(model_j, mc, rc)
    (want_loss, (want_n, want_logs)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        params, to_jax(batch), JAX_RNG, 3)
    model = port_w2v(params)
    loss, n, logs = make_pretrain_loss_fn(model, mc, rc)(
        to_torch(batch), torch.Generator().manual_seed(0), 3)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert n == int(want_n) == B * 56
    _loss_logs_equal(logs, want_logs)
    loss.backward()
    _assert_grads_equal(model, jax.device_get(want_grads))


def test_unquantized_targets_match_jax(monkeypatch):
    """No quantizer: ``project_q`` reads the unmasked features, the
    distractors are gathered vectors.  The JAX recipe's default loss
    weights (two) refuse a run without the diversity term, in both
    packages; the loss here takes one weight, for features_pen."""
    model_j, params = jax_w2v(W2V_UNQ)
    batch = make_batch(1)
    draws = Draws(monkeypatch)
    model = port_w2v(params, W2V_UNQ)
    gen = torch.Generator().manual_seed(4)
    out = model(*to_torch(batch).values(), 0, main_context=8,
                right_context=4, ctx=port_dropout.DropoutContext(gen))
    with pytest.raises(ValueError, match="2 loss weights for 1"):
        wav2vec_loss(out)
    loss, _, logs = wav2vec_loss(out, loss_weights=(10.0,))
    loss.backward()
    draws.plant()
    assert draws.uniform is None

    def jax_loss(p, b):
        o = model_j.apply({"params": p}, b["source"], b["mask_positions"],
                          0, main_context=8, right_context=4, train=True,
                          rngs=_jax_rngs())
        lo, _, lg = jax_criterion.wav2vec_loss(o, loss_weights=(10.0,))
        return lo, (o["logits"], lg)

    (want_loss, (want_logits, want_logs)), grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(params, to_jax(batch))
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               np.asarray(want_logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for k in ("loss_infonce", "loss_extra_0", "correct", "count"):
        np.testing.assert_allclose(float(logs[k]), float(want_logs[k]),
                                   rtol=1e-5, err_msg=k)
    assert logs["prob_perplexity"] is None
    _assert_grads_equal(model, jax.device_get(grads))


def test_params_after_two_updates_match_jax(monkeypatch):
    kw = dict(lr=1e-3, weight_decay=0.01, lr_scheduler="inverse_sqrt",
              warmup_updates=2, total_updates=10)
    model_j, params = jax_w2v()
    batches = [make_batch(seed) for seed in range(2)]
    draws = Draws(monkeypatch)
    model = port_w2v(params)
    opt = build_optimizer(OptimConfig(**kw))
    state = TrainState.create(model, opt)
    step = make_train_step(make_pretrain_loss_fn(model, 8, 4), opt)
    port_logs = []
    for b in batches:         # one seed per update: the same draws twice
        state, logs = step(state, to_torch(b),
                           torch.Generator().manual_seed(0))
        port_logs.append(logs)
    draws.plant()
    jopt = jax_build_optimizer(JaxOptimConfig(**kw))
    jstep = jax.jit(jax_make_train_step(
        jax_recipes.make_pretrain_loss_fn(model_j, 8, 4), jopt))
    jstate = JaxTrainState.create(params, jopt)
    for b, logs in zip(batches, port_logs):
        jstate, jlogs = jstep(jstate, to_jax(b), JAX_RNG)
        for k in ("loss_total", "sample_size", "grad_norm", "skipped",
                  "loss_infonce", "correct", "temp", "prob_perplexity"):
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       rtol=1e-5, err_msg=k)
    assert state.step == 2 and state.opt_state.count == 2
    want = wav2vec2_state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-2 * kw["lr"],
                                   err_msg=name)


def test_eval_mode_forward_and_loss_match_jax(monkeypatch):
    """Eval mode: no dropout, the hard codes, negatives of a fixed seed
    (drawn without a generator argument; the JAX forward takes them
    planted)."""
    model_j, params = jax_w2v()
    batch = make_batch(2)
    draws = Draws(monkeypatch)
    model = port_w2v(params)
    with torch.no_grad():
        loss, _, logs = make_pretrain_loss_fn(model, 12, 6, train=False)(
            to_torch(batch), None, 0)
        again = make_pretrain_loss_fn(model, 12, 6, train=False)(
            to_torch(batch), None, 0)[0]
    assert loss.item() == again.item()          # a fixed seed
    assert draws.uniform is None
    draws.plant()
    want_loss, (_, want_logs) = _jax_eval_loss(model_j, params, batch)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _loss_logs_equal(logs, want_logs)


def _jax_eval_loss(model_j, params, batch):
    def fn(p, b):
        o = model_j.apply({"params": p}, b["source"], b["mask_positions"],
                          0, main_context=12, right_context=6, train=False,
                          rngs=_jax_rngs())
        lo, _, lg = jax_criterion.wav2vec_loss(o)
        return lo, (None, lg)

    return jax.jit(fn)(params, to_jax(batch))


def test_contrastive_head_masks_planted_duplicates():
    """Codes: rows 0 and 2 of each utterance share every code, row 1
    shares one group only; vectors: rows 0 and 3 are equal.  A distractor
    equal to the positive is -inf, and only then."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 4, 6)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 4, 6)).astype(np.float32))
    codes = torch.tensor([[[1, 2], [1, 3], [1, 2], [0, 0]]] * 2)
    idxs = torch.tensor([[[2, 1, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]]] * 2)
    logits = port_wav2vec2.contrastive_logits(x, y, codes, idxs, 0.1)
    inf = torch.isinf(logits[:, :, 1:])
    want = torch.tensor([[True, False, False], [False, False, False],
                         [True, False, False], [False, False, False]])
    assert torch.equal(inf, want.expand(2, 4, 3))
    xn, yn = (t / t.norm(dim=-1, keepdim=True) for t in (x, y))
    np.testing.assert_allclose(logits[:, :, 0], (xn * yn).sum(-1) / 0.1,
                               rtol=1e-5)
    np.testing.assert_allclose(logits[0, 1, 1], (xn[0, 1] @ yn[0, 0]) / 0.1,
                               rtol=1e-5)
    y[:, 3] = y[:, 0]
    vec = port_wav2vec2.vector_logits(x, y, idxs, 0.1)
    inf = torch.isinf(vec[:, :, 1:])
    want = torch.zeros((4, 3), dtype=torch.bool)
    want[0, 2] = want[3, 0] = True
    assert torch.equal(inf, want.expand(2, 4, 3))
    out = {"logits": vec, "features_pen": torch.tensor(0.5),
           "prob_perplexity": torch.tensor(3.0), "num_vars": 8,
           "temp": torch.tensor(1.0)}
    loss, n, logs = wav2vec_loss(out)
    assert n == 8 and torch.isfinite(loss)
    # a frame whose logits all tie is not correct
    tied = {**out, "logits": torch.zeros((1, 2, 4))}
    assert int(wav2vec_loss(tied)[2]["correct"]) == 0
