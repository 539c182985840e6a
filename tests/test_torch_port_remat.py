"""Rematerialization of the torch port's train step (``train/remat.py``,
``run.remat``; ``Wav2Vec2Config.remat_extractor``) against the JAX
package's and against the port's own plain step.

- Against JAX (dropout off, as in ``tests/test_torch_port_train.py``):
  two updates of the CAAT recipe (dense attention) under each policy, and
  under ``remat_extractor``, against the JAX step built with the same
  policy and config (pre-training: ``tests/test_torch_port_remat_pretrain.py``).
- Against the port's plain step, with the recipes' randomness on (every
  dropout, layerdrop and decoder position offsets for CAAT; dropout_input,
  dropout_features, layerdrop, the negatives and the Gumbel noise for
  pre-training): three updates under each policy equal ``none`` (losses
  rtol 1e-6, every parameter rtol 1e-6), the update generator ends in the
  same state, each update's recompute takes the forward's seed and sites,
  and the dropout kernel's twin runs once more per forward site and no
  more (the backward's launches do not change).  Without the replay of
  ``ops.dropout.replayed`` the recompute draws new masks and this fails.

Tolerances (as the files above): losses rtol 1e-5; parameters after the
updates atol 1e-2 * lr.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests import test_torch_port_pretrain as pre
from tests import test_torch_port_train as caat_t
from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_import import jax_caat, port_caat
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu.train.optim import OptimConfig as JaxOptimConfig
from wav2vec_s_tpu.train.optim import build_optimizer as jax_build_optimizer
from wav2vec_s_tpu.train.step import TrainState as JaxTrainState
from wav2vec_s_tpu.train.step import make_train_step as jax_make_train_step
from wav2vec_s_tpu_torch.checkpoint.convert import caat_state_dict_from_jax
from wav2vec_s_tpu_torch.ops import dropout as port_dropout
from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
from wav2vec_s_tpu_torch.train.recipes import (
    make_caat_loss_fn, make_pretrain_loss_fn)
from wav2vec_s_tpu_torch.train.remat import REMAT_POLICIES
from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

torch.set_num_threads(1)

POLICIES = [p for p in REMAT_POLICIES if p != "none"]
OPTIM = dict(lr=1e-3, clip_norm=2.0, weight_decay=0.01,
             lr_scheduler="inverse_sqrt", warmup_updates=2, total_updates=10)
#: (policy, remat_extractor) against JAX
JAX_CASES = [(p, False) for p in POLICIES] + [("none", True),
                                              ("nothing", True)]


def _ids(cases):
    return [p + ("-extractor" if e else "") for p, e in cases]


def _port_step(model, loss_fn, policy):
    opt = build_optimizer(OptimConfig(**OPTIM))
    return (TrainState.create(model, opt),
            make_train_step(loss_fn, opt, remat_policy=policy))


def _jax_step(model_j, params, loss_fn, policy):
    jopt = jax_build_optimizer(JaxOptimConfig(**OPTIM))
    return (JaxTrainState.create(params, jopt),
            jax.jit(jax_make_train_step(loss_fn, jopt, remat_policy=policy)))


def _assert_logs(logs, jlogs, keys):
    for k in keys:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=1e-5, err_msg=k)


def _assert_params(model, want):
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-2 * OPTIM["lr"],
                                   err_msg=name)


@pytest.mark.parametrize("policy,extractor", JAX_CASES,
                         ids=_ids(JAX_CASES))
def test_caat_updates_match_jax_under_the_policy(policy, extractor):
    w2v = dataclasses.replace(caat_t.W2V, remat_extractor=extractor)
    model_j, params = jax_caat(w2v, caat_t.CAAT)
    model = port_caat(params, w2v, caat_t.CAAT)
    state, step = _port_step(model, make_caat_loss_fn(model, caat_t.CAAT),
                             policy)
    jstate, jstep = _jax_step(model_j, params, jax_recipes.make_caat_loss_fn(
        model_j, caat_t.CAAT), policy)
    gen = torch.Generator().manual_seed(0)
    for seed in range(2):
        b = caat_t.make_batch(seed)
        state, logs = step(state, caat_t.to_torch(b), gen)
        jstate, jlogs = jstep(jstate, caat_t.to_jax(b), caat_t.JAX_RNG)
        _assert_logs(logs, jlogs, ("loss_total", "sample_size", "grad_norm",
                                   "skipped"))
    _assert_params(model, caat_state_dict_from_jax(
        jax.device_get(jstate.params)))


# -- against the port's own plain step, the randomness on ------------------

CAAT_DROP = (dataclasses.replace(
    W2V_TINY, dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
    encoder_layerdrop=0.3, feature_grad_mult=0.1),
    dataclasses.replace(CAAT_TINY, dropout=0.1, attention_dropout=0.1,
                        activation_dropout=0.1, rand_pos_decoder=4))
PRE_DROP = dataclasses.replace(
    pre.W2V, dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
    encoder_layerdrop=0.3, dropout_input=0.1, dropout_features=0.1)


class Recorder:
    """Every ``DropoutContext`` made (its seed and final site count) and
    every call of the dropout kernel's twin."""

    def __init__(self, monkeypatch):
        self.contexts, self.twin_calls = [], 0
        init, run = port_dropout.DropoutContext.__init__, port_dropout._run

        def record_init(ctx, *args, **kwargs):
            init(ctx, *args, **kwargs)
            self.contexts.append(ctx)

        def count_run(*args):
            self.twin_calls += 1
            return run(*args)

        monkeypatch.setattr(port_dropout.DropoutContext, "__init__",
                            record_init)
        monkeypatch.setattr(port_dropout, "_run", count_run)


def _run(task, policy, extractor, monkeypatch):
    """Three updates with the randomness on: (logs, parameters, generator
    state, per update (twin calls, [(seed, sites) of each context]))."""
    rec = Recorder(monkeypatch)
    if task == "caat":
        w2v, caat = CAAT_DROP
        w2v = dataclasses.replace(w2v, remat_extractor=extractor)
        model = port_caat(jax_caat(W2V_TINY, CAAT_TINY)[1], w2v, caat)
        loss_fn = make_caat_loss_fn(model, caat)
        batches = [caat_t.to_torch(caat_t.make_batch(s)) for s in range(3)]
    else:
        w2v = dataclasses.replace(PRE_DROP, remat_extractor=extractor)
        model = pre.port_w2v(pre.jax_w2v(pre.W2V)[1], w2v)
        loss_fn = make_pretrain_loss_fn(model, 8, 4)
        batches = [pre.to_torch(pre.make_batch(s)) for s in range(3)]
    state, step = _port_step(model, loss_fn, policy)
    gen = torch.Generator().manual_seed(5)
    logs_all, per_update = [], []
    for b in batches:
        rec.contexts.clear()
        rec.twin_calls = 0
        state, logs = step(state, b, gen)
        logs_all.append({k: float(v) for k, v in logs.items()})
        per_update.append((rec.twin_calls, [(c.seed, c.sites)
                                            for c in rec.contexts]))
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    return logs_all, params, gen.get_state(), per_update


@pytest.fixture(scope="module")
def plain_runs():
    with pytest.MonkeyPatch.context() as mp:
        return {task: _run(task, "none", False, mp)
                for task in ("caat", "pretrain")}


SELF_CASES = [(p, False) for p in POLICIES] + [("nothing", True)]


@pytest.mark.parametrize("policy,extractor", SELF_CASES,
                         ids=_ids(SELF_CASES))
@pytest.mark.parametrize("task", ["caat", "pretrain"])
def test_policy_equals_the_plain_step_with_the_randomness_on(
        plain_runs, task, policy, extractor, monkeypatch):
    want_logs, want, want_gen, want_updates = plain_runs[task]
    logs, params, gen, updates = _run(task, policy, extractor, monkeypatch)
    for a, b in zip(logs, want_logs):
        assert a["skipped"] == b["skipped"] == 0.0
        for k in ("loss_total", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    for name, v in want.items():
        np.testing.assert_allclose(params[name].numpy(), v.numpy(),
                                   rtol=1e-6, atol=0, err_msg=name)
    assert torch.equal(gen, want_gen)
    for (calls, contexts), (want_calls, (want_ctx,)) in zip(updates,
                                                            want_updates):
        # the forward's context, then the recompute's: the same seed and
        # the same sites; the twin runs once more per forward site
        assert contexts == [want_ctx, want_ctx]
        seed, sites = want_ctx
        assert sites > 0
        assert calls == want_calls + sites
