"""Rematerialization of the torch port's pre-training step against the
JAX package's (``tests/test_torch_port_remat.py`` holds the CAAT step and
the comparisons with the port's own plain step).

Two updates of ``make_pretrain_loss_fn`` (tiny dims of
``tests/test_torch_port_pretrain.py``, dropout off, the port's negatives
and Gumbel uniforms planted at the JAX draw sites) under each policy and
under ``remat_extractor``, against the JAX step built with the same policy
and config.  Tolerances: losses rtol 1e-5, parameters atol 1e-2 * lr.
"""

import dataclasses

import jax
import pytest
import torch

from tests import test_torch_port_pretrain as pre
from tests.test_torch_port_remat import (
    JAX_CASES, _assert_logs, _assert_params, _ids, _jax_step, _port_step)
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu_torch.checkpoint.convert import (
    wav2vec2_state_dict_from_jax)
from wav2vec_s_tpu_torch.train.recipes import make_pretrain_loss_fn

torch.set_num_threads(1)


@pytest.mark.parametrize("policy,extractor", JAX_CASES,
                         ids=_ids(JAX_CASES))
def test_pretrain_updates_match_jax_under_the_policy(policy, extractor,
                                                     monkeypatch):
    w2v = dataclasses.replace(pre.W2V, remat_extractor=extractor)
    model_j, params = pre.jax_w2v(pre.W2V)
    model_j = type(model_j)(w2v, encoder_type="blockwise")
    draws = pre.Draws(monkeypatch)
    model = pre.port_w2v(params, w2v)
    state, step = _port_step(model, make_pretrain_loss_fn(model, 8, 4),
                             policy)
    batches = [pre.make_batch(seed) for seed in range(2)]
    port_logs = []
    for b in batches:          # one seed per update: the same draws twice
        state, logs = step(state, pre.to_torch(b),
                           torch.Generator().manual_seed(0))
        port_logs.append(logs)
    draws.plant()
    jstate, jstep = _jax_step(model_j, params,
                              jax_recipes.make_pretrain_loss_fn(model_j, 8,
                                                                4), policy)
    for b, logs in zip(batches, port_logs):
        jstate, jlogs = jstep(jstate, pre.to_jax(b), pre.JAX_RNG)
        _assert_logs(logs, jlogs, ("loss_total", "sample_size", "grad_norm",
                                   "loss_infonce", "prob_perplexity"))
    _assert_params(model, wav2vec2_state_dict_from_jax(
        jax.device_get(jstate.params)))
