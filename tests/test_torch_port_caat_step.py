"""Cached CAAT decode steps: the port against the JAX package's
``stream/caat_step.py``.

``lm_slot_init``, ``lm_slot_step`` (with held streams), ``jointer_kv``,
``jointer_kv_append`` and ``jointer_step`` on the same seeded weights and
inputs, for both decoder layer-norm orders; float32, atol 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_import import jax_caat, port_caat
from wav2vec_s_tpu.stream import caat_step as jax_step
from wav2vec_s_tpu_torch.stream import caat_step

N, SLOTS, T_CAP = 3, 8, 16
ATOL = 1e-4


def _pair(normalize_before):
    caat = dataclasses.replace(CAAT_TINY,
                               decoder_normalize_before=normalize_before)
    _, params = jax_caat(W2V_TINY, caat)
    return params, port_caat(params, W2V_TINY, caat), caat


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _same_lm(b, a):
    for i in range(len(b.k)):
        _close(b.k[i], a.k[i])
        _close(b.v[i], a.v[i])
    np.testing.assert_array_equal(b.valid.numpy(), np.asarray(a.valid))
    assert b.ptr == int(a.ptr)
    _close(b.h_last, a.h_last)


@pytest.mark.parametrize("normalize_before", [True, False])
def test_lm_slot_init_matches(normalize_before):
    params, model, caat = _pair(normalize_before)
    _same_lm(caat_step.lm_slot_init(model, model.cfg, N, SLOTS),
             jax_step.lm_slot_init(params, caat, N, SLOTS))


@pytest.mark.parametrize("normalize_before", [True, False])
def test_lm_slot_steps_match(normalize_before):
    params, model, caat = _pair(normalize_before)
    a = jax_step.lm_slot_init(params, caat, N, SLOTS)
    b = caat_step.lm_slot_init(model, model.cfg, N, SLOTS)
    rng = np.random.default_rng(0)
    lens = np.ones(N, np.int64)
    for _ in range(4):
        tok = rng.integers(4, caat.vocab_size, N)
        adv = rng.random(N) < 0.6            # some streams hold
        a = jax_step.lm_slot_step(params, caat, a, jnp.asarray(tok),
                                  jnp.asarray(lens), jnp.asarray(adv))
        b = caat_step.lm_slot_step(model, model.cfg, b,
                                   torch.from_numpy(tok),
                                   torch.from_numpy(lens),
                                   torch.from_numpy(adv))
        _same_lm(b, a)
        lens = lens + adv


@pytest.mark.parametrize("normalize_before", [True, False])
def test_jointer_kv_append_matches(normalize_before):
    params, model, caat = _pair(normalize_before)
    D, L = caat.jointer_embed_dim, caat.jointer_layers
    x = np.random.default_rng(1).standard_normal((5, N, D)).astype(np.float32)
    ka, va = jax_step.jointer_kv(params, caat, jnp.asarray(x))
    kb, vb = caat_step.jointer_kv(model, model.cfg, torch.from_numpy(x))
    zj = tuple(jnp.zeros((T_CAP, N, D)) for _ in range(L))
    ja = jax_step.jointer_kv_append(zj, zj, ka, va, 6)
    jb = caat_step.jointer_kv_append(
        [torch.zeros(T_CAP, N, D) for _ in range(L)],
        [torch.zeros(T_CAP, N, D) for _ in range(L)], kb, vb, 6)
    for got, want in zip(jb[0] + jb[1], ja[0] + ja[1]):
        _close(got, want)
    assert not jb[0][0][:6].any() and jb[0][0][6:11].any()


@pytest.mark.parametrize("normalize_before", [True, False])
def test_jointer_step_matches(normalize_before):
    params, model, caat = _pair(normalize_before)
    D, L = caat.jointer_embed_dim, caat.jointer_layers
    rng = np.random.default_rng(2)
    h = rng.standard_normal((N, D)).astype(np.float32)
    jk = [rng.standard_normal((T_CAP, N, D)).astype(np.float32)
          for _ in range(L)]
    jv = [rng.standard_normal((T_CAP, N, D)).astype(np.float32)
          for _ in range(L)]
    visible = np.array([1, 9, T_CAP])
    want = jax_step.jointer_step(params, caat, jnp.asarray(h),
                                 tuple(map(jnp.asarray, jk)),
                                 tuple(map(jnp.asarray, jv)),
                                 jnp.asarray(visible))
    got = caat_step.jointer_step(model, model.cfg, torch.from_numpy(h),
                                 [torch.from_numpy(k) for k in jk],
                                 [torch.from_numpy(v) for v in jv],
                                 torch.from_numpy(visible))
    _close(got, want)
    assert got.dtype == torch.float32
