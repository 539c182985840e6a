"""The beam half of the cached CAAT decode steps: the port against the JAX
package's ``stream/caat_step.py``, and against itself.

Against JAX, on the same seeded weights and numpy inputs, both decoder
layer-norm orders, float32, atol 1e-5: ``lm_init``/``lm_step`` chains with
held streams, ``lm_prefill``, ``lm_prefill_extend`` (0, 1 and ``S`` new
tokens, a row whose write would pass the cache), ``lm_beam_init``/
``lm_beam_reorder``/``lm_beam_step`` at inter_beam 1 and 2,
``jointer_beam_logits`` and ``jointer_step_beam`` with ragged ``visible``.

Port-side twins of ``tests/test_caat_step.py`` and
``tests/test_beam_batched.py::test_jointer_step_beam_matches_flat`` (slow
on the JAX side, not here): cached steps == ``decode_step``, prefill ==
step chain, beam step == ``lm_step``, extend == full prefill, beam jointer
== flat jointer; atol 3e-5 as there (two float32 summation orders).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_import import jax_caat, port_caat
from wav2vec_s_tpu.stream import caat_step as jax_step
from wav2vec_s_tpu_torch.checkpoint.convert import caat_state_dict_from_jax
from wav2vec_s_tpu_torch.stream import caat_step

ATOL = 1e-5
TWIN = dict(atol=3e-5, rtol=1e-4)
NB = pytest.mark.parametrize("normalize_before", [True, False])


def _pair(normalize_before):
    caat = dataclasses.replace(CAAT_TINY,
                               decoder_normalize_before=normalize_before)
    _, params = jax_caat(W2V_TINY, caat)
    return params, port_caat(params, W2V_TINY, caat), caat


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                            else a)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def _same_lm(b, a):
    for i in range(len(a.k)):
        _close(b.k[i], a.k[i])
        _close(b.v[i], a.v[i])
    _close(b.h_last, a.h_last)


def _prefixes(rng, caat, lens, width):
    toks = np.full((len(lens), width), caat.pad, np.int64)
    for k, n in enumerate(lens):
        toks[k, 0] = caat.bos
        toks[k, 1:n] = rng.integers(4, caat.vocab_size, n - 1)
    return toks


def test_beam_path_adds_no_parameter():
    """The converted JAX tree loads with ``strict=True``: the beam path
    reads the parameters the greedy path reads."""
    _, params = jax_caat()
    model = port_caat(params)
    result = model.load_state_dict(caat_state_dict_from_jax(params),
                                   strict=True)
    assert not result.missing_keys and not result.unexpected_keys


# -- against JAX -----------------------------------------------------------

@NB
def test_lm_init_and_step_chain_match_jax(normalize_before):
    params, model, caat = _pair(normalize_before)
    N, U = 3, 8
    a = jax_step.lm_init(params, caat, N, U)
    b = caat_step.lm_init(model, model.cfg, N, U)
    _same_lm(b, a)
    rng = np.random.default_rng(0)
    lens = np.ones(N, np.int64)
    for _ in range(5):
        tok = rng.integers(4, caat.vocab_size, N)
        adv = rng.random(N) < 0.6                # some streams hold
        a = jax_step.lm_step(params, caat, a, jnp.asarray(tok),
                             jnp.asarray(lens), jnp.asarray(adv))
        b = caat_step.lm_step(model, model.cfg, b, _t(tok), _t(lens),
                              _t(adv))
        _same_lm(b, a)
        lens = lens + adv
    rows = np.array([2, 0, 0])
    _same_lm(caat_step.lm_reorder(b, _t(rows)),
             jax_step.lm_reorder(a, jnp.asarray(rows)))


@NB
def test_lm_prefill_matches_jax(normalize_before):
    params, model, caat = _pair(normalize_before)
    lens = np.array([1, 4, 6, 3])
    toks = _prefixes(np.random.default_rng(1), caat, lens, 6)
    a = jax_step.lm_prefill(params, caat, jnp.asarray(toks),
                            jnp.asarray(lens), 9)
    b = caat_step.lm_prefill(model, model.cfg, _t(toks), _t(lens), 9)
    assert b.k[0].shape == (9, 4, caat.decoder_embed_dim)
    _same_lm(b, a)


# new_lens 0 (a held stream), 1 and S; the last row's prefix ends one row
# short of the cache, so two of its three new rows are dropped (JAX
# scatters them with mode="drop")
EXTEND_OLD, EXTEND_NEW = [3, 6, 1, 9], [0, 1, 3, 3]
EXTEND_S, EXTEND_CAP = 3, 10


@NB
def test_lm_prefill_extend_matches_jax(normalize_before):
    params, model, caat = _pair(normalize_before)
    rng = np.random.default_rng(7)
    old_lens, new_lens = np.array(EXTEND_OLD), np.array(EXTEND_NEW)
    old = _prefixes(rng, caat, old_lens, EXTEND_CAP)
    new = np.full((4, EXTEND_S), caat.pad, np.int64)
    for k, n in enumerate(new_lens):
        new[k, :n] = rng.integers(4, caat.vocab_size, n)
    pre_a = jax_step.lm_prefill(params, caat, jnp.asarray(old),
                                jnp.asarray(old_lens), EXTEND_CAP)
    pre_b = caat_step.lm_prefill(model, model.cfg, _t(old), _t(old_lens),
                                 EXTEND_CAP)
    kept = [k.clone() for k in pre_b.k]
    a = jax_step.lm_prefill_extend(params, caat, pre_a,
                                   jnp.asarray(old_lens), jnp.asarray(new),
                                   jnp.asarray(new_lens))
    b = caat_step.lm_prefill_extend(model, model.cfg, pre_b, _t(old_lens),
                                    _t(new), _t(new_lens))
    _same_lm(b, a)
    # the held stream keeps its h_last bit for bit; the input state is not
    # written
    assert torch.equal(b.h_last[0], pre_b.h_last[0])
    assert all(torch.equal(x, y) for x, y in zip(kept, pre_b.k))
    assert not torch.equal(b.k[0][9, 3], pre_b.k[0][9, 3])


def _beam_setup(rng, caat, N, B, IB, U_pre):
    seed_lens = rng.integers(1, 4, (N, IB))
    seeds = _prefixes(rng, caat, seed_lens.reshape(-1), U_pre)
    origin0 = np.minimum(np.arange(B)[None, :].repeat(N, 0), IB - 1)
    return seeds, seed_lens, origin0


def _same_beam(b, a):
    _close(b.sk, a.sk)
    _close(b.sv, a.sv)
    _close(b.h_last, a.h_last)
    np.testing.assert_array_equal(b.svalid.numpy(), np.asarray(a.svalid))
    np.testing.assert_array_equal(b.origin.numpy(), np.asarray(a.origin))
    assert b.sptr == int(a.sptr)


@NB
@pytest.mark.parametrize("inter_beam", [1, 2])
def test_lm_beam_chain_matches_jax(normalize_before, inter_beam):
    params, model, caat = _pair(normalize_before)
    N, B, IB, U_pre, S = 2, 3, inter_beam, 8, 5
    rng = np.random.default_rng(2)
    seeds, seed_lens, origin0 = _beam_setup(rng, caat, N, B, IB, U_pre)
    plen = seed_lens.reshape(-1)
    pre_a = jax_step.lm_prefill(params, caat, jnp.asarray(seeds),
                                jnp.asarray(plen), U_pre)
    pre_b = caat_step.lm_prefill(model, model.cfg, _t(seeds), _t(plen),
                                 U_pre)
    a = jax_step.lm_beam_init(pre_a, jnp.asarray(plen),
                              jnp.asarray(origin0.reshape(-1)), n_slots=S,
                              beams=B)
    b = caat_step.lm_beam_init(pre_b, _t(plen), _t(origin0.reshape(-1)),
                               n_slots=S, beams=B)
    _same_beam(b, a)
    lens = seed_lens[np.arange(N)[:, None], origin0].reshape(-1).copy()
    for step in range(S):
        rows = np.concatenate([n * B + rng.permutation(B) for n in range(N)])
        a = jax_step.lm_beam_reorder(a, jnp.asarray(rows))
        b = caat_step.lm_beam_reorder(b, _t(rows))
        lens = lens[rows]
        adv = np.ones((N, B), bool)
        adv[1] = step % 2 == 0                   # stream 1 holds on odd steps
        adv = adv.reshape(-1)
        toks = rng.integers(4, caat.vocab_size, N * B)
        a = jax_step.lm_beam_step(params, caat, a, jnp.asarray(toks),
                                  jnp.asarray(lens), jnp.asarray(adv), B)
        b = caat_step.lm_beam_step(model, model.cfg, b, _t(toks), _t(lens),
                                   _t(adv), B)
        _same_beam(b, a)
        lens = lens + adv
    with pytest.raises(ValueError):              # no slot S
        caat_step.lm_beam_step(model, model.cfg, b, _t(toks), _t(lens),
                               _t(adv), B)


def _jointer_inputs(caat, N, B, T):
    D, L = caat.jointer_embed_dim, caat.jointer_layers
    rng = np.random.default_rng(3)
    h = rng.standard_normal((N, B, D)).astype(np.float32)
    jk = [rng.standard_normal((T, N, D)).astype(np.float32)
          for _ in range(L)]
    jv = [rng.standard_normal((T, N, D)).astype(np.float32)
          for _ in range(L)]
    return h, jk, jv


@NB
@pytest.mark.parametrize("fn", ["jointer_beam_logits", "jointer_step_beam"])
def test_beam_jointer_matches_jax(normalize_before, fn):
    params, model, caat = _pair(normalize_before)
    N, B, T = 3, 4, 16
    h, jk, jv = _jointer_inputs(caat, N, B, T)
    visible = np.array([1, 9, T])                # ragged
    want = getattr(jax_step, fn)(
        params, caat, jnp.asarray(h), tuple(map(jnp.asarray, jk)),
        tuple(map(jnp.asarray, jv)), jnp.asarray(visible))
    got = getattr(caat_step, fn)(model, model.cfg, _t(h), list(map(_t, jk)),
                                 list(map(_t, jv)), _t(visible))
    assert got.dtype == torch.float32 and got.shape == (N, B,
                                                        caat.vocab_size)
    _close(got, want)


# -- the port against itself (tests/test_caat_step.py on the port) ---------

def _encoded(model, n=2):
    src = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, 2400)).astype(np.float32))
    return model.encode(src)[0]


@NB
def test_cached_steps_match_decode_step(normalize_before):
    _, model, caat = _pair(normalize_before)
    cfg = model.cfg
    enc = _encoded(model)
    N, T, _ = enc.shape
    U_cap = 8
    rng = np.random.default_rng(0)
    jk, jv = caat_step.jointer_kv(model, cfg, enc.transpose(0, 1))
    lm = caat_step.lm_init(model, cfg, N, U_cap)
    prefixes = np.full((N, U_cap), caat.pad, np.int64)
    prefixes[:, 0] = caat.bos
    lens = np.ones(N, np.int64)
    for step in range(5):
        visible = np.minimum(np.asarray([2 + 2 * step, 1 + 3 * step]), T)
        want = model.decode_step(
            _t(prefixes), _t(lens), enc,
            torch.arange(T)[None, :] >= _t(visible)[:, None])
        got = caat_step.jointer_step(model, cfg, lm.h_last, jk, jv,
                                     _t(visible))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                   rtol=1e-4)
        # stream 0 advances every step, stream 1 every other step
        adv = np.asarray([True, step % 2 == 0])
        toks = rng.integers(4, caat.vocab_size, N)
        lm = caat_step.lm_step(model, cfg, lm, _t(toks), _t(lens), _t(adv))
        for i in range(N):
            if adv[i]:
                prefixes[i, lens[i]] = toks[i]
                lens[i] += 1


@NB
def test_lm_state_invariant_under_held_streams(normalize_before):
    """A held stream's h_last is bitwise unchanged by lm_step."""
    _, model, _ = _pair(normalize_before)
    lm = caat_step.lm_init(model, model.cfg, 2, 8)
    before = lm.h_last.clone()
    lm = caat_step.lm_step(model, model.cfg, lm, _t([5, 6]), _t([1, 1]),
                           _t([False, True]))
    assert torch.equal(before[0], lm.h_last[0])
    assert not torch.allclose(before[1], lm.h_last[1])


@NB
def test_lm_prefill_matches_step_chain(normalize_before):
    _, model, caat = _pair(normalize_before)
    cfg = model.cfg
    N, u_cap = 2, 8
    toks = np.asarray([[caat.bos, 7, 9, 4], [caat.bos, 4, 5, 6]])
    lm = caat_step.lm_init(model, cfg, N, u_cap)          # consumes bos
    for j in range(1, 4):
        lm = caat_step.lm_step(model, cfg, lm, _t(toks[:, j]),
                               _t(np.full(N, j)), _t(np.ones(N, bool)))
    pre = caat_step.lm_prefill(model, cfg, _t(toks), _t([4, 4]), u_cap)
    np.testing.assert_allclose(pre.h_last.numpy(), lm.h_last.numpy(), **TWIN)
    for i in range(caat.decoder_layers):
        np.testing.assert_allclose(pre.k[i][:4].numpy(),
                                   lm.k[i][:4].numpy(), **TWIN)
        np.testing.assert_allclose(pre.v[i][:4].numpy(),
                                   lm.v[i][:4].numpy(), **TWIN)
    # reorder + one cached step after prefill == stepping the reordered
    # prefixes (the beam expansion pattern)
    re = caat_step.lm_reorder(pre, _t([1, 0]))
    nxt = caat_step.lm_step(model, cfg, re, _t([8, 8]), _t([4, 4]),
                            _t([True, True]))
    toks2 = np.concatenate([toks[::-1], [[8], [8]]], axis=1)
    want = caat_step.lm_prefill(model, cfg, _t(toks2), _t([5, 5]), u_cap)
    np.testing.assert_allclose(nxt.h_last.numpy(), want.h_last.numpy(),
                               **TWIN)


@NB
@pytest.mark.parametrize("inter_beam", [1, 2])
def test_lm_beam_step_matches_lm_step(normalize_before, inter_beam):
    """The split prefix|suffix beam state gives the ``h_last`` of
    full-width per-beam ``lm_step`` caches under reorders and held
    streams."""
    _, model, caat = _pair(normalize_before)
    cfg = model.cfg
    N, B, IB, U_pre, S = 2, 3, inter_beam, 8, 6
    rng = np.random.default_rng(2)
    seeds, seed_lens, origin0 = _beam_setup(rng, caat, N, B, IB, U_pre)
    plen = seed_lens.reshape(-1)
    pre = caat_step.lm_prefill(model, cfg, _t(seeds), _t(plen), U_pre)
    beam = caat_step.lm_beam_init(pre, _t(plen), _t(origin0.reshape(-1)),
                                  n_slots=S, beams=B)
    rows0 = (np.arange(N)[:, None] * IB + origin0).reshape(-1)
    ref = caat_step.lm_reorder(pre, _t(rows0))
    pad = (0, 0, 0, 0, 0, S)                   # room for the suffix tokens
    ref = caat_step.LMState(
        k=[torch.nn.functional.pad(k, pad) for k in ref.k],
        v=[torch.nn.functional.pad(v, pad) for v in ref.v],
        h_last=ref.h_last)
    np.testing.assert_allclose(beam.h_last.numpy(), ref.h_last.numpy(),
                               **TWIN)
    lens = seed_lens[np.arange(N)[:, None], origin0].reshape(-1).copy()
    for step in range(S):
        rows = np.concatenate([n * B + rng.permutation(B) for n in range(N)])
        beam = caat_step.lm_beam_reorder(beam, _t(rows))
        ref = caat_step.lm_reorder(ref, _t(rows))
        lens = lens[rows]
        adv = np.ones((N, B), bool)
        adv[1] = step % 2 == 0
        adv = adv.reshape(-1)
        toks = rng.integers(4, caat.vocab_size, N * B)
        beam = caat_step.lm_beam_step(model, cfg, beam, _t(toks), _t(lens),
                                      _t(adv), B)
        ref = caat_step.lm_step(model, cfg, ref, _t(toks), _t(lens), _t(adv))
        lens = lens + adv
        np.testing.assert_allclose(beam.h_last.numpy(), ref.h_last.numpy(),
                                   **TWIN)
    assert beam.sptr == S


@NB
def test_lm_prefill_extend_matches_full_prefill(normalize_before):
    _, model, caat = _pair(normalize_before)
    cfg = model.cfg
    rng = np.random.default_rng(7)
    K, U_old, S, u_cap = 3, 6, 4, 16
    old_lens, new_lens = np.array([3, 6, 1]), np.array([2, 4, 0])
    old = _prefixes(rng, caat, old_lens, U_old)
    new = np.full((K, S), caat.pad, np.int64)
    for k in range(K):
        new[k, :new_lens[k]] = rng.integers(4, caat.vocab_size, new_lens[k])
    pre = caat_step.lm_prefill(model, cfg, _t(old), _t(old_lens), u_cap)
    ext = caat_step.lm_prefill_extend(model, cfg, pre, _t(old_lens), _t(new),
                                      _t(new_lens))
    full = np.full((K, U_old + S), caat.pad, np.int64)
    lens = old_lens + new_lens
    for k in range(K):
        full[k, :old_lens[k]] = old[k, :old_lens[k]]
        full[k, old_lens[k]:lens[k]] = new[k, :new_lens[k]]
    want = caat_step.lm_prefill(model, cfg, _t(full), _t(lens), u_cap)
    np.testing.assert_allclose(ext.h_last.numpy(), want.h_last.numpy(),
                               atol=2e-5, rtol=2e-5)
    for i in range(caat.decoder_layers):
        for k in range(K):
            L = int(lens[k])
            for got, ref in ((ext.k, want.k), (ext.v, want.v)):
                np.testing.assert_allclose(
                    got[i][:L, k].numpy(), ref[i][:L, k].numpy(), atol=2e-5,
                    rtol=2e-5, err_msg=f"layer {i} row {k}")


@NB
def test_jointer_step_beam_matches_flat(normalize_before):
    """Beam-shaped jointer step == the flat jointer step on caches tiled
    per beam."""
    _, model, caat = _pair(normalize_before)
    N, B, T = 2, 3, 8
    h, jk, jv = _jointer_inputs(caat, N, B, T)
    visible = _t([5, 8])
    got = caat_step.jointer_step_beam(model, model.cfg, _t(h),
                                      list(map(_t, jk)), list(map(_t, jv)),
                                      visible)
    want = caat_step.jointer_step(
        model, model.cfg, _t(h).reshape(N * B, -1),
        [_t(k).repeat_interleave(B, dim=1) for k in jk],
        [_t(v).repeat_interleave(B, dim=1) for v in jv],
        visible.repeat_interleave(B))
    np.testing.assert_allclose(got.reshape(N * B, -1).numpy(), want.numpy(),
                               atol=1e-5)
