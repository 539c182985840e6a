"""The host beam searcher's pieces: ``W2V2CaatModel.decode_step``, the
``StreamingEngine`` / ``EnsembleEngine`` and the searcher copy, the port
against the JAX package.

- ``decode_step`` and the engine's ``encode_prefix`` / ``decode_scores``
  (padded to the same buckets) agree with JAX to atol 1e-4 (the encoder's
  tolerance in ``test_torch_port_oneshot.py``), both decoder layer-norm
  orders;
- an ensemble of two equal engines scores like one;
- the searcher copy gives what the original gives: ``lcp_emit``,
  ``merge_surface_scores``, ``_merge_identical`` and ``detok_pieces`` on
  seeded pools (equal), and the whole host search over one utterance
  (words equal, hypothesis scores to 1e-4).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_greedy import _vocab
from tests.test_torch_port_import import jax_caat, port_caat
from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
from wav2vec_s_tpu.stream import searcher as jax_searcher
from wav2vec_s_tpu.stream.engine import StreamingEngine as JaxEngine
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.models.feature_extractor import (
    conv_output_length, conv_receptive_stride)
from wav2vec_s_tpu_torch.stream import searcher
from wav2vec_s_tpu_torch.stream.engine import EnsembleEngine, StreamingEngine

ATOL = 1e-4
MC, RC = W2V_TINY.main_context, W2V_TINY.right_context
RF, HOP = conv_receptive_stride(W2V_TINY.conv_feature_layers)


def _pair(normalize_before=True):
    caat = dataclasses.replace(CAAT_TINY,
                               decoder_normalize_before=normalize_before)
    jax_model, params = jax_caat(W2V_TINY, caat)
    return jax_model, params, port_caat(params, W2V_TINY, caat), caat


def chunked_audio(n_chunks, seed):
    """Audio whose length lands exactly on the chunk grid."""
    n = (n_chunks * MC + RC - 1) * HOP + RF
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(
        np.float32)


def prefix_lens(wav):
    window, stride = (MC + RC - 1) * HOP + RF, MC * HOP
    n_chunks = (conv_output_length(len(wav), W2V_TINY.conv_feature_layers)
                - RC) // MC
    return [min(k * stride + window, len(wav)) for k in range(n_chunks)]


def _engines(wav, normalize_before=True):
    jax_model, params, model, _ = _pair(normalize_before)
    kw = dict(main_context=MC, right_context=RC,
              audio_buckets=sorted(set(prefix_lens(wav))),
              token_buckets=[8, 16, 32, 64])
    return JaxEngine(jax_model, params, **kw), StreamingEngine(model, **kw)


@pytest.mark.parametrize("normalize_before", [True, False])
def test_decode_step_matches_jax(normalize_before):
    jax_model, params, model, caat = _pair(normalize_before)
    rng = np.random.default_rng(0)
    K, U, S, D = 3, 6, 9, W2V_TINY.encoder_embed_dim
    lens = np.array([1, 4, 6])
    toks = np.full((K, U), caat.pad, np.int64)
    for k, n in enumerate(lens):
        toks[k, 0] = caat.bos
        toks[k, 1:n] = rng.integers(4, caat.vocab_size, n - 1)
    enc = rng.standard_normal((K, S, D)).astype(np.float32)
    pad = np.arange(S)[None, :] >= np.array([2, 9, 5])[:, None]
    want = jax_model.apply(
        {"params": params}, jnp.asarray(toks, jnp.int32),
        jnp.asarray(lens, jnp.int32), jnp.asarray(enc), jnp.asarray(pad),
        method=type(jax_model).decode_step)
    got = model.decode_step(torch.from_numpy(toks), torch.from_numpy(lens),
                            torch.from_numpy(enc), torch.from_numpy(pad))
    assert got.dtype == torch.float32 and got.shape == (K, caat.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("finished", [False, True])
def test_engine_encode_prefix_matches_jax(finished):
    wav = chunked_audio(3, 0)
    ref, port = _engines(wav)
    n = prefix_lens(wav)[1] - 7          # inside a bucket: padded + masked
    want, want_t = ref.encode_prefix(wav[:n], finished)
    got, got_t = port.encode_prefix(wav[:n], finished)
    assert got_t == want_t and got.shape == want.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_engine_decode_scores_matches_jax():
    wav = chunked_audio(3, 0)
    ref, port = _engines(wav)
    enc, t = ref.encode_prefix(wav, True)
    prefixes = np.array([[0, 7, 9], [0, 5, 1]], np.int32)
    lens = np.array([3, 2], np.int32)
    want = ref.decode_scores(prefixes, lens, enc, t - 3)
    got = port.decode_scores(prefixes, lens, np.asarray(enc), t - 3)
    assert got.flags.writeable and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ensemble_of_two_equal_engines_scores_like_one():
    wav = chunked_audio(2, 1)
    _, port = _engines(wav)
    both = EnsembleEngine([port, port])
    enc, t = port.encode_prefix(wav, True)
    encs, t2 = both.encode_prefix(wav, True)
    assert t2 == t and len(encs) == 2
    prefixes = np.array([[0, 7, 9]], np.int32)
    lens = np.array([3], np.int32)
    np.testing.assert_allclose(
        both.decode_scores(prefixes, lens, encs, t),
        port.decode_scores(prefixes, lens, enc, t), atol=1e-6)


def _spm_vocab(cls):
    v = cls()
    for s in ("▁the", "cat", "▁sat", "s", "▁on", "▁a", "mat",
              "▁cat"):
        v.add_symbol(s)
    return v


def _seeded_pool(rng, vocab, rows=6, width=7):
    toks = np.full((rows, width), vocab.pad(), np.int32)
    for r in range(rows):
        n = rng.integers(1, width)
        toks[r, 0] = vocab.bos()
        toks[r, 1:n] = rng.integers(vocab.nspecial, len(vocab), n - 1)
    toks[3] = toks[1]                            # an identical path
    scores = rng.standard_normal(rows)
    scores[4] = -np.inf
    return toks, scores


@pytest.mark.parametrize("vocab_of", [_spm_vocab, _vocab])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_searcher_copy_functions_match(vocab_of, seed):
    a, b = vocab_of(JaxDictionary), vocab_of(Dictionary)
    assert searcher.spm_style_vocab(b) == jax_searcher.spm_style_vocab(a)
    toks, scores = _seeded_pool(np.random.default_rng(seed), b)
    for add in (False, True):
        np.testing.assert_array_equal(
            searcher.merge_surface_scores(b, None, toks, scores, add),
            jax_searcher.merge_surface_scores(a, None, toks, scores, add))
        np.testing.assert_array_equal(
            searcher.StreamingTransducerSearcher._merge_identical(
                toks, scores, add),
            jax_searcher.StreamingTransducerSearcher._merge_identical(
                toks, scores, add))
    spm = searcher.spm_style_vocab(b)
    for eager in (False, True):
        for is_end in (False, True):
            for kept in (toks[:1], toks[[1, 3, 1]], toks[:3]):
                assert (searcher.lcp_emit(b, None, spm, eager, kept, 1,
                                          is_end)
                        == jax_searcher.lcp_emit(a, None, spm, eager, kept,
                                                 1, is_end))
    assert (searcher.detok_pieces(b, None, toks[1])
            == jax_searcher.detok_pieces(a, None, toks[1]))


def host_decode(engine, vocab, wav, beam, max_steps, gen_beam, eager,
                module=searcher):
    """The host searcher over the chunk grid -> (words, final state)."""
    s = module.StreamingTransducerSearcher(engine, vocab, eager=eager)
    state = s.init_state()
    words = []
    lens = prefix_lens(wav)
    for k, n in enumerate(lens):
        state, ws = s.search(state, wav[:n], k == len(lens) - 1,
                             intra_beam=beam, inter_beam=1,
                             gen_beam=gen_beam, read_step=MC,
                             max_steps=max_steps)
        words.extend(ws)
    return words, state


def test_host_search_matches_jax_host_search():
    wav = chunked_audio(3, 7)
    ref, port = _engines(wav)
    want, want_state = host_decode(ref, _vocab(JaxDictionary), wav, 3, 5,
                                   2.0, True, module=jax_searcher)
    got, got_state = host_decode(port, _vocab(Dictionary), wav, 3, 5, 2.0,
                                 True)
    assert got == want and len(got) >= 4
    np.testing.assert_array_equal(got_state.prefixes, want_state.prefixes)
    np.testing.assert_allclose(got_state.scores, want_state.scores,
                               atol=ATOL)
