"""OneShotCorpusDecoder and the one-shot encoder: the port against the JAX
package (float32 wire here, int16 wire in test_torch_port_oneshot_int16.py).

- ``extract_features`` (the blockwise encoder over a whole utterance, odd
  length and a padded stream) agrees with the JAX ``W2V2CaatModel.encode``
  to atol 1e-4, with dense and flash attention, post-LN and pre-LN;
- the port's one-shot texts and delays EQUAL the JAX one-shot decoder's;
- the port's one-shot decode equals the port's cached (incremental) decode:
  the prefix-exactness the slow-marked JAX ``test_oneshot_decode.py`` pins;
- one decoder over corpora of changing shapes equals fresh decoders.

The encoder is 32 wide with 4 heads (dh 8): at the tiny 24/4 dims the JAX
"flash" path takes its jnp fallback (``dh % 8``), at dh 8 it runs the
Pallas kernel in interpret mode.  The jointer then reads a 32-wide encoder
output with 24-wide projections.  The blank row of the tied embedding is
scaled by 2.16 so that, on these clips, one stream emits blank at every
chunk while the others emit, hold, and (at ds1) run into ``max_len``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_greedy import _vocab, clips, corpora_in_a_row
from tests.test_torch_port_import import jax_caat, port_caat, port_cfg
from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
from wav2vec_s_tpu.stream.batched import OneShotCorpusDecoder as JaxOneShot
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.stream.batched import (
    CachedFusedGreedyDecoder, OneShotCorpusDecoder)

W2V_DH8 = dataclasses.replace(W2V_TINY, encoder_embed_dim=32,
                              encoder_ffn_embed_dim=64)
KW = dict(max_len=256, max_emit_per_chunk=4, t_cap=640)
BLANK_SCALE = 2.16


@functools.lru_cache(maxsize=None)
def models(impl):
    w2v = dataclasses.replace(W2V_DH8, attention_impl=impl)
    jax_model, params = jax_caat(w2v)
    params = dict(params)
    params["embed_tokens"] = params["embed_tokens"].copy()
    params["embed_tokens"][CAAT_TINY.bos] *= BLANK_SCALE
    return w2v, jax_model, params, port_caat(params, w2v)


def decode_both(impl, blocks, wire):
    """(JAX one-shot, port one-shot) texts and delays on the same clips."""
    w2v, jax_model, params, model = models(impl)
    ref = JaxOneShot(jax_model, params, _vocab(JaxDictionary), w2v,
                     blocks_per_step=blocks, **KW)
    port = OneShotCorpusDecoder(model, _vocab(Dictionary),
                                port_cfg(Wav2Vec2Config, w2v),
                                blocks_per_step=blocks, **KW)
    ref.transfer_dtype = port.transfer_dtype = wire
    return ref.decode_corpus(clips()), port.decode_corpus(clips())


@pytest.mark.parametrize("layer_norm_first", [False, True])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_extract_features_matches_jax(impl, layer_norm_first):
    w2v = dataclasses.replace(W2V_DH8, attention_impl=impl,
                              layer_norm_first=layer_norm_first)
    jax_model, params = jax_caat(w2v)
    model = port_caat(params, w2v)
    rng = np.random.default_rng(3)
    audio = rng.standard_normal((2, 1990)).astype(np.float32) * 0.3
    pad = np.zeros(audio.shape, bool)
    pad[1, 1500:] = True                       # 99 frames, 75 valid in row 1
    want, want_pad = jax_model.apply(
        {"params": params}, jnp.asarray(audio), jnp.asarray(pad), None, None,
        False, method=type(jax_model).encode)
    got, got_pad = model.encode(torch.from_numpy(audio), torch.from_numpy(pad))
    np.testing.assert_array_equal(got_pad.numpy(), np.asarray(want_pad))
    assert got.shape == (2, 99, 32)
    valid = ~got_pad.numpy()
    assert valid.sum() == 99 + 75
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=1e-4, rtol=0)


def test_encode_with_projection_matches_jax():
    """--use-linear-layer: the 32-wide encoder output projected to the
    24-wide decoder (the parameter tree loads with strict=True)."""
    caat = dataclasses.replace(CAAT_TINY, encoder_proj=True)
    w2v = dataclasses.replace(W2V_DH8, attention_impl="flash")
    jax_model, params = jax_caat(w2v, caat)
    model = port_caat(params, w2v, caat)
    audio = np.random.default_rng(4).standard_normal((2, 2010)).astype(
        np.float32) * 0.3
    want, _ = jax_model.apply({"params": params}, jnp.asarray(audio),
                              method=type(jax_model).encode)
    got, got_pad = model.encode(torch.from_numpy(audio))
    assert got_pad is None and got.shape == (2, 100, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_texts_and_delays_equal_jax(impl, blocks):
    (want_t, want_d), (got_t, got_d) = decode_both(impl, blocks, "float32")
    assert got_t == want_t
    assert got_d == want_d
    n_words = [len(d) for d in got_d]
    assert n_words[1] == 0 and min(n_words[0], n_words[2]) > 100


@pytest.mark.parametrize("blocks", [1, 2])
def test_oneshot_equals_cached(blocks):
    w2v, _, _, model = models("flash")
    kw = dict(KW, blocks_per_step=blocks)
    cfg = port_cfg(Wav2Vec2Config, w2v)
    one = OneShotCorpusDecoder(model, _vocab(Dictionary), cfg, **kw)
    cached = CachedFusedGreedyDecoder(model, _vocab(Dictionary), cfg, **kw)
    assert one.decode_corpus(clips()) == cached.decode_corpus(clips())


def test_one_decoder_over_corpora_equals_fresh_decoders():
    w2v, _, _, model = models("flash")
    cfg = port_cfg(Wav2Vec2Config, w2v)
    corpora_in_a_row(lambda: OneShotCorpusDecoder(
        model, _vocab(Dictionary), cfg, blocks_per_step=2, **KW))


def test_oneshot_needs_t_cap_for_the_corpus():
    w2v, _, _, model = models("dense")
    dec = OneShotCorpusDecoder(model, _vocab(Dictionary),
                               port_cfg(Wav2Vec2Config, w2v),
                               **dict(KW, t_cap=512))
    with pytest.raises(ValueError):
        dec.decode_corpus(clips())             # 634 frames > 512
