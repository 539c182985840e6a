"""CachedFusedGreedyDecoder: the port's texts and delays EQUAL the JAX
decoder's, at tiny dims, for one and two blocks per step (float32 wire
here, int16 wire in test_torch_port_greedy_int16.py).

Weights: the seeded tree of ``test_torch_port_import.jax_caat`` with the
blank row of the tied embedding scaled by 1.3, so that on these clips two
streams emit blank at every chunk (the blocked path) while the third
emits, holds sometimes, and runs into ``max_len``.  The tiny conv stack
hops 20 samples, so 12800 samples are 639 frames and ``t_cap`` must hold
them (past capacity the JAX cache writes clamp; the port raises).
"""

import functools

import numpy as np
import pytest

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_import import jax_caat, port_caat, port_cfg
from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
from wav2vec_s_tpu.stream.batched import (
    CachedFusedGreedyDecoder as JaxDecoder)
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.stream.batched import CachedFusedGreedyDecoder

KW = dict(max_len=256, max_emit_per_chunk=4, t_cap=640)


@functools.lru_cache(maxsize=None)
def _models():
    _, params = jax_caat()
    params = dict(params)
    params["embed_tokens"] = params["embed_tokens"].copy()
    params["embed_tokens"][CAAT_TINY.bos] *= 1.3
    jax_model, _ = jax_caat()
    return jax_model, params, port_caat(params)


def _vocab(cls):
    v = cls()
    for i in range(CAAT_TINY.vocab_size - v.nspecial):
        v.add_symbol(f"w{i}")
    return v


def clips():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(n).astype(np.float32) * 0.1
            for n in (6400, 9600, 12800)]


def decode_both(blocks, wire):
    jax_model, params, model = _models()
    ref = JaxDecoder(jax_model, params, _vocab(JaxDictionary), W2V_TINY,
                     blocks_per_step=blocks, **KW)
    port = CachedFusedGreedyDecoder(model, _vocab(Dictionary),
                                    port_cfg(Wav2Vec2Config, W2V_TINY),
                                    blocks_per_step=blocks, **KW)
    ref.transfer_dtype = port.transfer_dtype = wire
    return ref.decode_corpus(clips()), port.decode_corpus(clips())


@pytest.mark.parametrize("blocks", [1, 2])
def test_texts_and_delays_equal_jax(blocks):
    (want_t, want_d), (got_t, got_d) = decode_both(blocks, "float32")
    assert got_t == want_t
    assert got_d == want_d
    n_words = [len(d) for d in got_d]
    assert n_words[:2] == [0, 0] and n_words[2] > 100   # blank and emitting
