"""The four batched beam decoders of the port against each other and the
port's host searcher: the cases of ``tests/test_beam_batched.py`` (marked
slow on the JAX side, not here), on the seeded weights of
``test_torch_port_import.jax_caat`` with the blank row of the tied
embedding scaled by 1.3 (the streams then differ in what they emit).

Also the helpers of the ``test_torch_port_beam_*`` files that hold the
port's decoders against the JAX decoders: ``decode_pair`` runs both on one
mixed-length corpus and records, at every chunk, the margin between the
kept hypothesis and the next one in the port's pool (length-normalized),
so that a test of equal texts can say the equality was no coin toss.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_beam_block import DECODERS
from tests.test_torch_port_beam_engine import (
    MC, RC, chunked_audio, host_decode, prefix_lens)
from tests.test_torch_port_greedy import _vocab
from tests.test_torch_port_import import jax_caat, port_caat, port_cfg
from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
from wav2vec_s_tpu.stream import beam_batched as jax_beam
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.stream import beam_batched
from wav2vec_s_tpu_torch.stream.engine import StreamingEngine

BLANK_SCALE = 1.3
KW = dict(beam_size=3, inter_beam=1, gen_beam=2.0, max_steps=5, max_len=64,
          t_cap=64)
# the one-shot encoder's flash path needs heads of 8 on the JAX side (see
# test_torch_port_oneshot.py)
W2V_DH8 = dataclasses.replace(W2V_TINY, encoder_embed_dim=32,
                              encoder_ffn_embed_dim=64)
MARGIN = 1e-4


def mixed_wavs():
    """Four streams of three lengths: both interleave halves run, and the
    per-stream is_end / visible schedules diverge."""
    return [chunked_audio(4, 0), chunked_audio(3, 7), chunked_audio(4, 5),
            chunked_audio(2, 9)]


@functools.lru_cache(maxsize=None)
def models(impl="dense", scale=BLANK_SCALE):
    """(w2v config, flax model, params, port model) with the blank row
    scaled; "flash" takes the 32-wide encoder."""
    w2v = (W2V_TINY if impl == "dense"
           else dataclasses.replace(W2V_DH8, attention_impl=impl))
    jax_model, params = jax_caat(w2v)
    params = dict(params)
    params["embed_tokens"] = params["embed_tokens"].copy()
    params["embed_tokens"][CAAT_TINY.bos] *= scale
    return w2v, jax_model, params, port_caat(params, w2v)


def port_decoder(name, impl="dense", scale=BLANK_SCALE, **kw):
    w2v, _, _, model = models(impl, scale)
    return getattr(beam_batched, name)(
        model, _vocab(Dictionary), port_cfg(Wav2Vec2Config, w2v),
        **dict(KW, **kw))


def record_margins(dec):
    """Wrap ``dec._beam_block``: after every block, for every running
    stream with two live pool rows, the gap between the best and the next
    length-normalized pool score.  Returns the list the gaps go to."""
    gaps = []
    block = dec._beam_block

    def recording(prefixes, nlens, scores, jk, jv, visible, is_end, active,
                  **kw):
        pool_t, pool_s = block(prefixes, nlens, scores, jk, jv, visible,
                               is_end, active, **kw)
        lens = (pool_t != dec.vocab.pad()).sum(-1).float()
        normed = dec._norm_dev(pool_s, lens, is_end[:, None])
        normed = torch.where(torch.isfinite(pool_s), normed,
                             float("-inf"))
        top = torch.sort(normed, dim=1, descending=True).values
        live = active & torch.isfinite(top[:, 1])
        gaps.extend((top[:, 0] - top[:, 1])[live].tolist())
        return pool_t, pool_s

    dec._beam_block = recording
    return gaps


@functools.lru_cache(maxsize=None)
def decode_pair(name, impl="dense", blocks=1, wire="float32", eager=True):
    """((JAX texts, delays), (port texts, delays), port pool margins) of
    decoder ``name`` on the mixed-length corpus."""
    w2v, jax_model, params, _ = models(impl)
    kw = dict(KW, eager=eager, blocks_per_step=blocks)
    ref = getattr(jax_beam, name)(jax_model, params, _vocab(JaxDictionary),
                                  w2v, **kw)
    port = port_decoder(name, impl, eager=eager, blocks_per_step=blocks)
    ref.transfer_dtype = port.transfer_dtype = wire
    gaps = record_margins(port)
    return (ref.decode_corpus(mixed_wavs()),
            port.decode_corpus(mixed_wavs()), gaps)


def assert_equal_to_jax(name, impl, blocks, wire):
    (want_t, want_d), (got_t, got_d), gaps = decode_pair(name, impl, blocks,
                                                         wire)
    assert got_t == want_t
    assert got_d == want_d
    assert len(set(got_t)) > 1 and min(len(d) for d in got_d) >= 4
    # every kept hypothesis led the next one by more than float32
    # rounding could turn around
    assert len(gaps) >= 8 and min(gaps) > MARGIN, min(gaps)


# -- the port's decoders against each other (tests/test_beam_batched.py) ---

def test_batched_beam_matches_host_searcher():
    """Unscaled blank row, gen_beam 0.5.  The host searcher returns its
    pool at the width of the longest row that survived the gen_beam cut
    and, when a shorter row is kept, appends the next chunk's tokens past
    that row's padding; the batched decoders re-seed from the row itself.
    So the two agree where no kept row is shorter than a survivor, which
    holds on these streams at this gen_beam (and not at 2.0 under a
    scaled-up blank)."""
    _, _, _, model = models(scale=1.0)
    beam, max_steps, gen_beam = 3, 5, 0.5
    wavs = [chunked_audio(4, seed) for seed in (0, 7, 5)]
    dec = port_decoder("BatchedBeamStreamingDecoder", scale=1.0, eager=True,
                       gen_beam=gen_beam)
    texts, delays = dec.decode_corpus(wavs)
    assert len(set(texts)) > 1
    for wav, text, dl in zip(wavs, texts, delays):
        engine = StreamingEngine(
            model, main_context=MC, right_context=RC,
            audio_buckets=sorted(set(prefix_lens(wav))),
            token_buckets=[8, 16, 32, 64])
        want, _ = host_decode(engine, dec.vocab, wav, beam, max_steps,
                              gen_beam, eager=True)
        assert text.split() == want, (text, want)
        assert len(dl) == len(want) >= 12
        assert (np.diff(dl) >= 0).all()
        assert max(dl) <= len(wav) / 16.0 + 1e-6


def test_batched_beam_word_gated_emission():
    """Non-eager mode emits the same token stream, only complete words
    before the stream ends."""
    wavs = [chunked_audio(4, 3)]
    t_eager, _ = port_decoder("BatchedBeamStreamingDecoder",
                              eager=True).decode_corpus(wavs)
    t_gated, d_gated = port_decoder("BatchedBeamStreamingDecoder",
                                    eager=False).decode_corpus(wavs)
    assert "".join(t_eager[0].split()) == "".join(t_gated[0].split())
    assert len(d_gated[0]) >= 8


def test_oneshot_beam_matches_incremental_beam():
    a = port_decoder("BatchedBeamStreamingDecoder", eager=True)
    b = port_decoder("OneShotBeamDecoder", eager=True)
    assert a.decode_corpus(mixed_wavs()) == b.decode_corpus(mixed_wavs())


@pytest.mark.parametrize("eager", [True, False])
def test_fused_beam_matches_oneshot_beam(eager):
    """The fused paths (device-side argmax re-seed + host replay of the
    LCP emission) emit what the per-chunk host-merged one-shot decoder
    emits, texts AND delays, eager and word-gated."""
    outs = [port_decoder(name, eager=eager).decode_corpus(mixed_wavs())
            for name in ("OneShotBeamDecoder", "FusedOneShotBeamDecoder",
                         "FusedBeamStreamingDecoder")]
    assert outs[0] == outs[1] == outs[2], (eager, outs)


@pytest.mark.parametrize("name", DECODERS)
def test_decoders_return_texts_alone_on_request(name):
    dec = port_decoder(name, eager=True)
    texts, delays = dec.decode_corpus(mixed_wavs())
    assert dec.decode_corpus(mixed_wavs(), return_delays=False) == texts
    assert [len(t.split()) for t in texts] == [len(d) for d in delays]


@pytest.mark.parametrize("name", DECODERS[2:])
def test_fused_decoders_accept_a_staged_corpus(name):
    dec = port_decoder(name, eager=True)
    dec.transfer_dtype = "int16"
    handle = dec.stage(mixed_wavs())
    assert handle[3].dtype == torch.int16 and handle[0] == 4
    assert dec.decode_corpus(handle) == dec.decode_corpus(mixed_wavs())


@pytest.mark.parametrize("name", DECODERS[2:])
def test_fused_decoders_refuse_other_operating_points(name):
    for kw in (dict(inter_beam=2), dict(merge_add=True)):
        with pytest.raises(ValueError):
            port_decoder(name, **kw).decode_corpus(mixed_wavs())


def test_inter_beam_two_and_add_merge_run_unfused():
    """inter_beam 2 with logaddexp merging (the host tail keeps two
    hypotheses): streaming == one-shot, and no NaN reaches the texts."""
    kw = dict(inter_beam=2, merge_add=True, eager=False)
    a = port_decoder("BatchedBeamStreamingDecoder", **kw)
    b = port_decoder("OneShotBeamDecoder", **kw)
    out = a.decode_corpus(mixed_wavs())
    assert out == b.decode_corpus(mixed_wavs())
    assert all(len(d) >= 4 for d in out[1])


def test_oneshot_needs_t_cap_for_the_corpus():
    dec = port_decoder("OneShotBeamDecoder", t_cap=12)
    with pytest.raises(ValueError):
        dec.decode_corpus(mixed_wavs())          # 18 frames > 12


def test_carried_prefix_cache_never_shrinks():
    from wav2vec_s_tpu_torch.stream import caat_step

    z = [torch.zeros(8, 2, 4)]
    lm = caat_step.LMState(k=z, v=z, h_last=torch.zeros(2, 4))
    grown = beam_batched.BatchedBeamStreamingDecoder._pad_carry(lm, 12)
    assert grown.k[0].shape == (12, 2, 4) and grown.h_last is lm.h_last
    assert beam_batched.BatchedBeamStreamingDecoder._pad_carry(lm, 8) is lm
    with pytest.raises(ValueError):
        beam_batched.BatchedBeamStreamingDecoder._pad_carry(lm, 4)
