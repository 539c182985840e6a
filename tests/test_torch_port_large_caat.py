"""wav2vec-S Large + CAAT Large on the port's streaming paths, held to the
benchmark's plain float32 reference (``w2vs_bench/reference/w2v2_caat.py``)
at small widths on the CPU.

The layout is ``w2vs_bench/configs/w2vs_large_caat.json``'s: the pre-LN
encoder (a norm before attention and before the FFN, the post-stack norm),
conv bias and a layer norm in every conv block, 16 heads, the pre-norm LM
and jointer with a tied embedding, blocks of 16 frames with 8 look-ahead
copies, two blocks a step.  Only the widths and depths are cut (64 wide,
FFN 128, 2 + 2 + 2 layers, 60 words); the weights are the benchmark's own
seeded draw (``w2vs_bench.model.make_weights``), with the blank row of the
tied embedding scaled so that some chunks end on a blank (at these widths
the unscaled blank wins every decision).

``ServingSession`` (four streams of three lengths joining on two slots,
both slots recycled, the plane compacted) and ``CachedFusedGreedyDecoder``
(one corpus of three streams) each serve their streams; then, per stream,
- the encoder output the path left (every committed row, the look-ahead
  flush included) is held to the reference's whole-utterance encode;
- the jointer's log-probs at every greedy decision (each emitted token,
  and the blank that closed a chunk early: ``reference.decisions``) are
  held to the reference's, over the same prefix and visible frames.

Tolerances: both sides compute in float32; the port sums in other orders
(the two-part softmax over cache and chunk, the slot caches, batched
projections), a few float32 ulps a layer.  The port reads at most 4.7e-7
(the encoder's relative error) and 4.8e-6 (log-probs) here, so ``ENC_TOL``
and ``LP_TOL`` leave 20x room; the port computing in bfloat16 reads 1.1e-2
and 4e-2 to 6e-2, which ``test_bfloat16_fails_the_tolerances`` pins.
"""

import copy
import json

import numpy as np
import pytest
import torch

from w2vs_bench import served as sv
from w2vs_bench.harness import BENCH_DIR
from w2vs_bench.model import build_program_model, make_vocab, make_weights
from w2vs_bench.reference import w2v2_caat as ref
from w2vs_bench.tests.tiny import TINY_CONVS
from wav2vec_s_tpu_torch.stream import caat_step
from wav2vec_s_tpu_torch.stream.batched import CachedFusedGreedyDecoder
from wav2vec_s_tpu_torch.stream.serving import ServingSession

ENC_TOL = 1e-5
LP_TOL = 1e-4
SEED = 2_100_000_021
BLOCKS, MAX_LEN, MAX_EMIT = 2, 24, 4
#: the blank row's scale: 1 to 3 of the 27 to 29 decisions of each path
#: are blanks
BLANK_SCALE = 0.8
#: serving: four streams of 1-3 chunks on two slots, in the order they
#: join (the last two join once the first two have finished, so the plane
#: is compacted under them); the cached decoder: one corpus
SERVE_SECONDS, CORPUS_SECONDS, CORPUS_STREAMS = (1.4, 2.0, 2.6, 2.0), 2.2, 3
T_CAP = 128


def large_config(dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(json.loads(
        (BENCH_DIR / "configs" / "w2vs_large_caat.json").read_text()))
    cfg["w2v"].update(conv_feature_layers=TINY_CONVS, encoder_layers=2,
                      encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                      dtype=dtype)
    cfg["caat"].update(vocab_size=60, decoder_layers=2, decoder_embed_dim=64,
                       decoder_ffn_embed_dim=128, jointer_layers=2,
                       jointer_embed_dim=64, jointer_ffn_embed_dim=128,
                       dtype=dtype)
    return cfg


def _model(cfg):
    """The program's model and the reference's float32 weights, the blank
    row scaled in both."""
    model, w2v, caat = build_program_model(cfg, SEED, torch.device("cpu"))
    W = {k: v.float() for k, v in make_weights(cfg, SEED, "cpu").items()}
    with torch.no_grad():       # the tied rows, one copy each here
        for w in (model.decoder.lm.embed_tokens.weight,
                  model.decoder.transducer_out.output_proj.weight):
            w[caat.bos] *= BLANK_SCALE
    W["decoder.lm.embed_tokens.weight"][caat.bos] *= BLANK_SCALE
    return model, w2v, W


def _audio(n: int, salt: int) -> np.ndarray:
    rng = np.random.default_rng([SEED, salt])
    return (rng.standard_normal(int(n * 16000)) * 0.1).astype(np.float32)


class Recorder:
    """``caat_step.jointer_step`` with every call's log-probs kept."""

    def __init__(self, monkeypatch):
        real = caat_step.jointer_step
        self.calls = []

        def step(*a, **k):
            lp = real(*a, **k)
            self.calls.append(lp.clone())
            return lp
        monkeypatch.setattr(caat_step, "jointer_step", step)


def serve(model, w2v, vocab, monkeypatch):
    """Streams through ``ServingSession``: (audio, text, delays, encoder
    rows, {chunk: [log-probs [V] of the chunk's iterations]}) each."""
    sess = ServingSession(model, vocab, w2v, n_slots=2, t_cap=T_CAP,
                          blocks_per_step=BLOCKS, max_len=MAX_LEN,
                          max_emit_per_chunk=MAX_EMIT)
    rec = Recorder(monkeypatch)
    stride, W = sess.stride, sess.window
    waiting = [(f"s{i}", _audio(n, i)) for i, n in enumerate(SERVE_SECONDS)]
    live, out = {}, {}
    while waiting or live:
        while waiting and sess.add_stream(waiting[0][0]):
            sid, wav = waiting.pop(0)
            n_chunks = sv.chunks_of(len(wav), sess.enc.rf, sess.enc.hop,
                                    sess.rc, sess.n_main)
            live[sid] = dict(wav=wav, n_chunks=n_chunks, chunk=0, lps={})
        slot_of = {}
        for sid, st in live.items():
            last = st["chunk"] == st["n_chunks"] - 1
            end = len(st["wav"]) if last else st["chunk"] * stride + W
            start = 0 if st["chunk"] == 0 else (st["chunk"] - 1) * stride + W
            sess.push(sid, st["wav"][start:end], is_end=last)
            slot_of[sid] = sess._by_id[sid]
        first = len(rec.calls)
        sess.step()
        lps = rec.calls[first:]
        assert len(lps) == MAX_EMIT
        for sid, slot in slot_of.items():
            st = live[sid]
            st["lps"][st["chunk"]] = [lp[slot] for lp in lps]
            st["chunk"] += 1
            if st["chunk"] == st["n_chunks"]:
                rows = sess._vis[slot].nonzero()[:, 0]
                out[sid] = (st["wav"], *sess.result(sid),
                            sess._estate.out_cache[rows, slot].clone(),
                            st["lps"])
                del live[sid]
    assert sess.compactions > 0
    return list(out.values()), sess.enc


def decode(model, w2v, vocab, monkeypatch):
    """One corpus through ``CachedFusedGreedyDecoder``, the same per
    stream as ``serve``."""
    dec = CachedFusedGreedyDecoder(model, vocab, w2v, max_len=MAX_LEN,
                                   max_emit_per_chunk=MAX_EMIT, t_cap=T_CAP,
                                   blocks_per_step=BLOCKS)
    enc = dec._encoder(CORPUS_STREAMS)
    init, states = enc.init, []
    monkeypatch.setattr(enc, "init", lambda: states.append(init()) or
                        states[-1])
    rec = Recorder(monkeypatch)
    wavs = [_audio(CORPUS_SECONDS, 10 + i) for i in range(CORPUS_STREAMS)]
    texts, delays = dec.decode_corpus(wavs)
    n_chunks = sv.chunks_of(len(wavs[0]), enc.rf, enc.hop, enc.rc,
                            enc.n_main)
    assert len(rec.calls) == n_chunks * MAX_EMIT
    n_rows = n_chunks * enc.n_main + enc.rc
    return [(wavs[i], texts[i], delays[i],
             states[-1].out_cache[:n_rows, i].clone(),
             {c: [lp[i] for lp in rec.calls[c * MAX_EMIT:(c + 1) * MAX_EMIT]]
              for c in range(n_chunks)})
            for i in range(CORPUS_STREAMS)], enc


PATHS = {"serving": serve, "cached": decode}


def errors(cfg, path, monkeypatch):
    """(the largest encoder error, the largest log-prob error, decisions
    compared, blanks among them) over the path's streams."""
    model, w2v, W = _model(cfg)
    vocab = make_vocab(cfg["caat"]["vocab_size"])
    streams, enc = PATHS[path](model, w2v, vocab, monkeypatch)
    geo = (enc.rf, enc.hop, enc.rc, enc.n_main, enc.window)
    f32 = ref.Arith("float32")
    enc_err, lp_err, n_dec, n_blank = 0.0, 0.0, 0, 0
    for wav, text, delays, rows, lps in streams:
        s = sv.served(None, text, delays, vocab, len(wav), geo)
        T = s.n_chunks * enc.n_main + enc.rc
        assert rows.shape[0] == T
        with torch.no_grad():
            mine = ref.encode(W, cfg["w2v"], torch.from_numpy(wav), T, f32)
            h = ref.lm_states(W, cfg["caat"], s.tokens, f32, "cpu")
        enc_err = max(enc_err, float((rows.float() - mine).norm()
                                     / mine.norm()))
        pts = ref.decisions(s.tokens, s.chunk_of, s.n_chunks, MAX_EMIT,
                            MAX_LEN)
        in_chunk = {}
        for j, c, sym in pts:
            k = in_chunk[c] = in_chunk.get(c, -1) + 1
            vis = (c + 1) * enc.n_main + (enc.rc if c == s.n_chunks - 1
                                          else 0)
            with torch.no_grad():
                want = ref.joint_log_probs(W, cfg["caat"], h[j:j + 1], mine,
                                           torch.tensor([vis]), f32)[0]
            got = lps[c][k].float().clone()
            got[ref.PAD] = -float("inf")
            got = got.log_softmax(-1)
            keep = torch.isfinite(want)
            lp_err = max(lp_err, float((got - want)[keep].abs().max()))
            n_dec += 1
            n_blank += sym == ref.BLANK
    return enc_err, lp_err, n_dec, n_blank


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_large_layout_equals_the_reference(path, monkeypatch):
    enc_err, lp_err, n_dec, n_blank = errors(large_config(), path,
                                             monkeypatch)
    # the decisions hold tokens and blanks alike
    assert n_dec >= 20 and 0 < n_blank < n_dec
    assert enc_err <= ENC_TOL and lp_err <= LP_TOL, (enc_err, lp_err)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_bfloat16_fails_the_tolerances(path, monkeypatch):
    """The same paths computing in the configuration's bfloat16 read far
    above both tolerances: they are tight enough to see the precision."""
    enc_err, lp_err, _, _ = errors(large_config("bfloat16"), path,
                                   monkeypatch)
    assert enc_err > 10 * ENC_TOL and lp_err > 10 * LP_TOL, (enc_err, lp_err)
