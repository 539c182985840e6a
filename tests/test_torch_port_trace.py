"""The port's own tracing (``wav2vec_s_tpu_torch/utils/debug.py``): spans
and counters, on only while a ``torch.profiler`` runs.

- With no profiler, ``span`` is the shared null context and no counter
  moves over a corpus or a serving step.
- Under ``torch.profiler`` (CPU activity, tiny widths) the ``w2vs/``
  spans of an agent corpus, a one-shot corpus, serving steps and the
  training CLI's updates appear under their caller's range, and every
  ``aten::`` operator of a corpus and of a ``step()`` lies inside one of
  the program's spans.  The prefix is the one the benchmark's breakdown
  reads (``w2vs_bench.trace.SPAN``).
- The emission counters equal a hand count from a copy of the masked
  loop, over planted emissions (``caat_step.jointer_step`` scripted):
  drawn at random, every stream blocked after iteration 1, streams
  running into ``max_len``; on the CPU no chunk's loop is replayed from
  a CUDA graph (``decoder.emit_iters_graphed`` 0, which the benchmark's
  ``emit_graphed.decode`` reads); the session counts only the two that its
  metric reads.  Planted emissions on every iteration fill the decoders'
  LM cache to its last row.  ``serving.plane_rows_visible`` equals the
  rows of the plane visible to the occupied slots when the jointer reads
  it, ``serving.plane_rows_read`` the plane's size, and
  ``serving.jointer_rows_loaded`` the sum of the extents the jointer is
  handed (each occupied slot's ``[first_row, t_main)``, every visible row
  inside), across compactions and slot resets.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tests.test_torch_port_cli import _overrides, corpus  # noqa: F401
from w2vs_bench import trace as bench_trace
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.models.caat import CaatConfig, W2V2CaatModel
from wav2vec_s_tpu_torch.models.modules import random_init_
from wav2vec_s_tpu_torch.stream import caat_step
from wav2vec_s_tpu_torch.stream.batched import (
    CachedFusedGreedyDecoder, OneShotCorpusDecoder)
from wav2vec_s_tpu_torch.stream.serving import ServingSession
from wav2vec_s_tpu_torch.train import cli
from wav2vec_s_tpu_torch.utils import debug

torch.set_num_threads(1)

W2V = Wav2Vec2Config(
    conv_feature_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)),
    encoder_layers=2, encoder_embed_dim=24, encoder_ffn_embed_dim=48,
    encoder_attention_heads=4, main_context=4, right_context=2)
CAAT = CaatConfig(
    vocab_size=30, decoder_layers=1, decoder_embed_dim=24,
    decoder_ffn_embed_dim=48, decoder_attention_heads=4, jointer_layers=2,
    jointer_embed_dim=24, jointer_ffn_embed_dim=48, jointer_attention_heads=4)
MAX_EMIT = 4
DECODERS = {"cached": CachedFusedGreedyDecoder,
            "oneshot": OneShotCorpusDecoder}


def _vocab():
    v = Dictionary()
    for i in range(CAAT.vocab_size - v.nspecial):
        v.add_symbol(f"w{i}")
    return v


def _model():
    return random_init_(W2V2CaatModel(W2V, CAAT),
                        torch.Generator().manual_seed(0))


def _wavs(n, samples=900):
    rng = np.random.default_rng(0)
    return [rng.standard_normal(samples).astype(np.float32) * 0.3
            for _ in range(n)]


def _decoder(kind, max_len=64):
    return DECODERS[kind](_model(), _vocab(), W2V, max_len=max_len,
                          max_emit_per_chunk=MAX_EMIT, t_cap=128,
                          blocks_per_step=1)


def _session(n_slots=2, t_cap=64, max_len=64):
    return ServingSession(_model(), _vocab(), W2V, n_slots=n_slots,
                          t_cap=t_cap, blocks_per_step=1, max_len=max_len,
                          max_emit_per_chunk=MAX_EMIT)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh_counters():
    debug.reset_counters()
    yield
    debug.reset_counters()


# -- off -------------------------------------------------------------------

def test_off_span_is_the_shared_null_context_and_nothing_counts():
    assert not debug.tracing()
    assert debug.span("decoder.setup") is debug.span("serving.step")
    with debug.span("x") as inner:
        assert inner is None
    debug.count("decoder.tokens", 5)
    dec = _decoder("cached")
    dec.decode_corpus(dec.stage(_wavs(2)))
    sess = _session()
    assert sess.add_stream("a")
    sess.push("a", _wavs(1)[0], is_end=True)
    sess.drain()
    assert debug.counters() == {}


def test_on_under_a_profiler_and_prefix_is_the_benchmarks():
    assert debug.SPAN == bench_trace.SPAN
    with _cpu_profile():
        assert debug.tracing()
        debug.count("x", 2)
        debug.count("x")
        assert debug.span("x") is not debug.span("x")
    assert not debug.tracing()
    debug.count("x", 10)
    assert debug.counters() == {"x": 3}


# -- spans -------------------------------------------------------------------

def _events(prof):
    """(name, start, end, thread) of the user ranges and of the host
    operators of a profile."""
    ranges, ops = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                e.start_thread_id())
        (ranges if e.is_user_annotation() else ops).append(item)
    return ranges, ops


def _inside(item, outer):
    return outer[1] <= item[1] and item[2] <= outer[2]


def _check_tiling(prof, parent, prefix, want):
    """Every program span of ``prefix`` lies inside a ``parent`` range,
    the names are ``want``, spans of one thread do not overlap, and every
    ``aten::`` operator inside a parent lies inside a program span."""
    ranges, ops = _events(prof)
    parents = [r for r in ranges if r[0] == parent]
    spans = [r for r in ranges if r[0].startswith(prefix)]
    assert parents and spans
    assert {r[0][len(debug.SPAN):] for r in spans} == want
    for s in spans:
        assert any(_inside(s, p) for p in parents), s
    ordered = sorted(spans, key=lambda r: r[1])
    for a, b in zip(ordered, ordered[1:]):
        assert a[2] <= b[1], (a, b)              # they tile, none nested
    thread = parents[0][3]
    n_ops = 0
    for op in ops:
        if (op[0].startswith("aten::") and op[3] == thread
                and any(_inside(op, p) for p in parents)):
            n_ops += 1
            assert any(_inside(op, s) for s in spans), op
    assert n_ops > 0


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_a_corpus_is_tiled_by_decoder_spans(kind):
    dec = _decoder(kind)
    handle = dec.stage(_wavs(3))
    dec.decode_corpus(handle)                        # builds the encoder
    with _cpu_profile() as prof:
        with record_function("w2vs/decode_corpus"):
            dec.decode_corpus(handle)
    want = {"decoder.setup", "decoder.jointer_kv", "decoder.emit_loop",
            "decoder.readback", "decoder.texts"}
    want |= ({"decoder.encoder_step"} if kind == "cached"
             else {"decoder.encode"})
    _check_tiling(prof, "w2vs/decode_corpus", "w2vs/decoder.", want)


def test_serving_steps_are_tiled_by_serving_spans():
    sess = _session()
    with _cpu_profile() as prof:
        _serve(sess)
    assert sess.compactions > 0
    _check_tiling(prof, "w2vs/step", "w2vs/serving.", {
        "serving.compact", "serving.gather", "serving.upload",
        "serving.reset", "serving.encoder_step", "serving.jointer_kv",
        "serving.emit_loop", "serving.readback", "serving.words"})


def test_train_updates_carry_the_train_spans(corpus):  # noqa: F811
    argv = _overrides(corpus, "traced", **{
        "run.max_update": 2, "run.save_interval_updates": 0,
        "run.validate_interval_updates": 0})
    with _cpu_profile() as prof:
        with record_function("w2vs/main"):
            cli.main(argv)
    ranges, _ = _events(prof)
    main = [r for r in ranges if r[0] == "w2vs/main"]
    train = sorted((r for r in ranges if r[0].startswith("w2vs/train.")),
                   key=lambda r: r[1])
    names = [r[0][len("w2vs/train."):] for r in train]
    assert all(_inside(r, main[0]) for r in train)
    # each update: wait for its batch, forward, backward, optimizer
    steps = [n for n in names if n != "data_wait"]
    assert steps == ["forward", "backward", "optimizer"] * 2
    assert names.count("data_wait") >= 2
    for a, b in zip(train, train[1:]):
        assert a[2] <= b[1]


# -- counters ----------------------------------------------------------------

class Script:
    """``caat_step.jointer_step`` replaced by planted picks: call c of the
    run returns log-probs whose argmax for stream i is ``toks[c, i]``;
    ``on_call(c, visible)`` sees each call's plane or counts."""

    def __init__(self, case, n, calls=400, seed=0):
        rng = np.random.default_rng(seed)
        blank = _vocab().bos()
        words = rng.integers(4, CAAT.vocab_size, (calls, n))
        if case == "random":
            toks = np.where(rng.random((calls, n)) < 0.45, blank, words)
        elif case == "blocked_after_1":
            toks = words.copy()
            toks[1::MAX_EMIT] = blank        # iteration 1 of every run
        else:                                # "max_len": never blank
            toks = words
        self.toks, self.calls, self.on_call = toks, 0, None

    def __call__(self, model, caat, h_last, jk, jv, visible):
        c = self.calls
        self.calls += 1
        if self.on_call is not None:
            self.on_call(c, visible)
        lp = torch.full((h_last.shape[0], CAAT.vocab_size), -10.0)
        lp[torch.arange(h_last.shape[0]), torch.from_numpy(
            self.toks[c])] = 0.0
        return lp


def _hand_count(toks, runs, max_len):
    """A copy of the masked emission loop on the host, counting.  ``runs``
    holds, per run, the streams it ran for (``ready``) and the prefix
    lengths at its start (None: those the previous run left)."""
    blank = _vocab().bos()
    n = {"emit_iters": 0, "emit_iters_live": 0, "emit_iters_emitting": 0,
         "tokens": 0}
    for r, (ready, start) in enumerate(runs):
        lens = lens if start is None else start.copy()
        blocked = ~ready
        for j in range(MAX_EMIT):
            tok = toks[r * MAX_EMIT + j]
            n["emit_iters"] += 1
            n["emit_iters_live"] += bool((~blocked).any())
            emit = ~blocked & (tok != blank) & (lens < max_len)
            n["emit_iters_emitting"] += bool(emit.any())
            n["tokens"] += int(emit.sum())
            lens = lens + emit
            blocked = blocked | ~emit
    return n


CASES = ["random", "blocked_after_1", "max_len"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_decoder_emission_counters_equal_a_hand_count(monkeypatch, kind,
                                                      case):
    N = 3
    max_len = 6 if case == "max_len" else 64
    script = Script(case, N)
    monkeypatch.setattr(caat_step, "jointer_step", script)
    dec = _decoder(kind, max_len=max_len)
    with _cpu_profile():
        dec.decode_corpus(dec.stage(_wavs(N)))
    n_chunks = script.calls // MAX_EMIT
    assert n_chunks == 10
    runs = [(np.ones(N, bool), np.ones(N, np.int64) if k == 0 else None)
            for k in range(n_chunks)]
    want = _hand_count(script.toks, runs, max_len)
    want["emit_iters_graphed"] = 0                  # eager on the CPU
    assert debug.counters() == {f"decoder.{k}": v for k, v in want.items()}
    if case == "blocked_after_1":
        assert want["emit_iters_live"] == 2 * n_chunks
        assert want["emit_iters_emitting"] == n_chunks
    if case == "max_len":
        assert want["tokens"] == N * (max_len - 1)


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_decoder_lm_holds_the_longest_prefix(monkeypatch, kind):
    """A corpus of the most chunks ``t_cap`` holds, every stream emitting
    on every iteration (planted, as above), writes the LM cache's last row:
    the decoders size it at min(max_len, chunks x max_emit) + 1 rows."""
    N = 2
    script = Script("max_len", N)                   # never blank
    monkeypatch.setattr(caat_step, "jointer_step", script)
    dec = _decoder(kind, max_len=256)
    enc = dec._encoder(N)
    chunks = (dec.t_cap - enc.rc) // enc.n_main
    frames = chunks * enc.n_main + enc.rc
    dec.decode_corpus(dec.stage(_wavs(N, (frames - 1) * enc.hop + enc.rf)))
    assert script.calls == chunks * MAX_EMIT
    assert dec._loop.lm.k[0].shape[0] == chunks * MAX_EMIT + 1
    assert (dec._loop.lens == chunks * MAX_EMIT + 1).all()


@pytest.mark.parametrize("snapshot,want", [
    ({"decoder.emit_iters": 60}, None),          # a program without it
    ({"decoder.emit_iters_graphed": 45, "decoder.emit_iters": 60}, 75.0),
    ({"decoder.emit_iters_graphed": 0, "decoder.emit_iters": 60}, 0.0),
    ({"decoder.emit_iters_graphed": 0}, None),
])
def test_emit_graphed_reader(monkeypatch, snapshot, want):
    """``emit_graphed.decode`` reads ``decoder.emit_iters_graphed`` over
    ``decoder.emit_iters`` in %, and is silent where either is missing."""
    from w2vs_bench import harness, program_counters

    monkeypatch.setattr(program_counters, "snapshot", lambda: snapshot)
    assert harness.metric_reader("emit_graphed.decode")(None) == want


def _serve(sess, lengths=(500, 700, 500, 400, 600), stall="s1"):
    """Streams of ``lengths`` samples through the session's slots, each
    admitted once a slot is free, every ``step()`` under a ``w2vs/step``
    range; ``stall`` gets its first 200 samples (its first chunk), the
    rest three steps later."""
    rng = np.random.default_rng(1)
    wavs = {f"s{i}": rng.standard_normal(n).astype(np.float32) * 0.3
            for i, n in enumerate(lengths)}
    waiting, held, steps = list(wavs), {}, 0
    while waiting or sess._by_id:
        while waiting and sess.add_stream(waiting[0]):
            sid = waiting.pop(0)
            if sid == stall:
                sess.push(sid, wavs[sid][:200])
                held[sid] = steps + 3
            else:
                sess.push(sid, wavs[sid], is_end=True)
        for sid, at in list(held.items()):
            if steps >= at:
                sess.push(sid, wavs[sid][200:], is_end=True)
                del held[sid]
        with record_function("w2vs/step"):
            sess.step()
        steps += 1


@pytest.mark.parametrize("case", CASES)
def test_serving_counters_equal_a_hand_count(monkeypatch, case):
    max_len = 6 if case == "max_len" else 64
    script = Script(case, 2)
    sess = _session(max_len=max_len)
    runs, resets, planes, loaded = [], [], [], []
    device_step = sess._device_step

    def recorded(window, ready, flush, reset, extent, any_reset):
        runs.append((ready.numpy().copy(),
                     torch.where(reset, 1, sess._lens).numpy()))
        resets.append(any_reset)
        return device_step(window, ready, flush, reset, extent, any_reset)

    def on_call(c, slot_plane):
        visible, lo, hi = slot_plane
        if c % MAX_EMIT == 0:                # once a step: the plane read
            occupied = torch.tensor([s.stream_id is not None
                                     for s in sess.slots])
            planes.append((int(visible[occupied].sum()), visible.numel()))
            # the extents: [first_row, hi) for an occupied slot, empty for
            # a free one, every visible row inside
            first = torch.tensor([s.first_row for s in sess.slots])
            assert torch.equal(lo[occupied], first[occupied])
            assert (lo[~occupied] == hi).all()
            rows = torch.arange(visible.shape[1])[None]
            assert not (visible[occupied]
                        & ((rows < lo[occupied, None]) | (rows >= hi))).any()
            loaded.append(int((hi - lo).sum()))
    script.on_call = on_call
    monkeypatch.setattr(sess, "_device_step", recorded)
    monkeypatch.setattr(caat_step, "jointer_step", script)
    with _cpu_profile():
        _serve(sess)
    assert sess.compactions > 0 and any(resets[1:])   # a recycled slot
    assert not all(r.all() for r, _ in runs)          # a stalled slot
    want = _hand_count(script.toks, runs, max_len)
    c = debug.counters()
    assert set(c) == {"serving.emit_iters", "serving.emit_iters_live",
                      "serving.plane_rows_read", "serving.plane_rows_visible",
                      "serving.jointer_rows_loaded"}
    assert {k: c[f"serving.{k}"] for k in ("emit_iters", "emit_iters_live")
            } == {k: want[k] for k in ("emit_iters", "emit_iters_live")}
    assert c["serving.plane_rows_read"] == sum(n for _, n in planes) == (
        len(runs) * 2 * 64)
    assert c["serving.plane_rows_visible"] == sum(v for v, _ in planes)
    assert c["serving.jointer_rows_loaded"] == sum(loaded)
    assert (c["serving.plane_rows_visible"] < c["serving.jointer_rows_loaded"]
            < c["serving.plane_rows_read"])
