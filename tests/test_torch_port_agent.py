"""The SimulEval agent and the scoring copies of the torch port, against the
JAX package.

- ``SpeechTransducerAgent`` + ``SimulEvaluator`` over the port's host
  searcher and engine give the JAX evaluator's words and per-word delays
  (equal), and ``summarize`` the same AL / AP / DAL and quality (equal;
  the computation-aware AL_CA reads the wall clock and is left out);
- ``stream/latency.py``, ``eval/wer.py`` and ``eval/bleu.py`` equal their
  originals on hand values and on seeded random inputs (one parametrised
  test).
"""

import dataclasses
import importlib

import numpy as np
import pytest

from tests.test_caat import W2V_TINY
from tests.test_torch_port_greedy import _vocab
from tests.test_torch_port_serving import models
from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
from wav2vec_s_tpu.stream import agent as jax_agent
from wav2vec_s_tpu.stream import latency as jax_latency
from wav2vec_s_tpu.stream.engine import StreamingEngine as JaxEngine
from wav2vec_s_tpu.stream.searcher import (
    StreamingTransducerSearcher as JaxSearcher)
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.stream import agent, latency
from wav2vec_s_tpu_torch.stream.engine import StreamingEngine
from wav2vec_s_tpu_torch.stream.searcher import StreamingTransducerSearcher

MC, RC = W2V_TINY.main_context, W2V_TINY.right_context
ENGINE_KW = dict(main_context=MC, right_context=RC,
                 audio_buckets=[800, 1600], token_buckets=[8, 16, 32])
AGENT_KW = dict(main_context=MC, right_context=RC, frame_samples=20,
                intra_beam=3, inter_beam=1, decoder_step_read=4, eager=True,
                max_len_a=0.3, max_len_b=-2.0, len_scale=0.7)


def _evaluators(step_read_blocks, segment_ms):
    jax_model, params, model = models()
    ref = JaxSearcher(JaxEngine(jax_model, params, **ENGINE_KW),
                      _vocab(JaxDictionary), eager=True, len_scale=0.7)
    port = StreamingTransducerSearcher(StreamingEngine(model, **ENGINE_KW),
                                       _vocab(Dictionary), eager=True,
                                       len_scale=0.7)
    kw = dict(AGENT_KW, step_read_blocks=step_read_blocks)
    jcfg = jax_agent.AgentConfig(**kw)
    pcfg = agent.AgentConfig(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return (jax_agent.SimulEvaluator(
                lambda: jax_agent.SpeechTransducerAgent(ref, jcfg),
                segment_size_ms=segment_ms),
            agent.SimulEvaluator(
                lambda: agent.SpeechTransducerAgent(port, pcfg),
                segment_size_ms=segment_ms))


@pytest.mark.parametrize("metric,step_read_blocks,segment_ms",
                         [("bleu", 1, 10), ("wer", 2, 25)])
def test_simul_evaluator_matches_jax(metric, step_read_blocks, segment_ms):
    rng = np.random.default_rng(11)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.3
            for n in (1500, 1100)]
    refs = ["w5 w22 w5", "w22 w3"]
    ref_ev, port_ev = _evaluators(step_read_blocks, segment_ms)
    want = [ref_ev.run_instance(w, r) for w, r in zip(wavs, refs)]
    got = [port_ev.run_instance(w, r) for w, r in zip(wavs, refs)]
    for g, w in zip(got, want):
        assert (g.hypo, g.delays_ms, g.source_len_ms) == (
            w.hypo, w.delays_ms, w.source_len_ms)
        assert g.delays_ms == sorted(g.delays_ms)
        assert len(g.elapsed_ms) == len(g.delays_ms)
    assert any(g.hypo for g in got), "the agent emitted nothing"
    got_s = agent.summarize(got, metric)
    want_s = jax_agent.summarize(want, metric)
    got_s.pop("AL_CA"), want_s.pop("AL_CA")
    assert got_s == want_s


def _rand_text(rng, n, vocab=6):
    return " ".join(f"t{i}" for i in rng.integers(0, vocab, n))


def _scoring_cases():
    rng = np.random.default_rng(5)
    hyps = [_rand_text(rng, rng.integers(0, 12)) for _ in range(20)]
    refs = [_rand_text(rng, rng.integers(1, 12)) for _ in range(20)]
    delays = [np.sort(rng.uniform(0, 3000, rng.integers(1, 15))).tolist()
              for _ in range(10)]
    hand_hyps = ["the cat sat on the mat", "", "a b c d"]
    hand_refs = ["the cat sat on a mat", "nothing here", "a b c d"]
    return {
        # (module, function name, args)
        "latency_hand": [("lat", n, ([100.0, 200.0, 300.0, 400.0], 400.0,
                                     3)) for n in ("average_lagging",
                                                   "differentiable_average_"
                                                   "lagging")]
        + [("lat", "average_proportion", ([100.0, 200.0, 300.0], 400.0)),
           ("lat", "average_proportion", ([], 400.0)),
           ("lat", "average_lagging", ([], 400.0, 3)),
           ("lat", "average_lagging", ([500.0, 600.0], 400.0, None))],
        "latency_random": [("lat", n, (d, 3000.0, len(d) + k))
                           for k, d in enumerate(delays)
                           for n in ("average_lagging",
                                     "differentiable_average_lagging")]
        + [("lat", "average_proportion", (d, 3000.0)) for d in delays],
        "wer_hand": [("wer", "wer", (h, r)) for h, r in zip(hand_hyps,
                                                             hand_refs)]
        + [("wer", "corpus_wer", (hand_hyps, hand_refs))],
        "wer_random": [("wer", "corpus_wer", (hyps, refs))]
        + [("wer", "levenshtein", (h.split(), r.split()))
           for h, r in zip(hyps, refs)],
        "bleu_hand": [("bleu", "_fallback_corpus_bleu", (hand_hyps,
                                                         hand_refs)),
                      ("bleu", "corpus_bleu", (hand_hyps, hand_refs))]
        + [("bleu", "sentence_bleu", (h, r))
           for h, r in zip(hand_hyps, hand_refs)],
        "bleu_random": [("bleu", "_fallback_corpus_bleu", (hyps, refs)),
                        ("bleu", "corpus_bleu", (hyps, refs))]
        + [("bleu", "sentence_bleu", (h, r)) for h, r in zip(hyps, refs)],
    }


SCORING = _scoring_cases()
# (the packages' ``eval`` binds the name ``wer`` to the function)
MODULES = {"lat": (latency, jax_latency)}
for _name in ("wer", "bleu"):
    MODULES[_name] = tuple(importlib.import_module(f"{pkg}.eval.{_name}")
                           for pkg in ("wav2vec_s_tpu_torch",
                                       "wav2vec_s_tpu"))
bleu = MODULES["bleu"][0]


@pytest.mark.parametrize("case", sorted(SCORING))
def test_scoring_copies_match_originals(case):
    for mod, name, args in SCORING[case]:
        mine, theirs = (getattr(m, name) for m in MODULES[mod])
        assert mine(*args) == theirs(*args), (name, args)
    if case == "bleu_hand":
        assert 0 < bleu._fallback_corpus_bleu(*SCORING[case][0][2]) < 100
    if case == "latency_hand":
        # by hand: lags 100, 200 - 400/3, 300 - 800/3, 400 - 400 over the
        # 4 words up to the first that saw the whole source
        assert latency.average_lagging([100.0, 200.0, 300.0, 400.0], 400.0,
                                       3) == pytest.approx(50.0)
