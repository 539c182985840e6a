"""Streaming agent + in-process simultaneous evaluation (torch port of
``wav2vec_s_tpu/stream/agent.py``; the policy loop is host code over the
port's ``stream/searcher.py`` and ``stream/engine.py``).

- ``SpeechTransducerAgent`` ~ ``FullyTransducerAgent``
  (rain/simul/transducer_searcher.py:463-763): READ until ``init_frames =
  mc + rc`` conv frames of audio have arrived, then run the searcher every
  ``step_frames * step_read_blocks`` new frames; emitted words queue as
  WRITE actions; ``max_steps = max_len_a * (samples/160) - max_len_b -
  len(prev)`` caps generation (:734).
- ``SimulEvaluator`` ~ the SimulEval client/server loop + scorer
  (simuleval/simuleval/cli.py:81-235, scorer/instance.py:228-301): serves
  ``segment_size``-ms chunks, records the ms of source consumed at each
  emitted word (delay) and wall-clock elapsed (computation-aware delay),
  reports corpus BLEU/WER + AL/AP/DAL (+ _CA variants).

The HTTP client/server flavour of this harness lives in
``stream/server.py`` and ``stream/client.py``; this in-process version runs
the same policy loop without sockets.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np

from wav2vec_s_tpu_torch.stream.latency import (
    average_lagging, average_proportion, differentiable_average_lagging)
from wav2vec_s_tpu_torch.stream.searcher import (
    SearchState, StreamingTransducerSearcher)

SAMPLES_PER_FRAME = 320      # conv hop @ 16 kHz
SAMPLES_PER_MS = 16


@dataclasses.dataclass
class AgentConfig:
    main_context: int = 16
    right_context: int = 8
    # samples per ENCODER frame: 320 for the wav2vec conv stack, 160 *
    # subsample (=640) for the fbank family (10 ms shift x 4 conv
    # subsampling — rain's fbank agents count frames the same way)
    frame_samples: int = 320
    step_read_blocks: int = 2          # DECISION_STEP in the eval scripts
    segment_size_ms: int = 25          # speech_fullytransducer_agent.py
    intra_beam: int = 5
    inter_beam: int = 1
    gen_beam: float = 2.0
    decoder_step_read: int = 256
    eager: bool = True
    max_len_a: float = 0.048
    max_len_b: float = -5.0
    len_scale: float = 0.7
    bos_bias: float = 0.0


class SpeechTransducerAgent:
    """Policy loop over one utterance; emits words incrementally."""

    def __init__(self, searcher: StreamingTransducerSearcher,
                 cfg: AgentConfig):
        self.searcher = searcher
        self.cfg = cfg
        self.reset()

    def reset(self):
        self.samples: List[float] = []
        self.state: SearchState = self.searcher.init_state()
        self.processed_frames = 0
        self.hypo_queue: deque = deque()
        self.finished = False
        # stateful engines (the fbank carry-over featurizer of the JAX
        # package) drop the previous utterance's state here
        reset_engine = getattr(self.searcher.engine, "reset", None)
        if reset_engine is not None:
            reset_engine()

    @property
    def init_frames(self):
        return self.cfg.main_context + self.cfg.right_context

    @property
    def step_frames(self):
        return self.cfg.main_context

    def _max_steps(self) -> int:
        prev = int((self.state.prefixes[0] != self.searcher.pad).sum()) - 1
        cap = (self.cfg.max_len_a * (len(self.samples) / 160.0)
               - self.cfg.max_len_b - prev)
        return max(int(cap), 1)

    def push(self, samples: np.ndarray, is_end: bool):
        """Feed a new chunk of float32 samples; runs inference when the
        policy fires (policy(), transducer_searcher.py:702-726)."""
        self.samples.extend(np.asarray(samples, np.float32).tolist())
        current_frames = len(self.samples) // self.cfg.frame_samples
        fire = False
        if self.processed_frames == 0:
            fire = current_frames >= self.init_frames
        else:
            step = self.step_frames * self.cfg.step_read_blocks
            fire = (current_frames - self.processed_frames) >= step
        if is_end or fire:
            self._infer(is_end)
            self.processed_frames = current_frames
        if is_end:
            self.finished = True

    def _infer(self, is_end: bool):
        audio = np.asarray(self.samples, np.float32)
        self.state, words = self.searcher.search(
            self.state, audio, is_end,
            intra_beam=self.cfg.intra_beam,
            inter_beam=self.cfg.inter_beam,
            gen_beam=self.cfg.gen_beam,
            read_step=self.cfg.decoder_step_read,
            max_steps=self._max_steps())
        self.hypo_queue.extend(words)

    def pop_word(self) -> Optional[str]:
        return self.hypo_queue.popleft() if self.hypo_queue else None


@dataclasses.dataclass
class InstanceResult:
    hypo: str
    reference: str
    delays_ms: List[float]
    elapsed_ms: List[float]
    source_len_ms: float


class SimulEvaluator:
    """Serve audio in segment-size chunks; record per-word delays."""

    def __init__(self, agent_factory, segment_size_ms: int = 25):
        self.agent_factory = agent_factory
        self.segment_size_ms = segment_size_ms

    def run_instance(self, wav: np.ndarray, reference: str) -> InstanceResult:
        agent = self.agent_factory()
        seg = self.segment_size_ms * SAMPLES_PER_MS
        n = len(wav)
        words, delays, elapsed = [], [], []
        t0 = time.perf_counter()
        offset = 0
        while offset < n or not agent.finished:
            chunk = wav[offset:offset + seg]
            offset = min(offset + seg, n)
            agent.push(chunk, is_end=(offset >= n))
            consumed_ms = offset / SAMPLES_PER_MS
            while True:
                w = agent.pop_word()
                if w is None:
                    break
                words.append(w)
                delays.append(consumed_ms)
                elapsed.append((time.perf_counter() - t0) * 1000.0
                               + consumed_ms)
            if offset >= n:
                break
        return InstanceResult(
            hypo=" ".join(words), reference=reference, delays_ms=delays,
            elapsed_ms=elapsed, source_len_ms=n / SAMPLES_PER_MS)

    def evaluate(self, wavs, references, metric: str = "bleu") -> dict:
        results = [self.run_instance(w, r) for w, r in zip(wavs, references)]
        return summarize(results, metric)


def summarize(results: List[InstanceResult], metric: str = "bleu") -> dict:
    al, ap, dal, al_ca = [], [], [], []
    for r in results:
        if r.delays_ms:
            ref_len = max(len(r.reference.split()), 1)
            al.append(average_lagging(r.delays_ms, r.source_len_ms, ref_len))
            ap.append(average_proportion(r.delays_ms, r.source_len_ms))
            dal.append(differentiable_average_lagging(
                r.delays_ms, r.source_len_ms, ref_len))
            al_ca.append(average_lagging(r.elapsed_ms, r.source_len_ms,
                                         ref_len))
    out = {
        "AL": float(np.mean(al)) if al else 0.0,
        "AP": float(np.mean(ap)) if ap else 0.0,
        "DAL": float(np.mean(dal)) if dal else 0.0,
        "AL_CA": float(np.mean(al_ca)) if al_ca else 0.0,
        "num_instances": len(results),
    }
    hyps = [r.hypo for r in results]
    refs = [r.reference for r in results]
    if metric == "bleu":
        from wav2vec_s_tpu_torch.eval.bleu import corpus_bleu
        out["BLEU"] = corpus_bleu(hyps, refs)
    else:
        from wav2vec_s_tpu_torch.eval.wer import corpus_wer
        out["WER"] = corpus_wer(hyps, refs)
    return out
