"""SimulEval-compatible evaluation server (tornado) + scorer.

A copy of ``wav2vec_s_tpu/stream/server.py`` (host code, no model): protocol
twin of the vendored SimulEval harness
(simuleval/simuleval/online/server.py:21-98, scorer/instance.py,
scorer/scorer.py): REST endpoints

- ``POST /``            reset the eval session
- ``GET  /``            corpus info ``{"num_sentences": N, "data_type": ...}``
- ``GET  /src?instance_id=i&segment_size=ms``  next source segment (int16
  sample list; ``"</s>"`` when exhausted) — delay timestamps are recorded
  server-side exactly like AudioInstance.send_src (instance.py:228-269)
- ``PUT  /hypo?instance_id=i``  whitespace-separated new words ("</s>" ends)
- ``GET  /result[?instance_id=i]``  per-instance summary or corpus scores

Scores: corpus BLEU (or WER for ASR) + AL/AP/DAL and computation-aware
variants, via ``stream.latency``.  ``tornado`` is imported by the functions
that serve, so the scorer runs without it.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import List, Optional

import numpy as np

from wav2vec_s_tpu_torch.data.audio import read_audio
from wav2vec_s_tpu_torch.eval.bleu import corpus_bleu
from wav2vec_s_tpu_torch.eval.wer import corpus_wer
from wav2vec_s_tpu_torch.stream.latency import (
    average_lagging, average_proportion, differentiable_average_lagging)

DEFAULT_EOS = "</s>"


def eval_all_latency(delays, src_len, ref_len):
    return {
        "AL": average_lagging(delays, src_len, ref_len),
        "AP": average_proportion(delays, src_len),
        "DAL": differentiable_average_lagging(delays, src_len, ref_len),
    }


class AudioInstance:
    def __init__(self, instance_id: int, source, reference: str,
                 sample_rate: int = 16000):
        self.instance_id = instance_id
        self.source = source          # path or float32 array
        self.target = reference.strip().split()
        self.sample_rate = sample_rate
        self.samples: Optional[List[int]] = None
        self.step = 0
        self.start_time = None
        self.hypos: List[str] = []
        self.delays: List[float] = []
        self.elapsed: List[float] = []
        self.finished = False
        self.metrics = {}

    def _load(self):
        if self.samples is None:
            wav = (read_audio(self.source, self.sample_rate)
                   if isinstance(self.source, str) else np.asarray(self.source))
            self.samples = (np.clip(wav, -1, 1) * 32767).astype(
                np.int16).tolist()

    def send_src(self, segment_size: int = 10) -> dict:
        if self.step == 0:
            self.start_time = time.time()
            self._load()
        num = math.ceil(segment_size / 1000 * self.sample_rate)
        if self.step < len(self.samples):
            seg = self.samples[self.step:self.step + num]
            finished = self.step + num >= len(self.samples)
            self.step = min(self.step + num, len(self.samples))
            return {"segment_id": self._ms(self.step), "segment": seg,
                    "sample_rate": self.sample_rate, "dtype": "int16",
                    "finished": finished}
        return {"segment_id": self.source_length(), "segment": DEFAULT_EOS,
                "sample_rate": self.sample_rate, "dtype": "int16",
                "finished": True}

    def recv_hypo(self, list_hypo: List[str]):
        if self.finished:
            return
        if self.start_time is None:
            self.start_time = time.time()
        now = time.time()
        for h in list_hypo:
            self.hypos.append(h)
            self.delays.append(self._ms(self.step))
            self.elapsed.append(self._ms(self.step)
                                + (now - self.start_time) * 1000)
            if h == DEFAULT_EOS:
                self.finish()
                return

    def finish(self):
        if not self.finished:
            self.finished = True
            self.metrics["latency"] = eval_all_latency(
                self.delays, self.source_length(), len(self.target) + 1)
            self.metrics["latency_ca"] = eval_all_latency(
                self.elapsed, self.source_length(), len(self.target) + 1)

    def _ms(self, n_samples):
        return n_samples * 1000.0 / self.sample_rate

    def source_length(self):
        self._load()
        return self._ms(len(self.samples))

    def prediction(self, eos=False):
        return " ".join(h for h in self.hypos if eos or h != DEFAULT_EOS)

    def summarize(self):
        return {
            "index": self.instance_id,
            "prediction": self.prediction(),
            "delays": self.delays,
            "elapsed": self.elapsed,
            "prediction_length": len(self.hypos),
            "reference": " ".join(self.target),
            "source_length": self.source_length(),
            "reference_length": len(self.target),
            "metric": self.metrics,
        }


class Scorer:
    def __init__(self, sources, references, sample_rate: int = 16000,
                 quality_metric: str = "bleu"):
        self.sources = sources
        self.references = references
        self.sample_rate = sample_rate
        self.quality_metric = quality_metric
        self.reset()

    def reset(self):
        self.instances = {
            i: AudioInstance(i, s, r, self.sample_rate)
            for i, (s, r) in enumerate(zip(self.sources, self.references))}

    def get_info(self):
        return {"num_sentences": len(self.instances), "data_type": "speech"}

    def send_src(self, instance_id: int, segment_size: Optional[int]):
        return self.instances[instance_id].send_src(segment_size or 10)

    def recv_hyp(self, instance_id: int, list_of_tokens: List[str]):
        self.instances[instance_id].recv_hypo(list_of_tokens)

    def score(self):
        for ins in self.instances.values():
            ins.finish()
        hyps = [i.prediction() for i in self.instances.values()]
        refs = [" ".join(i.target) for i in self.instances.values()]
        lat = {k: float(np.mean([i.metrics["latency"][k]
                                 for i in self.instances.values()]))
               for k in ("AL", "AP", "DAL")}
        lat_ca = {f"{k}_CA": float(np.mean(
            [i.metrics["latency_ca"][k] for i in self.instances.values()]))
            for k in ("AL", "AP", "DAL")}
        quality = ({"BLEU": corpus_bleu(hyps, refs)}
                   if self.quality_metric == "bleu"
                   else {"WER": corpus_wer(hyps, refs)})
        return {**quality, **lat, **lat_ca}


def make_app(scorer: Scorer):
    from tornado import web

    class H(web.RequestHandler):
        def initialize(self, scorer):
            self.scorer = scorer

    class Session(H):
        def post(self):
            self.scorer.reset()

        def get(self):
            self.write(json.dumps(self.scorer.get_info()))

    class Result(H):
        def get(self):
            iid = self.get_argument("instance_id", None)
            if iid is not None:
                self.write(json.dumps(
                    self.scorer.instances[int(iid)].summarize()))
            else:
                self.write(json.dumps(self.scorer.score()))

    class Source(H):
        def get(self):
            iid = int(self.get_argument("instance_id"))
            seg = self.get_argument("segment_size", None)
            seg = int(seg) if seg else None
            self.write(json.dumps(self.scorer.send_src(iid, seg)))

    class Hypo(H):
        def put(self):
            iid = int(self.get_argument("instance_id"))
            toks = self.request.body.decode("utf-8").strip().split()
            self.scorer.recv_hyp(iid, toks)

    return web.Application([
        (r"/result", Result, dict(scorer=scorer)),
        (r"/src", Source, dict(scorer=scorer)),
        (r"/hypo", Hypo, dict(scorer=scorer)),
        (r"/", Session, dict(scorer=scorer)),
    ])


def start_server_thread(scorer: Scorer, port: int):
    """Run the tornado server in a daemon thread; returns (thread, loop)."""
    import asyncio
    from tornado import ioloop

    loop_holder = {}

    def run():
        asyncio.set_event_loop(asyncio.new_event_loop())
        app = make_app(scorer)
        app.listen(port, max_buffer_size=1024 ** 3)
        loop_holder["loop"] = ioloop.IOLoop.current()
        loop_holder["loop"].start()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.3)
    return t, loop_holder
