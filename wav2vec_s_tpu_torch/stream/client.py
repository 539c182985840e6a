"""SimulEval client + agent policy loop over HTTP.

A copy of ``wav2vec_s_tpu/stream/client.py``, except that ``requests`` is
imported by the methods that send, so the module imports without it.  Twin of simuleval/simuleval/online/client.py:14-79 and the decode loop in
cli.py:81-150: pull source segments from the server, drive the agent's
READ/WRITE policy, push hypotheses back, fetch corpus scores.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from wav2vec_s_tpu_torch.stream.server import DEFAULT_EOS


def _requests():
    import requests

    return requests


class Client:
    def __init__(self, hostname: str = "localhost", port: int = 12321,
                 timeout: int = 100):
        self.base_url = f"http://{hostname}:{port}"
        self.timeout = timeout

    def reset_scorer(self):
        _requests().post(self.base_url, timeout=self.timeout)

    def corpus_info(self):
        return _requests().get(self.base_url, timeout=self.timeout).json()

    def get_source(self, instance_id: int, segment_size: int) -> dict:
        return _requests().get(
            f"{self.base_url}/src",
            params={"instance_id": instance_id,
                    "segment_size": segment_size},
            timeout=self.timeout).json()

    def send_hypo(self, instance_id: int, hypo: str):
        _requests().put(f"{self.base_url}/hypo",
                     params={"instance_id": instance_id},
                     data=hypo.encode("utf-8"), timeout=self.timeout)

    def get_scores(self, instance_id: Optional[int] = None):
        params = {}
        if instance_id is not None:
            params["instance_id"] = instance_id
        return _requests().get(f"{self.base_url}/result", params=params,
                            timeout=self.timeout).json()


def decode_instance(client: Client, agent, instance_id: int,
                    segment_size: int = 25):
    """READ/WRITE loop for one utterance (cli.py:81-123)."""
    agent.reset()
    while True:
        seg = client.get_source(instance_id, segment_size)
        finished = bool(seg["finished"])
        if seg["segment"] == DEFAULT_EOS:
            samples = np.zeros(0, np.float32)
        else:
            samples = np.asarray(seg["segment"], np.float32) / 32768.0
        agent.push(samples, is_end=finished)
        out = []
        while True:
            w = agent.pop_word()
            if w is None:
                break
            out.append(w)
        if out:
            client.send_hypo(instance_id, " ".join(out))
        if finished:
            client.send_hypo(instance_id, DEFAULT_EOS)
            break


def evaluate_corpus(client: Client, agent_factory, segment_size: int = 25):
    client.reset_scorer()
    n = client.corpus_info()["num_sentences"]
    for i in range(n):
        decode_instance(client, agent_factory(), i, segment_size)
    return client.get_scores()


def evaluate_corpus_pool(client_factory, agent_factory, n_clients: int = 2,
                         segment_size: int = 25):
    """N-client orchestration of the HTTP eval path.

    Twin of the reference's client pool (simuleval/cli.py:126-150), which
    forks ``num_processes`` worker processes and shards instance ids
    across them; the server accumulates all delays/hypotheses, so the
    final ``/result`` fetch merges everything.  Worker THREADS instead of
    processes here: the per-instance work is HTTP I/O plus device calls
    (both release the GIL), and one model on one card serves every
    worker.  Each worker
    gets its own ``Client`` (connection) and a fresh agent per utterance,
    exactly like the reference's ``decode``.
    """
    import threading

    boot = client_factory()
    boot.reset_scorer()
    n = boot.corpus_info()["num_sentences"]
    errs = []

    def worker(wid: int):
        try:
            client = client_factory()
            for i in range(wid, n, n_clients):
                decode_instance(client, agent_factory(), i, segment_size)
        except Exception as e:          # surface worker failures
            errs.append((wid, e))

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise RuntimeError(f"client workers failed: {errs}")
    return boot.get_scores()
