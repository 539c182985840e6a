"""The SimulEval server and client copies of the torch port.

- A real tornado server on a free localhost port, driven by the port's
  ``Client`` and the port's ``SpeechTransducerAgent``: the hypotheses and
  per-word delays the server records equal the in-process
  ``SimulEvaluator``'s on the same int16-quantized audio;
- the port's ``Scorer`` scores the recorded hypotheses as the JAX
  package's ``Scorer`` does (equal, but for the wall-clock _CA latencies).

Skips with the package's name where ``tornado`` or ``requests`` is absent:
they serve the HTTP path only.
"""

import socket

import numpy as np
import pytest

pytest.importorskip("tornado")
pytest.importorskip("requests")

from tests.test_torch_port_agent import _evaluators  # noqa: E402
from wav2vec_s_tpu.stream import server as jax_server  # noqa: E402
from wav2vec_s_tpu_torch.stream import client, server  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(11)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.3
            for n in (1500, 1100)]
    refs = ["w5 w22 w5", "w22 w3"]
    scorer = server.Scorer(wavs, refs, quality_metric="bleu")
    port = _free_port()
    _, holder = server.start_server_thread(scorer, port)
    yield scorer, wavs, refs, port
    loop = holder["loop"]
    loop.add_callback(loop.stop)


def test_http_round_trip_matches_in_process_evaluator(served):
    scorer, wavs, refs, port = served
    _, evaluator = _evaluators(step_read_blocks=1, segment_ms=10)
    scores = client.evaluate_corpus(client.Client(port=port),
                                    evaluator.agent_factory, segment_size=10)
    for k in ("BLEU", "AL", "AP", "DAL", "AL_CA"):
        assert np.isfinite(scores[k]), scores
    emitted = 0
    for i, (wav, ref) in enumerate(zip(wavs, refs)):
        # what the server sent: int16 samples, scaled back by the client
        sent = (np.clip(wav, -1, 1) * 32767).astype(np.int16) / 32768.0
        want = evaluator.run_instance(sent.astype(np.float32), ref)
        got = client.Client(port=port).get_scores(i)
        assert got["prediction"] == want.hypo
        # the client's final "</s>" is recorded at the end of the source
        assert got["delays"][:-1] == want.delays_ms
        assert got["delays"][-1] == want.source_len_ms
        emitted += len(want.delays_ms)
    assert emitted > 0, "the agent emitted nothing"


def test_scorer_copy_scores_like_jax(served):
    scorer, wavs, refs, _ = served
    mine = server.Scorer(wavs, refs)
    theirs = jax_server.Scorer(wavs, refs)
    for s in (mine, theirs):
        for i in range(len(wavs)):
            s.send_src(i, 100)
            s.recv_hyp(i, ["w22", "w5"])
            while not s.send_src(i, 100)["finished"]:
                pass
            s.recv_hyp(i, ["w3", server.DEFAULT_EOS])
    got, want = mine.score(), theirs.score()
    assert {k: v for k, v in got.items() if not k.endswith("_CA")} == {
        k: v for k, v in want.items() if not k.endswith("_CA")}
    assert mine.instances[0].summarize()["delays"] == \
        theirs.instances[0].summarize()["delays"]
