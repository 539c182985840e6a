"""Corpus preparation, the debug hooks and the meters of the port
(``wav2vec_s_tpu_torch/data/{prep,preprocess}.py``, ``utils/debug.py``,
``run.debug_nan`` / ``run.profile_dir`` of ``train/cli.py``).

- ``NanDetector`` and ``Watchdog`` as ``tests/test_debug_utils.py`` tests
  the JAX ones; ``profile_trace`` writes a trace that holds a ``span``.
- ``train.cli.main --device cpu`` (the tiny corpus of
  ``tests/test_torch_port_cli.py``): ``run.debug_nan`` trains as without
  it, and a NaN planted in one parameter of the checkpoint it resumes
  from raises ``FloatingPointError`` naming that parameter;
  ``run.profile_dir`` writes a Chrome trace of updates [10, 20), and one
  that ends inside the window still writes it.
- ``prep librispeech``, ``prep s2t`` (with its data config), ``prep
  mustc`` and ``preprocess`` (from text files and from S2T manifests)
  write files byte-equal to the JAX modules' on the same synthetic trees
  (``.wav``: ``.flac`` metadata needs ``soundfile``, which is optional).
"""

import json
import signal
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_prep import _fake_librispeech, _write_wav
from tests.test_torch_port_cli import _overrides, corpus  # noqa: F401
from wav2vec_s_tpu.data import prep as jax_prep
from wav2vec_s_tpu.data import preprocess as jax_preprocess
from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
from wav2vec_s_tpu_torch.data import prep, preprocess
from wav2vec_s_tpu_torch.train import cli
from wav2vec_s_tpu_torch.utils.debug import (
    NanDetector, Watchdog, profile_trace, span)

torch.set_num_threads(1)


def test_nan_detector_localizes():
    tensors = {"encoder.w": torch.ones(3),
               "decoder.b": torch.tensor([1.0, float("nan")]),
               "decoder.steps": torch.tensor([1, 2])}
    bad = NanDetector.check(tensors, "params")
    assert bad == ["params['decoder.b']: 1/2 non-finite"]
    with pytest.raises(FloatingPointError, match="decoder.b"):
        NanDetector.assert_finite(tensors)
    NanDetector.assert_finite({"x": torch.ones(2)})
    assert NanDetector.check({"x": torch.tensor([float("inf")] * 3)},
                             "logs") == ["logs['x']: 3/3 non-finite"]


def test_watchdog_fires_and_pings():
    got = []
    old = signal.signal(signal.SIGUSR1, lambda s, f: got.append(s))
    try:
        wd = Watchdog(timeout=0.2)
        wd.start()
        for _ in range(3):           # heartbeats keep it quiet
            time.sleep(0.05)
            wd.ping()
        assert not wd.fired
        time.sleep(0.5)              # starve it
        assert wd.fired and got
        wd.stop()
    finally:
        signal.signal(signal.SIGUSR1, old)


def test_profile_trace_and_annotate(tmp_path):
    with profile_trace(str(tmp_path / "p")):
        with span("matmul_range"):
            torch.randn(8, 8) @ torch.randn(8, 8)
    trace = json.loads((tmp_path / "p" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "w2vs/matmul_range" in names and "aten::mm" in names


def test_cli_debug_nan_trains_as_without_it(corpus):  # noqa: F811
    plain = _overrides(corpus, "plain", **{"run.max_update": 3})
    flagged = _overrides(corpus, "nan", **{"run.max_update": 3,
                                           "run.debug_nan": "true"})
    for argv in (plain, flagged):
        cli.main(argv)
    a = CheckpointManager(corpus[0] / "plain").restore()[0]["model"]
    b = CheckpointManager(corpus[0] / "nan").restore()[0]["model"]
    for k, v in a.items():
        torch.testing.assert_close(b[k], v, rtol=0, atol=0, msg=k)


def test_cli_debug_nan_names_the_planted_parameter(corpus):  # noqa: F811
    cli.main(_overrides(corpus, "plant", **{"run.max_update": 2,
                                            "run.save_interval_updates": 0}))
    path = corpus[0] / "plant" / "step_000000002" / "state.pt"
    payload = torch.load(path, weights_only=False)
    name = "decoder.jointer.layers.0.fc1.weight"
    payload["model"][name][0, :3] = float("nan")
    torch.save(payload, path)
    argv = _overrides(corpus, "plant", **{"run.max_update": 3,
                                          "run.save_interval_updates": 0,
                                          "run.debug_nan": "true"})
    with pytest.raises(FloatingPointError) as err:
        cli.main(argv)
    msg = str(err.value)
    assert f"params['{name}']: 3/" in msg and "logs['loss_total']" in msg
    # every other parameter is finite: it names that one alone
    assert msg.count("params[") == 1
    # the raise stopped the watchdog: a caller that catches the error is
    # not signalled 10 minutes later
    assert not [t for t in threading.enumerate()
                if t.name == "Watchdog" and t.is_alive()]


@pytest.mark.parametrize("updates", [12, 21])
def test_cli_profile_dir_traces_updates_10_to_20(corpus, updates):  # noqa: F811,E501
    out = corpus[0] / f"prof{updates}"
    cli.main(_overrides(corpus, f"p{updates}", **{
        "run.max_update": updates, "run.save_interval_updates": 0,
        "run.validate_interval_updates": 0, "run.profile_dir": str(out)}))
    trace = json.loads((out / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


# -- corpus preparation ------------------------------------------------


def _files(d):
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _paths_of(d, data: bytes, root) -> bytes:
    """The file's bytes with the tree's root written as ``<root>``: the
    two CLIs wrote into trees of different roots."""
    return data.replace(str(root).encode(), b"<root>")


def _both(tmp_path, argv_of):
    """Run the JAX and the port's CLI (``argv_of(out_dir)``) into two
    output trees and return their files, roots blanked."""
    got = []
    for name, main in (("jax", jax_prep.main), ("port", prep.main)):
        out = tmp_path / name
        assert main(argv_of(out)) == 0
        got.append({k: _paths_of(out, v, out)
                    for k, v in _files(out).items()})
    return got


def test_prep_librispeech_and_s2t_equal_jax(tmp_path):
    root = tmp_path / "LibriSpeech"
    _fake_librispeech(root)
    split = "train-clean-100"

    def argv_of(out):
        return ["librispeech", str(root), "--split", split, "--out",
                str(out), "--ext", "wav"]
    want, have = _both(tmp_path / "ls", argv_of)
    assert have == want and len(want) == 3

    man = tmp_path / "ls" / "jax" / f"{split}.tsv"
    wrd = tmp_path / "ls" / "jax" / f"{split}.wrd"

    def s2t_argv(out):
        out.mkdir(parents=True, exist_ok=True)
        return ["s2t", "--manifest", str(man), "--wrd", str(wrd), "--out",
                str(out / "train_asr.tsv"), "--config-out",
                str(out / "config_asr.yaml"), "--spm-model", "spm.model"]
    want, have = _both(tmp_path / "s2t", s2t_argv)
    assert have == want and set(want) == {"train_asr.tsv",
                                          "config_asr.yaml"}


def test_prep_mustc_equals_jax(tmp_path):
    yaml = pytest.importorskip("yaml")
    rate = 16000
    long_wav = np.random.default_rng(1).uniform(-0.5, 0.5, 3 * rate)
    segs = [{"wav": "ted_1.wav", "offset": "0.25", "duration": "1.0",
             "speaker_id": "spk_1"},
            {"wav": "ted_1.wav", "offset": "1.5", "duration": "0.5",
             "speaker_id": "spk_1"}]
    root = tmp_path / "mustc"
    for split in ("dev", "tst-COMMON"):
        d = root / "en-de" / "data" / split
        (d / "txt").mkdir(parents=True)
        (d / "wav").mkdir()
        _write_wav(d / "wav" / "ted_1.wav", long_wav.astype(np.float32),
                   rate)
        with open(d / "txt" / f"{split}.yaml", "w") as f:
            yaml.safe_dump(segs, f)
        (d / "txt" / f"{split}.en").write_text("hello there\nsecond line\n")
        (d / "txt" / f"{split}.de").write_text("hallo du\nzweite zeile\n")

    def argv_of(out):
        return ["mustc", str(root), "--lang", "de", "--splits", "dev",
                "tst-COMMON", "--out", str(out)]
    want, have = _both(tmp_path / "mc", argv_of)
    assert have == want and len(want) == 2


@pytest.mark.parametrize("args", [
    ["--tokenizer", "word"],
    ["--tokenizer", "char", "--threshold", "2"],
    ["--tokenizer", "word", "--nwords", "3", "--padding-factor", "8"],
])
def test_preprocess_dictionary_equals_jax(tmp_path, args):
    text = tmp_path / "train.txt"
    text.write_text("the cat sat\non the mat\nthe end\n")
    tsv = tmp_path / "train_st.tsv"
    tsv.write_text("id\taudio\tn_frames\ttgt_text\tsrc_text\n"
                   "a\tx.wav\t10\tdie katze\tthe cat\n"
                   "b\ty.wav\t10\tdie matte die\tthe mat\n")
    for extra in (["--inputs", str(text)],
                  ["--manifests", str(tsv), "--column", "tgt_text"],
                  ["--inputs", str(text), "--manifests", str(tsv),
                   "--column", "src_text"]):
        jax_preprocess.main(extra + args + ["--out",
                                            str(tmp_path / "jax.txt")])
        preprocess.main(extra + args + ["--out", str(tmp_path / "port.txt")])
        want = (tmp_path / "jax.txt").read_bytes()
        assert (tmp_path / "port.txt").read_bytes() == want and want
