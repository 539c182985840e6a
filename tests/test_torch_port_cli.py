"""The training entry point of the torch port, its data pipeline and its
checkpoints.

- the host-side data modules the port copies (``data/{audio,manifests,
  batching,tokenizer,dataset}.py``) give exactly the JAX package's values on
  the same inputs: buckets, batches, iterator order and state, collated
  arrays (exact);
- ``train/config.py`` loads the same yaml and overrides to the same values
  as the JAX package's;
- ``CheckpointManager`` keeps the last K and the best, commits with
  ``meta.json`` last, restores model, Adam moments, counts and iterator
  state, synchronously and on its writer thread;
- ``python -m wav2vec_s_tpu_torch.train.cli --device cpu`` on synthetic
  wavs, a tsv and a dict built as tests/test_cli_e2e.py builds them: 4 tiny
  updates (flash attention, sampled decision steps), finite progress
  records with the JAX CLI's keys, a validation record, checkpoints; a
  second call resumes from the saved step at the saved iterator position
  and ends with the same parameters as one uninterrupted run (bit-equal:
  the same arithmetic in the same order); an out-of-memory batch is
  skipped and counted; each rematerialization switch and the flat
  optimizer train as the plain run does.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from wav2vec_s_tpu.data import audio as jax_audio
from wav2vec_s_tpu.data import batching as jax_batching
from wav2vec_s_tpu.data import dataset as jax_dataset
from wav2vec_s_tpu.data import manifests as jax_manifests
from wav2vec_s_tpu.data import tokenizer as jax_tokenizer
from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
from wav2vec_s_tpu.models.wav2vec2 import (
    Wav2Vec2Config as JaxWav2Vec2Config)
from wav2vec_s_tpu.train import config as jax_config
from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
from wav2vec_s_tpu_torch.checkpoint.warm_start import (
    apply_pretrained_encoder, load_pretrained_encoder)
from wav2vec_s_tpu_torch.data import audio, batching, dataset, manifests
from wav2vec_s_tpu_torch.data import tokenizer
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.data.prefetch import prefetch_batches
from wav2vec_s_tpu_torch.models import Wav2Vec2Config, Wav2Vec2Model
from wav2vec_s_tpu_torch.models.modules import random_init_
from wav2vec_s_tpu_torch.train import cli, config
from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
from wav2vec_s_tpu_torch.train.step import TrainState
from wav2vec_s_tpu_torch.utils.metrics import JsonProgress, TimeMeter

torch.set_num_threads(1)

TEXTS = ["guten tag welt", "hallo du", "wie geht es dir", "sehr gut",
         "guten tag", "welt"]


@pytest.fixture
def corpus(tmp_path):
    """Synthetic wavs, an S2T tsv and a dict (tests/test_cli_e2e.py's
    recipe at a shorter clip length): 6 clips of 1920 + 320 i samples."""
    rng = np.random.default_rng(0)
    wavs = tmp_path / "audio"
    wavs.mkdir()
    lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
    for i, text in enumerate(TEXTS):
        ns = 1920 + 320 * i
        wav = rng.standard_normal(ns).astype(np.float32) * 0.1
        audio.write_wav(wavs / f"utt{i}.wav", wav)
        lines.append(f"utt_{i}\t{wavs}/utt{i}.wav\t{ns}\t{text}\thello world")
    tsv = tmp_path / "train_st.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    words = sorted({w for t in TEXTS for w in t.split()} | {"hello", "world"})
    vocab = tmp_path / "dict.txt"
    vocab.write_text("\n".join(f"{w} 1" for w in words) + "\n")
    return tmp_path, tsv, vocab


# ---- data modules against the JAX package's -------------------------------

@pytest.mark.parametrize("args", [(250_000, 1024, 1.3, 64),
                                  (12800, 1024, 1.3, 640), (100, 7, 1.5, 3)])
def test_length_buckets_match_jax(args):
    assert batching.length_buckets(*args) == jax_batching.length_buckets(*args)
    b = batching.length_buckets(*args)
    for size in (1, b[0], b[0] + 1, b[-1], b[-1] + 5):
        assert batching.bucket_for(size, b) == jax_batching.bucket_for(size, b)


@pytest.mark.parametrize("kw", [
    dict(max_tokens=9000), dict(max_tokens=20000, max_sentences=3),
    dict(max_tokens=9000, required_batch_size_multiple=2),
    dict(max_tokens=30000, buckets=(2048, 4096, 8192))])
def test_batch_by_size_matches_jax(kw):
    sizes = np.random.default_rng(1).integers(800, 8000, 40)
    got = batching.batch_by_size(sizes, **kw)
    want = jax_batching.batch_by_size(sizes, **kw)
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_epoch_iterator_order_and_state_match_jax():
    batches = [np.arange(i, i + 2) for i in range(0, 14, 2)]
    mine = batching.EpochBatchIterator(batches, seed=3)
    theirs = jax_batching.EpochBatchIterator(batches, seed=3)
    orders = []
    for _ in range(2):                                   # two epochs
        a, b = list(mine.next_epoch_itr()), list(theirs.next_epoch_itr())
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
        assert mine.state_dict() == theirs.state_dict()
        orders.append(np.stack(a)[:, 0].tolist())
    assert orders[0] != orders[1] and sorted(orders[0]) == sorted(orders[1])
    assert mine.state_dict() == {"epoch": 2, "batch_offset": 0}
    # resume mid-epoch: the rest of the epoch, in the same order
    it = mine.next_epoch_itr()
    first = [next(it) for _ in range(3)]
    resumed = batching.EpochBatchIterator(batches, seed=3)
    resumed.load_state_dict(mine.state_dict())
    rest, rest_resumed = list(it), list(resumed.next_epoch_itr())
    assert len(first) + len(rest) == len(batches)
    for a, b in zip(rest, rest_resumed):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(batching.pad_to(np.arange(3), 5, 9),
                                  jax_batching.pad_to(np.arange(3), 5, 9))


def test_audio_and_manifest_readers_match_jax(corpus):
    tmp, tsv, _ = corpus
    got = manifests.read_s2t_manifest(tsv)
    want = jax_manifests.read_s2t_manifest(tsv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert len(got) == len(TEXTS)
    for path in got.audio_paths:
        a, b = audio.read_audio(path), jax_audio.read_audio(path)
        np.testing.assert_array_equal(a, b)
    seg = f"{got.audio_paths[2]}:100:500"               # a sample segment
    np.testing.assert_array_equal(audio.read_audio(seg),
                                  jax_audio.read_audio(seg))
    np.testing.assert_array_equal(audio.instance_normalize(a),
                                  jax_audio.instance_normalize(a))
    with pytest.raises(ValueError, match="sample rate"):
        audio.read_audio(got.audio_paths[0], expected_rate=8000)
    rooted = manifests.read_s2t_manifest(tsv, audio_root=str(tmp))
    assert rooted.audio_paths == jax_manifests.read_s2t_manifest(
        tsv, audio_root=str(tmp)).audio_paths


@pytest.mark.parametrize("kind", ["word", "char"])
def test_tokenizers_match_jax(kind):
    mine, theirs = (m.build_tokenizer(kind) for m in (tokenizer,
                                                      jax_tokenizer))
    for text in TEXTS + ["  two  spaces ", ""]:
        pieces = mine.encode(text)
        assert pieces == theirs.encode(text)
        assert mine.decode(pieces) == theirs.decode(pieces)
    with pytest.raises(ValueError):
        tokenizer.build_tokenizer("bpe")


@pytest.mark.parametrize("task_type,normalize", [("st", False),
                                                 ("asr", True)])
def test_caat_batcher_collates_like_jax(corpus, task_type, normalize):
    _, tsv, vocab = corpus
    buckets = batching.length_buckets(12800, multiple=640)
    mine = dataset.CaatBatcher(
        manifests.read_s2t_manifest(tsv), Dictionary.load(str(vocab)),
        tokenizer.build_tokenizer("word"), buckets, task_type=task_type,
        normalize=normalize)
    theirs = jax_dataset.CaatBatcher(
        jax_manifests.read_s2t_manifest(tsv), JaxDictionary.load(str(vocab)),
        jax_tokenizer.build_tokenizer("word"), buckets, task_type=task_type,
        normalize=normalize)
    for idx, hint in ((np.array([0, 3]), None), (np.array([5, 1, 2]), 3600)):
        got, want = mine.collate(idx, hint), theirs.collate(idx, hint)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[
                k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    on_device = dataset.to_device(got, torch.device("cpu"))
    assert on_device["targets"].dtype == torch.int64
    assert on_device["padding_mask"].dtype == torch.bool
    np.testing.assert_array_equal(on_device["source"].numpy(), got["source"])


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_yields_in_order_and_reraises(depth):
    out = list(prefetch_batches(range(5), lambda i: i * i, depth))
    assert out == [(i, i * i) for i in range(5)]

    def boom(i):
        if i == 2:
            raise KeyError("collate failed")
        return i

    with pytest.raises(KeyError):
        list(prefetch_batches(range(5), boom, depth))


# ---- configuration ---------------------------------------------------------

def test_config_loads_like_jax(tmp_path):
    pytest.importorskip("yaml")
    path = tmp_path / "cfg.yaml"
    path.write_text("""
run: {task: caat, max_update: 7, keep_best: 2}
data: {max_tokens: 40000, tokenizer: char}
optim: {lr: 0.001, lr_scheduler: inverse_sqrt, adam_betas: [0.9, 0.99]}
context: {main_context: 4, right_context: 2, buckets: [[8, 4], [16, 8]]}
model: {encoder_layers: 2, conv_feature_layers: [[32, 10, 5], [32, 3, 2]]}
caat: {decision_steps: [4, 8]}
""")
    ov = ["run.patience=3", "optim.clip_norm=2.0", "data.normalize=true",
          "model.attention_impl=flash", "caat.decoder_layers=2",
          "optim.phase_ratio=(0.2,0.3,0.5)"]
    def fields(cfg):
        # the JAX OptimConfig carries a skip_nonfinite field that nothing
        # reads; the port's has none (make_train_step decides the skip)
        d = dataclasses.asdict(cfg)
        d["optim"].pop("skip_nonfinite", None)
        return d

    got = config.load_config(str(path), ov)
    want = jax_config.load_config(str(path), ov)
    assert fields(got) == fields(want)
    assert got.run.patience == 3 and got.model["attention_impl"] == "flash"
    assert fields(config.TrainConfig()) == fields(jax_config.TrainConfig())
    with pytest.raises(ValueError, match="unknown config key"):
        path.write_text("run: {no_such_key: 1}\n")
        config.load_config(str(path))
    with pytest.raises(ValueError, match="key=value"):
        config.apply_overrides(config.TrainConfig(), ["run.task"])


# ---- progress records ------------------------------------------------------

def test_json_progress_and_time_meter():
    import io

    stream = io.StringIO()
    JsonProgress(stream).log({"loss": 1.234567, "n": 3}, 5)
    JsonProgress(stream).log({"valid_loss": 2.0}, 5, tag="valid")
    recs = [json.loads(line) for line in stream.getvalue().splitlines()]
    assert recs == [{"tag": "train", "step": 5, "loss": 1.2346, "n": 3},
                    {"tag": "valid", "step": 5, "valid_loss": 2.0}]
    meter = TimeMeter()
    meter.update(3)
    assert meter.avg > 0 and meter.n == 3


# ---- checkpoints -----------------------------------------------------------

def _tiny_state(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    opt = build_optimizer(OptimConfig(lr=0.1, warmup_updates=0))
    state = TrainState.create(model, opt)
    params = list(model.parameters())
    for _ in range(2):
        grads = [torch.randn_like(p) for p in params]
        opt.update(params, grads, state.opt_state, torch.tensor(1.0))
    state.step = 2
    return state


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_roundtrip_and_policies(tmp_path, async_save):
    mgr = CheckpointManager(tmp_path / "ck", keep_last=2, keep_best=1,
                            async_save=async_save)
    assert mgr.latest_step() is None and mgr.restore() == (None, None)
    state = _tiny_state()
    metrics = {1: 5.0, 2: 1.0, 3: 4.0, 4: 3.0}
    for step, metric in metrics.items():
        mgr.save(step, state, extra={"iterator": {"epoch": step,
                                                  "batch_offset": 1}},
                 metric=metric)
    mgr.wait()
    # the last two, and the best (lowest metric) of the rest
    assert mgr.all_steps() == [2, 3, 4] and mgr.latest_step() == 4
    assert mgr.best_step() == 2
    assert not list((tmp_path / "ck").rglob("*.tmp"))

    fresh = _tiny_state(seed=1)
    restored, meta = mgr.restore(template=fresh)
    assert restored is fresh and meta["step"] == 4
    assert meta["extra"]["iterator"] == {"epoch": 4, "batch_offset": 1}
    assert fresh.step == 2 and fresh.opt_state.count == 2
    for a, b in zip(fresh.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    for name in ("mu", "nu"):
        for a, b in zip(getattr(fresh.opt_state, name),
                        getattr(state.opt_state, name)):
            assert torch.equal(a, b)
    payload, _ = mgr.restore(step=2)                     # no template
    assert sorted(payload) == ["model", "opt", "step"]

    # a step directory without meta.json is an interrupted save: ignored
    (tmp_path / "ck" / "step_000000009").mkdir()
    assert mgr.latest_step() == 4
    wrong = TrainState.create(torch.nn.Linear(3, 4), build_optimizer(
        OptimConfig()))
    with pytest.raises((RuntimeError, ValueError)):
        mgr.restore(template=wrong)


# ---- the CLI ---------------------------------------------------------------

#: the keys of the JAX CLI's CAAT progress records (train/cli.py:668-681 over
#: the logs of train/step.py and caat_loss)
TRAIN_KEYS = {"tag", "step", "loss", "loss_prob", "loss_delay", "nll_loss",
              "loss_total", "sample_size", "grad_norm", "skipped",
              "decision_step", "loss_per_sample", "ups"}


def _overrides(corpus, save_dir, **extra):
    tmp, tsv, vocab = corpus
    ov = {
        "run.task": "caat", "run.save_dir": f"{tmp}/{save_dir}",
        "run.max_update": 4, "run.log_interval": 1,
        "run.save_interval_updates": 2, "run.validate_interval_updates": 4,
        "data.train_manifest": tsv, "data.valid_manifest": tsv,
        "data.vocab": vocab, "data.max_tokens": 7100,
        "data.max_sample_size": 3840,
        "optim.lr": 0.001, "optim.lr_scheduler": "inverse_sqrt",
        "optim.warmup_updates": 2, "optim.clip_norm": 2.0,
        "context.main_context": 4, "context.right_context": 2,
        "model.conv_feature_layers": "((32,10,5),(32,3,2),(32,2,2))",
        "model.encoder_layers": 2, "model.encoder_embed_dim": 32,
        "model.encoder_ffn_embed_dim": 64,
        "model.encoder_attention_heads": 4, "model.attention_impl": "flash",
        "model.dropout": 0.0, "model.attention_dropout": 0.0,
        "model.encoder_layerdrop": 0.0, "model.feature_grad_mult": 1.0,
        "caat.decoder_layers": 2, "caat.decoder_embed_dim": 24,
        "caat.decoder_ffn_embed_dim": 48, "caat.decoder_attention_heads": 4,
        "caat.jointer_layers": 2, "caat.jointer_embed_dim": 24,
        "caat.jointer_ffn_embed_dim": 48, "caat.jointer_attention_heads": 4,
        "caat.transducer_downsample": 8, "caat.step_mode": "random",
        "caat.decision_steps": "(4,8)", "caat.tokens_per_step": 500,
        "caat.dropout": 0.0, "caat.attention_dropout": 0.0,
        "caat.activation_dropout": 0.0, "caat.rand_pos_decoder": 0,
    }
    ov.update(extra)
    return ["--device", "cpu"] + [f"{k}={v}" for k, v in ov.items()]


def _records(capsys):
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def _final_params(corpus, save_dir):
    payload, meta = CheckpointManager(corpus[0] / save_dir,
                                      keep_last=0).restore()
    return payload, meta


def test_cli_trains_validates_saves(corpus, capsys):
    cli.main(_overrides(corpus, "ck", **{"model.dropout": 0.1,
                                         "model.attention_dropout": 0.1,
                                         "caat.dropout": 0.1}))
    recs = _records(capsys)
    train = [r for r in recs if r["tag"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    for r in train:
        assert set(r) == TRAIN_KEYS
        assert all(np.isfinite(v) for k, v in r.items() if k != "tag")
        assert r["skipped"] == 0.0 and r["decision_step"] in (4.0, 8.0)
    valid = [r for r in recs if r["tag"] == "valid"]
    assert len(valid) == 1 and valid[0]["step"] == 4
    assert np.isfinite(valid[0]["valid_loss"])
    mgr = CheckpointManager(corpus[0] / "ck", keep_last=0)
    assert mgr.all_steps() == [2, 4]
    payload, meta = mgr.restore()
    assert payload["step"] == 4 and payload["opt"]["count"] == 4
    # 6 clips in 3 batches of 2: update 4 is batch 1 of epoch 1
    assert meta["extra"]["iterator"] == {"epoch": 1, "batch_offset": 1}


@pytest.mark.parametrize("prefetch", [0, 2])
def test_cli_resume_equals_an_uninterrupted_run(corpus, capsys, prefetch):
    extra = {"run.prefetch": prefetch, "run.update_freq": 1}
    cli.main(_overrides(corpus, "whole", **extra))
    whole = _records(capsys)
    cli.main(_overrides(corpus, "parts", **dict(extra,
                                                **{"run.max_update": 2})))
    first = _records(capsys)
    payload, meta = _final_params(corpus, "parts")
    assert payload["step"] == 2
    assert meta["extra"]["iterator"] == {"epoch": 0, "batch_offset": 2}
    cli.main(_overrides(corpus, "parts", **extra))        # resumes at 2
    second = _records(capsys)
    assert [r["step"] for r in second if r["tag"] == "train"] == [3, 4]
    for a, b in zip([r for r in whole if r["tag"] == "train"],
                    [r for r in first + second if r["tag"] == "train"]):
        assert {k: v for k, v in a.items() if k != "ups"} == {
            k: v for k, v in b.items() if k != "ups"}
    want, _ = _final_params(corpus, "whole")
    got, _ = _final_params(corpus, "parts")
    assert got["step"] == want["step"] == 4
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for name in ("mu", "nu"):
        for a, b in zip(got["opt"][name], want["opt"][name]):
            assert torch.equal(a, b)


def test_cli_restore_from_warm_start_freeze_and_accumulation(corpus, capsys):
    """``run.restore_from`` another directory, ``pretrained_encoder_path``,
    the freeze mask and ``update_freq`` microbatches through the CLI."""
    cli.main(_overrides(corpus, "stage1", **{"run.max_update": 1}))
    stage1, _ = _final_params(corpus, "stage1")
    tmp = corpus[0]
    enc = load_pretrained_encoder(tmp / "stage1")
    assert enc and all(k.startswith("encoder.") for k in enc)
    assert load_pretrained_encoder(tmp / "stage1" / "step_000000001").keys() \
        == enc.keys()
    cli.main(_overrides(corpus, "stage2", **{
        "run.max_update": 2, "run.pretrained_encoder_path": tmp / "stage1",
        "run.freeze_w2v2_enc": 99, "run.update_freq": 2, "run.seed": 5}))
    recs = [r for r in _records(capsys) if r["tag"] == "train"]
    assert [r["step"] for r in recs] == [1, 1, 2]
    stage2, _ = _final_params(corpus, "stage2")
    frozen = [k for k in stage1["model"]
              if k.startswith("encoder.w2v2_model.")]
    assert frozen
    for k in frozen:       # warm-started, then frozen (weight decay apart)
        np.testing.assert_allclose(stage2["model"][k].numpy(),
                                   stage1["model"][k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    moved = "decoder.lm.layers.0.fc1.weight"
    assert not torch.allclose(stage2["model"][moved], stage1["model"][moved],
                              atol=1e-5)
    with pytest.raises(FileNotFoundError):
        load_pretrained_encoder(tmp / "nothing_here")
    with pytest.raises(ValueError, match="Wav2Vec2Model"):
        load_pretrained_encoder(corpus[2])     # a file: a .pt needs a model
    cli.main(_overrides(corpus, "stage3", **{
        "run.max_update": 2, "run.restore_from": tmp / "stage1"}))
    assert [r["step"] for r in _records(capsys)
            if r["tag"] == "train"] == [2]
    model = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError):                       # no encoder there
        mgr = CheckpointManager(tmp / "lin")
        mgr.save(1, TrainState.create(model, build_optimizer(OptimConfig())))
        apply_pretrained_encoder(model, tmp / "lin")


def test_cli_skips_a_batch_that_runs_out_of_memory(corpus, capsys,
                                                   monkeypatch):
    real = cli.make_train_step
    calls = []

    def flaky(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch, gen):
            calls.append(len(calls))
            if len(calls) == 2:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return step(state, batch, gen)

        return wrapped

    monkeypatch.setattr(cli, "make_train_step", flaky)
    cli.main(_overrides(corpus, "oom", **{"run.max_update": 3,
                                          "caat.step_mode": "constant"}))
    recs = [r for r in _records(capsys) if r["tag"] == "train"]
    assert [r["step"] for r in recs] == [1, 2, 3] and len(calls) == 4
    assert [r.get("oom_skipped", 0) for r in recs] == [0, 1, 0]
    assert "decision_step" not in recs[0]
    # an epoch in which no batch fits is not skipped over for ever
    monkeypatch.setattr(cli, "make_train_step", lambda *a, **kw: (
        lambda *b: (_ for _ in ()).throw(torch.cuda.OutOfMemoryError("x"))))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        cli.main(_overrides(corpus, "oom2"))


def test_cli_patience_stops_early(corpus, capsys):
    cli.main(_overrides(corpus, "pat", **{
        "run.max_update": 8, "run.validate_interval_updates": 1,
        "run.patience": 1, "optim.lr": 0.0, "optim.warmup_init_lr": 0.0,
        "run.save_interval_updates": 0}))
    recs = _records(capsys)
    # lr 0: the validation loss cannot improve after the first validation
    assert [r["step"] for r in recs if r["tag"] == "valid"] == [1, 2]
    assert CheckpointManager(corpus[0] / "pat").all_steps() == [2]


#: the trainer's memory and launch switches (JAX train/step.py), each
#: run against the plain run with every dropout on: rematerialization
#: recomputes the same arithmetic from the same draws (bit-equal); the
#: flat Adam sums the gradient norm in another order, over parameters
#: that are views into one vector
SWITCHES = {
    "remat_dots": {"run.remat": "dots"},
    "remat_nothing": {"run.remat": "nothing"},
    "remat_offload_dots": {"run.remat": "offload_dots"},
    "remat_extractor": {"model.remat_extractor": "True"},
    "remat_nothing_and_extractor": {"run.remat": "nothing",
                                    "model.remat_extractor": "True"},
    "flat_optimizer": {"run.flat_optimizer": "true"},
}
DROPOUTS = {"model.dropout": 0.1, "model.attention_dropout": 0.1,
            "model.activation_dropout": 0.1, "model.encoder_layerdrop": 0.3,
            "caat.dropout": 0.1, "caat.rand_pos_decoder": 4,
            "model.feature_grad_mult": 0.1}


@pytest.mark.parametrize("case", sorted(SWITCHES))
def test_cli_trains_under_each_switch(corpus, capsys, case):
    """Each switch through ``train.cli``: the same progress records and
    the same parameters as the plain run (4 updates, flash attention,
    sampled decision steps, the dropouts, layerdrop and position offsets
    on)."""
    cli.main(_overrides(corpus, "plain", **DROPOUTS))
    plain = [r for r in _records(capsys) if r["tag"] == "train"]
    cli.main(_overrides(corpus, "switch", **DROPOUTS, **SWITCHES[case]))
    got = [r for r in _records(capsys) if r["tag"] == "train"]
    want, _ = _final_params(corpus, "plain")
    have, _ = _final_params(corpus, "switch")
    assert len(got) == len(plain) == 4
    if case == "flat_optimizer":
        assert have["opt"]["flat"] and len(have["opt"]["mu"]) == 1
        for a, b in zip(got, plain):
            for k in ("loss_total", "grad_norm"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
        # a hundredth of one step (tests/test_torch_port_train.py): the
        # k-projection biases' true gradient is 0, so their updates follow
        # rounding noise, which the flat views' alignment moves
        for k, v in want["model"].items():
            torch.testing.assert_close(have["model"][k], v, rtol=0,
                                       atol=1e-2 * 0.001, msg=k)
        return
    for a, b in zip(got, plain):
        assert {k: v for k, v in a.items() if k != "ups"} == {
            k: v for k, v in b.items() if k != "ups"}
    for k, v in want["model"].items():
        assert torch.equal(have["model"][k], v), k


def test_cli_refuses_an_unknown_remat_policy(corpus):
    with pytest.raises(ValueError, match="run.remat='everything'"):
        cli.main(_overrides(corpus, "never", **{"run.remat": "everything"}))
    assert not (corpus[0] / "never").exists()


def test_cli_rejects_unknown_model_fields_and_a_missing_card(corpus):
    # a key that neither package knows is refused ...
    with pytest.raises(ValueError, match="model.no_such_field"):
        cli.main(_overrides(corpus, "never", **{"model.no_such_field": 16}))
    assert "no_such_field" not in {
        f.name for f in dataclasses.fields(JaxWav2Vec2Config)}
    # ... a pre-training field of the JAX config is accepted and inert
    tmp, _, _ = corpus
    plain = config.load_config(None, _overrides(corpus, "a")[2:])
    extra = config.load_config(None, _overrides(
        corpus, "b", **{"model.final_dim": 16, "model.mask_prob": 0.5,
                        "model.dropout_input": 0.3})[2:])
    models = [cli.build_caat(c)[2] for c in (plain, extra)]
    assert models[1].w2v_cfg.final_dim == 16
    a, b = (m.state_dict() for m in models)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="caat.frontend"):
        cli.main(_overrides(corpus, "never", **{"caat.frontend": "resnet"}))
    if not torch.cuda.is_available():
        args = ["--device", "cuda"] + _overrides(corpus, "never")[2:]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)


# ---- one yaml drives both packages ------------------------------------------

def test_wav2vec2_config_has_every_jax_field_with_its_default():
    """``Wav2Vec2Config(**cfg.model)`` builds from one yaml in both
    packages: same field names, same defaults, the JAX order."""
    jax_fields = [(f.name, f.default)
                  for f in dataclasses.fields(JaxWav2Vec2Config)]
    port_fields = [(f.name, f.default)
                   for f in dataclasses.fields(Wav2Vec2Config)]
    assert port_fields == jax_fields


CONFIGS = Path(__file__).resolve().parents[1] / "configs"
CAAT_RECIPES = ("caat_base.yaml", "caat_simulasr_base.yaml",
                "caat_simulasr_large.yaml", "caat_simulst_large.yaml")


def test_the_caat_recipes_are_the_ones_listed():
    assert sorted(p.name for p in CONFIGS.glob("caat_*.yaml")) == sorted(
        CAAT_RECIPES)


@pytest.mark.parametrize("recipe", CAAT_RECIPES)
def test_cli_builds_every_caat_recipe(corpus, recipe):
    """Each CAAT recipe of the repo loads through the port's config path
    and builds a model once its ``???`` paths, the tokenizer (no
    sentencepiece model here) and the widths are overridden; the encoder
    config equals the one the JAX package builds from the same yaml and
    overrides, field by field."""
    pytest.importorskip("yaml", reason="PyYAML is not installed")
    _, tsv, vocab = corpus
    overrides = [
        "run.w2v2_model_path=", f"data.train_manifest={tsv}",
        f"data.vocab={vocab}", "data.tokenizer=word",
        "data.max_sample_size=3840",
        "model.conv_feature_layers=((32,10,5),(32,3,2),(32,2,2))",
        "model.encoder_embed_dim=32", "model.encoder_ffn_embed_dim=64",
        "model.encoder_attention_heads=4", "model.final_dim=8",
        "caat.decoder_embed_dim=24", "caat.decoder_ffn_embed_dim=48",
        "caat.decoder_attention_heads=4", "caat.jointer_embed_dim=24",
        "caat.jointer_ffn_embed_dim=48", "caat.jointer_attention_heads=4"]
    cfg = config.load_config(str(CONFIGS / recipe), overrides)
    cli.check_supported(cfg)
    _, _, model, caat_cfg, _ = cli.build_caat(cfg)

    jax_cfg = jax_config.load_config(str(CONFIGS / recipe), overrides)
    want = JaxWav2Vec2Config(**{
        k: (tuple(map(tuple, v)) if k == "conv_feature_layers" else v)
        for k, v in jax_cfg.model.items()},
        main_context=jax_cfg.context.main_context,
        right_context=jax_cfg.context.right_context)
    assert dataclasses.asdict(model.w2v_cfg) == dataclasses.asdict(want)
    assert model.w2v_cfg.pos_type == "sin"
    assert model.w2v_cfg.extractor_mode == "layer_norm"
    n_layers = len(model.encoder.w2v2_model.encoder.layers)
    assert n_layers == cfg.model["encoder_layers"] == want.encoder_layers
    assert caat_cfg.vocab_size == len(Dictionary.load(str(vocab)))


#: model values that the JAX CLI takes and the port builds as JAX does:
#: pos_type is read nowhere (the encoder type decides the positions), the
#: default extractor mode puts a group norm in conv block 0
AS_IN_JAX = {"pos_type_conv": ("pos_type", "conv"),
             "extractor_default": ("extractor_mode", "default")}


def _jax_tree(model, *inputs):
    """The parameter tree of the flax ``model`` (traced, not run), each
    leaf filled from a seeded numpy normal."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda: model.init(
        {n: jax.random.PRNGKey(i) for i, n in enumerate(
            ("params", "dropout", "gumbel", "negatives", "layerdrop",
             "rand_pos"))},
        *(jnp.zeros(x.shape, x.dtype) for x in inputs),
        train=False))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda leaf: rng.standard_normal(leaf.shape).astype(np.float32),
        shapes)


def _built_as_in_jax(case, model, plain, jax_sd, jax_plain_sd):
    """``model`` (built with the case's value) against ``plain`` (the
    default config's), and the JAX package's two models converted to the
    port's names (``jax_sd``, ``jax_plain_sd``): the port holds the JAX
    model's parameters, name for name and shape for shape;
    pos_type=conv leaves both packages' models and the port's features as
    they are; extractor_mode=default swaps block 0's layer norm for a
    group norm, under fairseq's names."""
    a, b = model.state_dict(), plain.state_dict()
    assert {k: v.shape for k, v in a.items()} == {
        k: v.shape for k, v in jax_sd.items()}
    model.load_state_dict(jax_sd, strict=True)
    plain.load_state_dict(jax_plain_sd, strict=True)
    if case == "pos_type_conv":
        assert jax_sd.keys() == jax_plain_sd.keys()
        a, b = model.state_dict(), plain.state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)
        src = torch.randn((2, 1600), generator=torch.Generator(
        ).manual_seed(0))
        with torch.no_grad():
            assert torch.equal(model.extract_features(src)[0],
                               plain.extract_features(src)[0])
        return
    fe = "feature_extractor.conv_layers.0.2"
    assert isinstance(model.feature_extractor.conv_layers[0][2],
                      torch.nn.GroupNorm)
    assert set(a) - set(b) == {fe + ".weight", fe + ".bias"}
    gone = set(b) - set(a)           # every block's layer norm
    assert {fe + ".1.weight", fe + ".1.bias"} <= gone
    assert all(".2.1." in k for k in gone)


@pytest.mark.parametrize("case", sorted(AS_IN_JAX))
def test_cli_builds_what_jax_builds_for_the_ported_values(corpus, case):
    """The two values the CLI refused until the full-context encoder and
    the group norm came: ``cli.build_caat`` builds the encoder that the
    JAX CLI's ``build_caat`` builds for them."""
    from wav2vec_s_tpu.train import cli as jax_cli
    from wav2vec_s_tpu_torch.checkpoint.convert import (
        caat_state_dict_from_jax)

    field, value = AS_IN_JAX[case]
    argvs = [_overrides(corpus, "a", **extra)[2:]
             for extra in ({f"model.{field}": value}, {})]
    model, plain = (cli.build_caat(config.load_config(None, argv))[2]
                    for argv in argvs)
    assert getattr(model.encoder.w2v2_model.cfg, field) == value
    prev = np.zeros((1, 5), np.int32)
    jax_sd, jax_plain_sd = (
        caat_state_dict_from_jax(_jax_tree(
            jax_cli.build_caat(jax_config.load_config(None, argv))[2],
            np.zeros((1, 2400), np.float32), prev))
        for argv in argvs)
    enc = "encoder.w2v2_model."
    _built_as_in_jax(case, model.encoder.w2v2_model,
                     plain.encoder.w2v2_model,
                     *({k[len(enc):]: v for k, v in sd.items()
                        if k.startswith(enc)}
                       for sd in (jax_sd, jax_plain_sd)))


@pytest.mark.parametrize("case", sorted(AS_IN_JAX))
def test_model_builds_what_jax_builds_for_the_ported_values(case):
    """Built directly: ``Wav2Vec2Model`` takes the two values and holds
    what the JAX package's ``Wav2Vec2Model`` holds for them."""
    from wav2vec_s_tpu.models.wav2vec2 import Wav2Vec2Model as JaxModel
    from wav2vec_s_tpu_torch.checkpoint.convert import (
        wav2vec2_state_dict_from_jax)

    field, value = AS_IN_JAX[case]
    kw = dict(conv_feature_layers=((8, 10, 5), (8, 3, 2)), encoder_layers=1,
              encoder_embed_dim=8, encoder_ffn_embed_dim=16,
              encoder_attention_heads=2, main_context=4, right_context=2,
              final_dim=8)
    cfgs = (dict(kw, **{field: value}), kw)
    model, plain = (random_init_(Wav2Vec2Model(Wav2Vec2Config(**c),
                                               pretraining=True),
                                 torch.Generator().manual_seed(1))
                    for c in cfgs)
    jax_sd, jax_plain_sd = (
        wav2vec2_state_dict_from_jax(_jax_tree(
            JaxModel(JaxWav2Vec2Config(**c)),
            np.zeros((1, 2400), np.float32), np.zeros((1, 4), np.int32),
            np.zeros((), np.int32)))
        for c in cfgs)
    _built_as_in_jax(case, model, plain, jax_sd, jax_plain_sd)


def test_remat_extractor_gives_the_plain_features_and_gradients():
    """``remat_extractor`` recomputes the conv front-end in the backward:
    the same pre-training loss and every gradient as the plain model, with
    ``feature_grad_mult`` scaling the front-end's gradient in both."""
    from wav2vec_s_tpu_torch.ops.dropout import DropoutContext

    cfg = dict(conv_feature_layers=((8, 10, 5), (8, 3, 2)), encoder_layers=1,
               encoder_embed_dim=8, encoder_ffn_embed_dim=16,
               encoder_attention_heads=2, main_context=4, right_context=2,
               final_dim=8, feature_grad_mult=0.1)
    source = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 2400)).astype(np.float32))
    grads = []
    for remat in (False, True):
        model = random_init_(Wav2Vec2Model(Wav2Vec2Config(
            **cfg, remat_extractor=remat), pretraining=True),
            torch.Generator().manual_seed(1))
        out = model(source, torch.arange(0, 40, 4).repeat(2, 1), 3,
                    ctx=DropoutContext(torch.Generator().manual_seed(0)))
        (out["logits"].float().logsumexp(-1).sum()
         + out["features_pen"]).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for k, g in grads[0].items():
        assert torch.equal(grads[1][k], g), k


@pytest.mark.parametrize("case", [{"run.num_devices": 2},
                                  {"run.zero": "true"},
                                  {"run.fsdp": "true"}, {"run.seq": 2}])
def test_cli_parallel_settings_need_a_launched_group(corpus, case):
    """Data, ZeRO-1, FSDP and context parallelism run under a process group
    (tests/test_torch_port_parallel*.py run them); without one launched
    the CLI says how to launch, before it builds anything."""
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        cli.main(_overrides(corpus, "never", **case))
    assert not (corpus[0] / "never").exists()


def test_seq_axis_without_a_seq_group_raises():
    """A config that names a seq axis builds, and its forward refuses to
    run the whole sequence on one rank without the group it names."""
    cfg = Wav2Vec2Config(
        conv_feature_layers=((8, 10, 5), (8, 3, 2)), encoder_layers=1,
        encoder_embed_dim=8, encoder_ffn_embed_dim=16,
        encoder_attention_heads=2, seq_axis="seq")
    model = Wav2Vec2Model(cfg)
    with pytest.raises(RuntimeError, match="process group"):
        model.extract_features(torch.zeros((1, 400)))
