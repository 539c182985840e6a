"""wav2vec-S pre-training through the port's training entry point, and the
``.pt`` warm starts of the CLI.

``python -m wav2vec_s_tpu_torch.train.cli --device cpu run.task=pretrain``
on synthetic wavs and an audio manifest (root line, ``path\\tnum_samples``
rows), a tiny model (the CAAT CLI tests' encoder: 2 layers, 32 wide, dh 8,
flash attention), the recipe's dropouts, block contexts sampled per update:

- finite progress records with the JAX CLI's pre-training keys, the
  (mc, rc) of each update (``sample_context_bucket`` under the update's
  ``_step_seed``), the Gumbel temperature of its update count, a
  validation record, checkpoints;
- a second call resumes from the saved step and ends with the parameters
  and moments of one uninterrupted run, bit for bit (crops and masks keyed
  on (data.seed, epoch, batch offset), every draw of an update on
  (run.seed, update)), with and without prefetch;
- ``run.load_pretrained_model_from`` a ``.pt`` written by the JAX
  package, then adafactor updates (and a resumed call with its state);
- the chain: pre-training -> ``convert_cli`` export -> a CAAT run with
  ``run.w2v2_model_path`` whose encoder equals the pre-trained one before
  its first update; then it updates.
"""

import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from tests.test_torch_port_cli import _overrides as caat_overrides
from tests.test_torch_port_cli import corpus  # noqa: F401 (a fixture)
from tests.test_torch_port_import import port_cfg
from tests.test_torch_port_pretrain import W2V, jax_w2v
from wav2vec_s_tpu.checkpoint import torch_export as jax_export
from wav2vec_s_tpu_torch.checkpoint import convert_cli
from wav2vec_s_tpu_torch.checkpoint.convert import (
    wav2vec2_state_dict_from_jax)
from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
from wav2vec_s_tpu_torch.data import audio
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.models.quantizer import gumbel_temperature
from wav2vec_s_tpu_torch.train import cli
from wav2vec_s_tpu_torch.train.recipes import sample_context_bucket

torch.set_num_threads(1)

#: the keys of the JAX CLI's pre-training progress records (the logs of
#: train/criterion.py and train/step.py), plus the sampled context
PRETRAIN_KEYS = {"tag", "step", "loss", "loss_infonce", "loss_extra_0",
                 "loss_extra_1", "correct", "count", "prob_perplexity",
                 "code_perplexity", "temp", "loss_total", "sample_size",
                 "grad_norm", "skipped", "loss_per_sample", "ups",
                 "main_context", "right_context"}
ENCODER = {"model.conv_feature_layers": "((32,10,5),(32,3,2),(32,2,2))",
           "model.encoder_layers": 2, "model.encoder_embed_dim": 32,
           "model.encoder_ffn_embed_dim": 64,
           "model.encoder_attention_heads": 4}
BUCKETS = ((8, 4), (12, 6), (16, 8), (20, 8), (24, 12), (28, 12), (32, 16))


@pytest.fixture
def audio_corpus(tmp_path):
    """8 seeded-noise wavs of 2600-4400 samples and a pre-training
    manifest; the first two also as the validation manifest."""
    rng = np.random.default_rng(0)
    rows = [str(tmp_path)]
    for i in range(8):
        n = 2600 + 250 * i
        audio.write_wav(tmp_path / f"p{i}.wav",
                        rng.standard_normal(n).astype(np.float32) * 0.1)
        rows.append(f"p{i}.wav\t{n}")
    (tmp_path / "train.tsv").write_text("\n".join(rows) + "\n")
    (tmp_path / "valid.tsv").write_text("\n".join(rows[:3]) + "\n")
    return tmp_path


def _argv(root, save_dir, **extra):
    ov = {"run.task": "pretrain", "run.save_dir": f"{root}/{save_dir}",
          "run.max_update": 4, "run.log_interval": 1,
          "run.save_interval_updates": 2, "run.validate_interval_updates": 4,
          "run.seed": 3,
          "data.train_manifest": root / "train.tsv",
          "data.valid_manifest": root / "valid.tsv",
          "data.max_tokens": 12000, "data.max_sample_size": 4000,
          "data.min_sample_size": 1000,
          "optim.lr": 0.001, "optim.lr_scheduler": "inverse_sqrt",
          "optim.warmup_updates": 2,
          "context.context_type": "sampling",
          "model.final_dim": 16, "model.latent_vars": 8,
          "model.n_negatives": 5, "model.attention_impl": "flash",
          "model.encoder_layerdrop": 0.0, **ENCODER}
    ov.update(extra)
    return ["--device", "cpu"] + [f"{k}={v}" for k, v in ov.items()]


def _records(capsys, tag="train"):
    out = capsys.readouterr().out
    return [r for r in (json.loads(line) for line in out.splitlines()
                        if line.startswith("{")) if r["tag"] == tag or
            tag is None]


def _restore(path):
    return CheckpointManager(path, keep_last=0).restore()


def test_pretrain_cli_trains_validates_saves(audio_corpus, capsys):
    cli.main(_argv(audio_corpus, "ck"))
    recs = _records(capsys, None)
    train = [r for r in recs if r["tag"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    for r in train:
        assert set(r) == PRETRAIN_KEYS, set(r) ^ PRETRAIN_KEYS
        assert all(np.isfinite(v) for k, v in r.items() if k != "tag")
        assert r["skipped"] == 0.0 and 0 <= r["correct"] <= r["count"]
        n = r["step"] - 1
        want = sample_context_bucket(
            random.Random(cli._step_seed(3, n)), BUCKETS)
        assert (r["main_context"], r["right_context"]) == want
        # the records round to 4 digits
        assert r["temp"] == round(float(gumbel_temperature(
            n, 2.0, 0.5, 0.999995)), 4)
    # 8 wavs of <= 4000 samples in batches of 3 by max_tokens
    assert train[0]["sample_size"] == train[0]["count"]
    valid = [r for r in recs if r["tag"] == "valid"]
    assert len(valid) == 1 and np.isfinite(valid[0]["valid_loss"])
    mgr = CheckpointManager(audio_corpus / "ck", keep_last=0)
    assert mgr.all_steps() == [2, 4]
    payload, meta = mgr.restore()
    assert payload["step"] == 4 and payload["opt"]["count"] == 4
    assert "quantizer.vars" in payload["model"]
    assert meta["extra"]["iterator"] == {"epoch": 1, "batch_offset": 1}


@pytest.mark.parametrize("prefetch", [0, 2])
def test_pretrain_cli_resume_equals_an_uninterrupted_run(audio_corpus,
                                                         capsys, prefetch):
    extra = {"run.prefetch": prefetch, "model.attention_impl": "dense"}
    cli.main(_argv(audio_corpus, "whole", **extra))
    whole = _records(capsys)
    cli.main(_argv(audio_corpus, "parts", **dict(extra,
                                                 **{"run.max_update": 3})))
    first = _records(capsys)
    cli.main(_argv(audio_corpus, "parts", **extra))       # resumes at 3
    second = _records(capsys)
    assert [r["step"] for r in second] == [4]
    for a, b in zip(whole, first + second):
        assert {k: v for k, v in a.items() if k != "ups"} == {
            k: v for k, v in b.items() if k != "ups"}
    want, _ = _restore(audio_corpus / "whole")
    got, _ = _restore(audio_corpus / "parts")
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for name in ("mu", "nu"):
        for a, b in zip(got["opt"][name], want["opt"][name]):
            assert torch.equal(a, b)


def test_pretrain_cli_from_a_pt_with_adafactor(audio_corpus, capsys):
    cfg = dataclasses.replace(W2V, conv_feature_layers=(
        (32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_embed_dim=32,
        encoder_ffn_embed_dim=64, final_dim=16, latent_vars=8)
    _, params = jax_w2v(cfg)
    jax_export.save_fairseq_checkpoint(
        audio_corpus / "w2v.pt", jax_export.export_wav2vec2_params(params))
    def argv(max_update, **extra):
        return _argv(audio_corpus, "ada", **{
            "run.load_pretrained_model_from": audio_corpus / "w2v.pt",
            "optim.optimizer": "adafactor", "run.max_update": max_update},
            **extra)

    cli.main(argv(0))
    start, _ = _restore(audio_corpus / "ada")
    want = wav2vec2_state_dict_from_jax(params)
    assert start["model"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(start["model"][k], v), k
    assert set(start["opt"]) == {"count", "v_row", "v_col", "v"}
    cli.main(argv(2, **{"run.save_interval_updates": 1}))
    recs = _records(capsys)
    assert [r["step"] for r in recs] == [1, 2]
    cli.main(argv(3))                                     # resumes at 2
    recs = _records(capsys)
    assert [r["step"] for r in recs] == [3]
    assert all(np.isfinite(r["loss_total"]) for r in recs)
    end, _ = _restore(audio_corpus / "ada")
    assert end["opt"]["count"] == 3
    assert not torch.equal(end["model"]["final_proj.weight"],
                           want["final_proj.weight"])


def test_pretrain_export_warm_starts_caat(audio_corpus, corpus, capsys):
    """Pre-training -> convert_cli export -> CAAT with
    ``run.w2v2_model_path``: before its first update the CAAT encoder is
    the pre-trained model (its heads dropped); it then trains."""
    cli.main(_argv(audio_corpus, "pre", **{"run.max_update": 2}))
    assert [r["step"] for r in _records(capsys)] == [1, 2]
    convert_cli.main(["--export-from", str(audio_corpus / "pre"), "--out",
                      str(audio_corpus / "pre.pt")])
    pre, _ = _restore(audio_corpus / "pre")
    def argv(max_update):
        return caat_overrides(corpus, "caat", **{
            "run.w2v2_model_path": audio_corpus / "pre.pt",
            "run.max_update": max_update})

    cli.main(argv(0))
    start, _ = _restore(corpus[0] / "caat")
    enc = {k[len("encoder.w2v2_model."):]: v
           for k, v in start["model"].items()
           if k.startswith("encoder.w2v2_model.")}
    assert enc and set(enc) == set(pre["model"]) - {
        k for k in pre["model"] if k.startswith(
            ("quantizer.", "project_q.", "final_proj."))}
    for k, v in enc.items():
        assert torch.equal(v, pre["model"][k]), k
    cli.main(argv(1))
    recs = [r for r in _records(capsys) if r["tag"] == "train"]
    assert [r["step"] for r in recs] == [1]
    assert np.isfinite(recs[0]["loss_total"])
    # the config the CLI builds the pre-training model from
    cfg = cli.pretrain_config(cli.load_config(None, _argv(
        audio_corpus, "x")[2:]))
    assert cfg == port_cfg(Wav2Vec2Config, cfg)
    assert cfg.context_type == "sampling" and cfg.final_dim == 16
