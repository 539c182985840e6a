"""The fbank and text CAAT families through the port's entry points, on the
CPU, against the JAX package's CLIs.

- ``train.cli`` with ``data.features=fbank`` (log-mel buckets, ``Whiten``,
  the size hint in frames) and with ``data.features=text`` (a bitext tsv):
  each CLI starts from the same weights (the JAX CLI's ``init_params``
  returns the seeded tree; the port's run resumes the converted tree saved
  at update 0), learning rate 0, every dropout off (the JAX CLI validates
  in training mode); one update, then a validation with ``run.eval_bleu``:
  the first update's loss records and the validation records equal;
- a validation under ``data.specaugment`` equals one without it (the
  validation batcher drops ``TFMask``); ``caat.frontend`` /
  ``caat.jointer_type`` pick the model's modules;
- ``eval.cli simul`` and ``interactive`` on an fbank checkpoint print what
  the JAX CLI prints on the same weights (``simul``: but for the
  wall-clock AL_CA);
- the remaining raises: the eval subcommands that decode raw audio only,
  and the text family in ``simul`` / ``interactive``, raise ``ValueError``
  with the JAX package's reason (no ROADMAP item); the trainer refuses
  the families outside ``run.task=caat`` and an unknown feature kind.

Tolerances: losses rtol 1e-5 with atol 1e-4 (the progress records round
to 4 decimals); BLEU, texts, delays and printed lines equal.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_port_asr_cli import _main, _recording
from tests.test_torch_port_fbank import CAAT, W2V, agent_params
from tests.test_torch_port_fbank import jax_model as jax_fbank_model
from tests.test_torch_port_fbank import port_model as port_fbank_model
from tests.test_torch_port_text_caat import jax_model as jax_text_model
from tests.test_torch_port_text_caat import port_model as port_text_model
from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
from wav2vec_s_tpu_torch.data.audio import write_wav
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.eval import cli as eval_cli
from wav2vec_s_tpu_torch.train import cli
from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
from wav2vec_s_tpu_torch.train.step import TrainState

torch.set_num_threads(1)

NSPECIAL = Dictionary().nspecial
WORDS = [f"w{i}" for i in range(CAAT.vocab_size - NSPECIAL)]
CLIPS = (6400, 9000, 11200, 14400)


def _sentence(rng, lo, hi):
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS),
                                                     rng.integers(lo, hi)))


def _yaml(root, features):
    """One yaml for both packages: the tiny encoder and CAAT blocks with
    every dropout off, the family, the 26-word dictionary."""
    lines = ["context:", f"  main_context: {W2V.main_context}",
             f"  right_context: {W2V.right_context}", "model:"]
    lines += [f"  {f}: {getattr(W2V, f)}" for f in (
        "encoder_layers", "encoder_embed_dim", "encoder_ffn_embed_dim",
        "encoder_attention_heads", "encoder_layerdrop", "dropout",
        "attention_dropout", "activation_dropout")]
    lines += ["caat:"] + [f"  {f}: {getattr(CAAT, f)}" for f in (
        "decoder_layers", "decoder_embed_dim", "decoder_ffn_embed_dim",
        "decoder_attention_heads", "jointer_layers", "jointer_embed_dim",
        "jointer_ffn_embed_dim", "jointer_attention_heads",
        "transducer_downsample", "tokens_per_step", "step_mode",
        "rand_pos_decoder", "dropout", "attention_dropout",
        "activation_dropout")]
    lines += ["data:", f"  vocab: {root / 'dict.txt'}",
              f"  features: {features}", "  max_sample_size: 16000",
              "  max_tokens: 100000"]
    path = root / f"{features}.yaml"
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 seeded-noise clips with an S2T tsv, 6 sentence pairs in a bitext
    tsv, the word dictionary, both yamls."""
    root = tmp_path_factory.mktemp("family_cli")
    rng = np.random.default_rng(3)
    lines = ["id\taudio\tn_frames\ttgt_text"]
    for i, n in enumerate(CLIPS):
        write_wav(root / f"utt{i}.wav",
                  (rng.standard_normal(n) * 0.3).astype(np.float32))
        lines.append(f"utt{i}\t{root}/utt{i}.wav\t{n}\t"
                     f"{_sentence(rng, 2, 5)}")
    (root / "dev.tsv").write_text("\n".join(lines) + "\n")
    pairs = ["id\tsrc_text\ttgt_text"] + [
        f"s{i}\t{_sentence(rng, 4, 12)}\t{_sentence(rng, 2, 6)}"
        for i in range(6)]
    (root / "bitext.tsv").write_text("\n".join(pairs) + "\n")
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS))
    for features in ("fbank", "text"):
        _yaml(root, features)
    return root


FAMILIES = {
    "fbank": ("dev.tsv", jax_fbank_model, port_fbank_model),
    "text": ("bitext.tsv", jax_text_model, port_text_model),
}


def _cli_args(root, features, save_dir, **extra):
    manifest = root / FAMILIES[features][0]
    ov = {"run.task": "caat", "run.max_update": 1, "run.log_interval": 1,
          "run.validate_interval_updates": 1, "run.save_interval_updates": 1,
          "run.eval_bleu": "true", "run.save_dir": save_dir,
          "data.train_manifest": manifest, "data.valid_manifest": manifest,
          "data.specaugment": "false", "optim.lr": 0.0}
    ov.update(extra)
    return ["--config", str(root / f"{features}.yaml")] + [
        f"{k}={v}" for k, v in ov.items()]


@pytest.mark.parametrize("features", sorted(FAMILIES))
def test_cli_first_update_and_validation_equal_jax_cli(corpus, tmp_path,
                                                       monkeypatch,
                                                       features):
    """Each CLI from the same weights: the first update's loss records
    (learning rate 0, so the validation after it sees those weights too)
    and the validation records equal, and so does the metric each CLI
    hands its checkpoint manager."""
    from wav2vec_s_tpu.train import cli as jax_cli

    _, jax_model, port_model = FAMILIES[features]
    _, params = jax_model()
    real = jax_cli.build_caat

    def built(cfg):
        *rest, _ = real(cfg)
        return (*rest, lambda batch: params)

    monkeypatch.setattr(jax_cli, "build_caat", built)
    metrics = {}
    for pkg, module in (("jax", jax_cli), ("port", cli)):
        monkeypatch.setattr(module, "CheckpointManager",
                            _recording(module.CheckpointManager,
                                       metrics.setdefault(pkg, [])))
    CheckpointManager(tmp_path / "port", keep_last=0).save(
        0, TrainState.create(port_model(params),
                             build_optimizer(OptimConfig())))
    want = _main(jax_cli.main, ["--platform", "cpu"] + _cli_args(
        corpus, features, tmp_path / "jax", **{"run.num_devices": 1}))
    got = _main(cli.main, ["--device", "cpu"] + _cli_args(
        corpus, features, tmp_path / "port"))
    (t_want,), (t_got,) = ([r for r in recs if r["tag"] == "train"]
                           for recs in (want, got))
    keys = (t_want.keys() & t_got.keys()) - {"tag", "step", "ups"}
    assert {"loss_total", "nll_loss", "loss_prob", "loss_delay",
            "sample_size"} <= keys
    for k in keys:
        np.testing.assert_allclose(t_got[k], t_want[k], rtol=1e-5,
                                   atol=1e-4, err_msg=k)
    (v_want,), (v_got,) = ([r for r in recs if r["tag"] == "valid"]
                           for recs in (want, got))
    assert v_got.keys() == v_want.keys() == {"tag", "step", "valid_loss",
                                             "valid_bleu"}
    np.testing.assert_allclose(v_got["valid_loss"], v_want["valid_loss"],
                               rtol=1e-5, atol=1e-4)
    assert v_got["valid_bleu"] == v_want["valid_bleu"]
    (_, m_jax), (_, m_port) = metrics["jax"][0], metrics["port"][0]
    assert m_port == m_jax == -v_got["valid_bleu"]


def test_fbank_validation_drops_tfmask(corpus, tmp_path):
    """``data.specaugment`` masks the training batches only: the
    validation loss at the same weights is the one without it."""
    runs = {}
    for spec in ("true", "false"):
        recs = _main(cli.main, ["--device", "cpu"] + _cli_args(
            corpus, "fbank", tmp_path / spec, **{
                "data.specaugment": spec, "run.eval_bleu": "false"}))
        runs[spec] = {r["tag"]: r for r in recs}
    assert runs["true"]["valid"] == runs["false"]["valid"]
    assert runs["true"]["train"]["loss_total"] != runs["false"]["train"][
        "loss_total"]


@pytest.mark.parametrize("frontend,jointer", [("resnet_small", "concat"),
                                              ("vgg2d", "attention")])
def test_cli_builds_the_configured_fbank_model(corpus, frontend, jointer):
    from wav2vec_s_tpu_torch.models import fbank
    from wav2vec_s_tpu_torch.train.config import load_config

    cfg = load_config(str(corpus / "fbank.yaml"), [
        f"caat.frontend={frontend}", f"caat.jointer_type={jointer}",
        f"data.train_manifest={corpus / 'dev.tsv'}", "run.task=caat"])
    _, batcher, model, _, _ = cli.build_caat(cfg)
    assert isinstance(model.encoder.subsample, fbank.CONV_FRONTENDS[
        frontend] if frontend != "resnet_small" else fbank.ResNetConv)
    assert isinstance(model.decoder.jointer, fbank.JOINTERS[jointer])
    assert batcher.audio_buckets == [112]            # 16000 // 160 frames
    assert [type(t).__name__ for t in batcher.transforms] == ["Whiten",
                                                              "TFMask"]


# ---- the eval CLI ------------------------------------------------------------

@pytest.fixture(scope="module")
def fbank_ckpts(corpus):
    """Both packages' checkpoints of the agent's fbank weights."""
    from wav2vec_s_tpu.checkpoint.orbax_io import (
        CheckpointManager as JaxCheckpointManager)

    params = agent_params()
    JaxCheckpointManager(corpus / "ckpt_jax", keep_last=0).save(
        1, {"params": params})
    CheckpointManager(corpus / "ckpt_port", keep_last=0).save(
        1, TrainState.create(port_fbank_model(params),
                             build_optimizer(OptimConfig())))
    (corpus / "wavs.txt").write_text("".join(
        f"{corpus}/utt{i}.wav\n" for i in (0, 3)))
    return corpus


def _both(capsys, argv_of):
    from wav2vec_s_tpu.eval import cli as jax_eval_cli

    jax_eval_cli.main(argv_of("jax"))
    want = capsys.readouterr().out
    eval_cli.main(argv_of("port") + ["--device", "cpu"])
    return capsys.readouterr().out, want


def test_fbank_simul_equals_jax_cli(fbank_ckpts, capsys):
    root = fbank_ckpts
    got, want = _both(capsys, lambda pkg: [
        "simul", "--config", str(root / "fbank.yaml"), "--ckpt-dir",
        str(root / f"ckpt_{pkg}"), "--manifest", str(root / "dev.tsv"),
        "--metric", "wer", "--intra-beam", "2", "--step-read-blocks", "1"])
    got, want = json.loads(got), json.loads(want)
    got.pop("AL_CA"), want.pop("AL_CA")
    assert got == want
    # AL is 0.0 when no clip emitted
    assert got["num_instances"] == len(CLIPS) and got["AL"] != 0.0


def test_fbank_interactive_equals_jax_cli(fbank_ckpts, capsys):
    root = fbank_ckpts
    got, want = _both(capsys, lambda pkg: [
        "interactive", "--config", str(root / "fbank.yaml"), "--ckpt-dir",
        str(root / f"ckpt_{pkg}"), "--input", str(root / "wavs.txt"),
        "--intra-beam", "2"])
    assert got == want
    assert any(ln.startswith("W-") for ln in got.splitlines())


RAISES = {f"fbank_{cmd}": (cmd, "fbank") for cmd in (
    "batch-decode", "sweep", "generate", "eval-lm", "ctc-decode")}
RAISES.update({f"text_{cmd}": (cmd, "text") for cmd in (
    "simul", "interactive", "batch-decode")})


@pytest.mark.parametrize("case", sorted(RAISES))
def test_eval_cli_raises_for_what_the_family_does_not_decode(corpus, case):
    cmd, features = RAISES[case]
    extra = {"eval-lm": ["--text", str(corpus / "dict.txt")],
             "interactive": ["--input", str(corpus / "wavs.txt")]}.get(
                 cmd, ["--manifest", str(corpus / "dev.tsv")])
    with pytest.raises(ValueError, match="'simul' and 'interactive'") as e:
        eval_cli.main([cmd, "--config", str(corpus / f"{features}.yaml"),
                       "--ckpt-dir", str(corpus / "no_ckpt"), "--device",
                       "cpu", *extra])
    assert "item" not in str(e.value)


@pytest.mark.parametrize("extra,match", [
    ({"run.task": "s2s"}, "run.task=caat"),
    ({"run.task": "ctc", "data.features": "text"}, "run.task=caat"),
    ({"data.features": "mfcc"}, "is not one of")], ids=["fbank_s2s",
                                                     "text_ctc", "unknown"])
def test_train_cli_refuses_the_families_outside_caat(corpus, tmp_path,
                                                     extra, match):
    with pytest.raises(ValueError, match=match):
        cli.main(["--device", "cpu"] + _cli_args(
            corpus, "fbank", tmp_path / "never", **extra))
    assert not (tmp_path / "never").exists()


def _freeze_heads():
    """{head: (JAX tree, port model, converter)}."""
    from tests.test_torch_port_asr import jax_head, port_head
    from tests.test_torch_port_pretrain import jax_w2v, port_w2v
    from wav2vec_s_tpu_torch.checkpoint import convert

    return {
        "ctc": (jax_head("ctc")[1], port_head("ctc"),
                convert.ctc_state_dict_from_jax),
        "s2s": (jax_head("s2s")[1], port_head("s2s"),
                convert.s2s_state_dict_from_jax),
        "pretrain": (jax_w2v()[1], port_w2v(jax_w2v()[1]),
                     convert.wav2vec2_state_dict_from_jax),
        "fbank": (jax_fbank_model()[1], port_fbank_model(
            jax_fbank_model()[1]), convert.fbank_state_dict_from_jax),
        "text": (jax_text_model()[1], port_text_model(jax_text_model()[1]),
                 convert.text_caat_state_dict_from_jax)}


@pytest.mark.parametrize("freeze_enc,freeze_updates,step", [
    (1, 0, 0), (0, 5, 3), (1, 5, 7)])
@pytest.mark.parametrize("head", ["ctc", "s2s", "pretrain", "fbank",
                                  "text"])
def test_freeze_mask_matches_jax_on_each_encoder(head, freeze_enc,
                                                 freeze_updates, step):
    """The freeze schedules reach the encoder subtree that the JAX mask
    reaches (each model's ``encoder_prefix``): the CTC and seq2seq heads'
    wav2vec-S model, the pre-training model's transformer encoder, the
    whole fbank and text encoders (their front-ends and embeddings
    too)."""
    import jax

    from wav2vec_s_tpu.train import recipes as jax_recipes
    from wav2vec_s_tpu_torch.train.recipes import make_freeze_mask

    params, model, convert = _freeze_heads()[head]
    ones = jax.tree_util.tree_map(np.ones_like, params)
    want = convert(jax.device_get(jax_recipes.make_freeze_mask(
        freeze_enc, freeze_updates)(ones, step)))
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    make_freeze_mask(model, freeze_enc, freeze_updates)(grads, step)
    for name, g in grads.items():
        np.testing.assert_array_equal(g.numpy(), want[name].numpy(),
                                      err_msg=name)
    assert 0 < sum(int(g.sum() == 0) for g in grads.values()) < len(grads)
