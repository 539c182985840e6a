"""The offline-ASR family through the port's entry points, on the CPU.

- ``train.cli`` with ``run.task=ctc`` (``run.eval_wer``) and
  ``run.task=s2s`` (``run.eval_bleu``, and without it), and a CAAT run
  with ``run.eval_bleu``: 5 tiny updates (one run per task, shared by the
  tests), finite progress records with the JAX CLI's keys, validation
  records with the task's metric, and the best-checkpoint metric of each
  checkpoint (``meta.json``) chosen as the JAX CLI chooses it (WER for
  CTC, -BLEU under ``eval_bleu``, -accuracy for s2s, else the loss);
- the same four validations against the JAX CLI's on the same weights:
  the JAX CLI starts from the seeded JAX tree (its update made the
  identity) and the port's from the converted tree (a checkpoint at
  update 0, learning rate 0); both validate after one update over the
  same batches: loss, WER / BLEU / accuracy and the checkpoint's metric
  equal;
- stage-to-stage warm starts through ``run.pretrained_encoder_path``: a
  seq2seq run directory seeds a CAAT and a CTC encoder, a CTC run
  directory a seq2seq one (equal weights before the first update);
- ``eval.cli ctc-decode`` and ``eval.cli generate`` print the same JSON
  lines as the JAX CLI on the same weights (each package's checkpoint
  written by its own manager) and the same yaml.
"""

import contextlib
import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_asr import EMITS, jax_head, port_head
from tests.test_torch_port_import import jax_caat, port_caat
from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
from wav2vec_s_tpu_torch.data.audio import write_wav
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.eval import cli as eval_cli
from wav2vec_s_tpu_torch.eval.generator import make_s2s_greedy_decoder
from wav2vec_s_tpu_torch.train import cli
from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
from wav2vec_s_tpu_torch.train.step import TrainState

torch.set_num_threads(1)

TEXTS = ["guten tag welt", "hallo du", "wie geht es dir", "sehr gut",
         "guten tag", "welt"]
ASR = ["hello world", "good day", "how are you", "very well", "hi",
       "well well"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """6 seeded-noise clips of 1920 + 320 i samples, an S2T tsv (German
    tgt_text, English src_text), a word dict of the German and a letter
    dict of the English."""
    root = tmp_path_factory.mktemp("asr_cli")
    rng = np.random.default_rng(0)
    lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
    for i, (text, src) in enumerate(zip(TEXTS, ASR)):
        ns = 1920 + 320 * i
        write_wav(root / f"utt{i}.wav",
                  rng.standard_normal(ns).astype(np.float32) * 0.1)
        lines.append(f"utt_{i}\t{root}/utt{i}.wav\t{ns}\t{text}\t{src}")
    (root / "train.tsv").write_text("\n".join(lines) + "\n")
    words = sorted({w for t in TEXTS for w in t.split()})
    (root / "words.txt").write_text("".join(f"{w} 1\n" for w in words))
    letters = sorted({c for t in ASR for c in t.replace(" ", "")} | {"▁"})
    (root / "letters.txt").write_text("".join(f"{c} 1\n" for c in letters))
    return root


ENCODER = {
    "context.main_context": 4, "context.right_context": 2,
    "model.conv_feature_layers": "((32,10,5),(32,3,2),(32,2,2))",
    "model.encoder_layers": 2, "model.encoder_embed_dim": 32,
    "model.encoder_ffn_embed_dim": 64, "model.encoder_attention_heads": 4,
    "model.attention_impl": "flash", "model.encoder_layerdrop": 0.0,
    "model.feature_grad_mult": 1.0,
}
DECODER = {
    "caat.decoder_layers": 2, "caat.decoder_embed_dim": 24,
    "caat.decoder_ffn_embed_dim": 48, "caat.decoder_attention_heads": 4,
    "caat.jointer_layers": 2, "caat.jointer_embed_dim": 24,
    "caat.jointer_ffn_embed_dim": 48, "caat.jointer_attention_heads": 4,
    "caat.transducer_downsample": 8, "caat.tokens_per_step": 500,
    "caat.step_mode": "constant",
}
TASKS = {
    "ctc": {"run.task": "ctc", "run.eval_wer": "true",
            "run.final_dropout": 0.1, "data.vocab": "letters.txt",
            "data.tokenizer": "char", "data.task_type": "asr"},
    "s2s": {"run.task": "s2s", "run.eval_bleu": "true",
            "data.vocab": "words.txt"},
    "s2s_accuracy": {"run.task": "s2s", "data.vocab": "words.txt"},
    "caat": {"run.task": "caat", "run.eval_bleu": "true",
             "data.vocab": "words.txt"},
}


def _argv(root, save_dir, task, **extra):
    ov = dict(ENCODER, **DECODER, **{
        "run.save_dir": root / save_dir, "run.max_update": 5,
        "run.log_interval": 1, "run.save_interval_updates": 2,
        "run.validate_interval_updates": 2, "run.keep_last": 0,
        "data.train_manifest": root / "train.tsv",
        "data.valid_manifest": root / "train.tsv",
        "data.max_tokens": 7100, "data.max_sample_size": 3840,
        "optim.lr": 0.001, "optim.lr_scheduler": "inverse_sqrt",
        "optim.warmup_updates": 2})
    ov.update(TASKS[task])
    ov["data.vocab"] = root / ov["data.vocab"]
    ov.update(extra)
    return ["--device", "cpu"] + [f"{k}={v}" for k, v in ov.items()]


def _main(main, argv):
    """``main(argv)`` -> the JSON records it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")]


@pytest.fixture(scope="module")
def trained(corpus):
    """Each task's run: 5 updates, validating at 2 and 4, checkpoints at 2,
    4 and 5 -> {task: progress records}."""
    return {task: _main(cli.main, _argv(corpus, task, task))
            for task in TASKS}


def _metric(task, r):
    """The JAX CLI's best-checkpoint metric of a validation record."""
    key = {"ctc": "valid_wer", "s2s": "valid_bleu",
           "caat": "valid_bleu"}.get(task)
    if key:
        return r[key] if task == "ctc" else -r[key]
    return -r["valid_accuracy"]


@pytest.mark.parametrize("task", sorted(TASKS))
def test_cli_trains_validates_and_keeps_the_task_metric(corpus, trained,
                                                        task):
    recs = trained[task]
    train = [r for r in recs if r["tag"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3, 4, 5]
    for r in train:
        assert all(np.isfinite(v) for k, v in r.items() if k != "tag")
        assert r["skipped"] == 0.0
    extra = {"ctc": {"nll_loss", "n_frames"},
             "caat": {"loss", "loss_prob", "loss_delay", "nll_loss"}}.get(
                 task, {"nll_loss", "n_correct", "accuracy"})
    assert set(train[0]) == extra | {
        "tag", "step", "loss_total", "sample_size", "grad_norm", "skipped",
        "loss_per_sample", "ups"}
    valid = [r for r in recs if r["tag"] == "valid"]
    assert [r["step"] for r in valid] == [2, 4]
    key = {"ctc": "valid_wer", "s2s": "valid_bleu", "caat": "valid_bleu",
           "s2s_accuracy": None}[task]
    want_keys = {"tag", "step", "valid_loss"} | ({key} if key else set())
    if task.startswith("s2s"):
        want_keys.add("valid_accuracy")
    assert all(set(r) == want_keys for r in valid)
    assert all(np.isfinite(v) for r in valid for k, v in r.items()
               if k != "tag")

    # meta.json of the checkpoints saved after a validation: the best task
    # metric so far (the final save, update 5, carries none)
    mgr = CheckpointManager(corpus / task, keep_last=0)
    assert mgr.all_steps() == [2, 4, 5]
    got = [json.loads((mgr._step_dir(s) / "meta.json").read_text())["metric"]
           for s in (2, 4)]
    m = [_metric(task, r) for r in valid]
    np.testing.assert_allclose(got, [m[0], min(m)], atol=1e-4)


WARM = {"caat_from_s2s": ("s2s", "caat", "encoder.w2v2_model."),
        "ctc_from_s2s": ("s2s", "ctc", "w2v_encoder.w2v_model."),
        "s2s_from_ctc": ("ctc", "s2s", "encoder.w2v2_model.")}


@pytest.mark.parametrize("case", sorted(WARM))
def test_pretrained_encoder_warm_start_between_stages(corpus, trained,
                                                      case):
    """A run of the next stage with ``run.pretrained_encoder_path`` set to
    a trained run's directory and no update: its saved encoder is the
    source's (the source's last checkpoint)."""
    src_task, task, prefix = WARM[case]
    _main(cli.main, _argv(corpus, f"warm_{case}", task, **{
        "run.max_update": 0,
        "run.pretrained_encoder_path": corpus / src_task}))
    a = CheckpointManager(corpus / src_task,
                          keep_last=0).restore()[0]["model"]
    b = CheckpointManager(corpus / f"warm_{case}",
                          keep_last=0).restore()[0]["model"]
    src_prefix = ("w2v_encoder.w2v_model." if src_task == "ctc"
                  else "encoder.w2v2_model.")
    enc = {k[len(prefix):]: v for k, v in b.items() if k.startswith(prefix)}
    assert len(enc) > 20
    for k, v in enc.items():
        assert torch.equal(v, a[src_prefix + k]), k


# ---- the JAX CLIs on the same weights ---------------------------------------

def _yaml(root, task):
    """One yaml for both packages' CLIs: the tiny encoder (and the CAAT
    decoder block, which the seq2seq decoder reads too), the directory's
    dictionary."""
    w2v = {f: getattr(W2V_TINY, f) for f in (
        "encoder_layers", "encoder_embed_dim", "encoder_ffn_embed_dim",
        "encoder_attention_heads", "final_dim", "encoder_layerdrop",
        "feature_grad_mult")}
    w2v["conv_feature_layers"] = [list(x)
                                  for x in W2V_TINY.conv_feature_layers]
    lines = ["context:", f"  main_context: {W2V_TINY.main_context}",
             f"  right_context: {W2V_TINY.right_context}", "model:"]
    lines += [f"  {k}: {v}" for k, v in w2v.items()]
    if task == "ctc":
        lines += ["data:", f"  vocab: {root / 'dict.txt'}",
                  "  tokenizer: char"]
    else:
        lines += ["data:", f"  vocab: {root / 'dict.txt'}", "caat:"]
        lines += [f"  {f.name}: {getattr(CAAT_TINY, f.name)}"
                  for f in dataclasses.fields(CAAT_TINY)
                  if f.name in ("decoder_layers", "decoder_embed_dim",
                                "decoder_ffn_embed_dim",
                                "decoder_attention_heads", "jointer_layers",
                                "jointer_embed_dim", "jointer_ffn_embed_dim",
                                "jointer_attention_heads",
                                "transducer_downsample", "tokens_per_step")]
    path = root / f"{task}.yaml"
    path.write_text("\n".join(lines) + "\n")
    return path


#: the blank row of the CAAT model's tied embedding, over its norm, times
#: this: the model emits a few words on every clip and then blank (14 on
#: the first clip), so its validation decode and ``generate`` stay short
BLANK_SCALE = 4.0
CLIPS = (1300, 900, 1100, 700)


def _caat_weights():
    """(JAX tree, port model) of the CAAT model whose blank row is scaled
    by ``BLANK_SCALE``."""
    params = dict(jax_caat()[1])
    e = params["embed_tokens"] / np.linalg.norm(
        params["embed_tokens"], axis=1, keepdims=True)
    e[CAAT_TINY.bos] *= BLANK_SCALE
    params["embed_tokens"] = e
    return params, port_caat(params)


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """4 clips and a tsv; one directory per head (``ctc``: the letters;
    ``s2s``, ``caat``: words w0 .. w25) with its yaml, dict, JAX tree and
    port model, and both packages' checkpoints of the CTC and CAAT
    weights.  Each clip's ``tgt_text`` is the first 6 words of the seq2seq
    head's greedy decode of it alone, so that the validation BLEU and
    accuracy are not 0; ``src_text`` is a few letters."""
    from wav2vec_s_tpu.checkpoint.orbax_io import (
        CheckpointManager as JaxCheckpointManager)

    root = tmp_path_factory.mktemp("asr_eval")
    rng = np.random.default_rng(11)
    nspecial = Dictionary().nspecial
    words = [f"w{i}" for i in range(CAAT_TINY.vocab_size - nspecial)]
    heads = {"ctc": (jax_head("ctc")[1], port_head("ctc")),
             "s2s": (jax_head("s2s", CAAT_TINY, EMITS)[1],
                     port_head("s2s", seed=EMITS)),
             "caat": _caat_weights()}
    vocab = Dictionary()
    for w in words:
        vocab.add_symbol(w)
    decode = make_s2s_greedy_decoder(heads["s2s"][1], vocab, max_len=7)
    lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
    for i, n in enumerate(CLIPS):
        wav = rng.standard_normal(n).astype(np.float32) * 0.3
        write_wav(root / f"utt{i}.wav", wav)
        pfx, lens = decode(wav[None])
        text = " ".join(vocab[int(t)] for t in pfx[0, 1:lens[0]][:6])
        lines.append(f"utt{i}\t{root}/utt{i}.wav\t{n}\t{text}\t"
                     f"{'ab c'[:i + 1]}")
    (root / "dev.tsv").write_text("\n".join(lines) + "\n")
    out = {}
    for task, (params, model) in heads.items():
        d = root / task
        d.mkdir()
        names = ([chr(ord("a") + i) for i in range(25)] + ["▁"]
                 if task == "ctc" else words)
        (d / "dict.txt").write_text("".join(f"{w} 1\n" for w in names))
        _yaml(d, "ctc" if task == "ctc" else "caat")
        if task != "s2s":
            JaxCheckpointManager(d / "jax", keep_last=0).save(
                1, {"params": params})
            CheckpointManager(d / "port", keep_last=0).save(
                1, TrainState.create(model, build_optimizer(OptimConfig())))
        out[task] = (d, params, model)
    return root, out


def _both(capsys, argv_of):
    from wav2vec_s_tpu.eval import cli as jax_eval_cli

    jax_eval_cli.main(argv_of("jax"))
    want = capsys.readouterr().out
    eval_cli.main(argv_of("port") + ["--device", "cpu"])
    got = capsys.readouterr().out
    return got, want


#: the JAX CLI's validation loss runs the model in training mode (the
#: port's in eval mode): every random site off
NO_DROPOUT = {"run.final_dropout": 0.0, "model.dropout": 0.0,
              "model.attention_dropout": 0.0,
              "model.activation_dropout": 0.0, "caat.dropout": 0.0,
              "caat.attention_dropout": 0.0, "caat.activation_dropout": 0.0,
              "caat.rand_pos_decoder": 0}


def _recording(manager, saved):
    """``manager`` whose ``save`` also appends (step, metric) to
    ``saved``."""
    class Recording(manager):
        def save(self, step, state, extra=None, metric=None):
            saved.append((step, metric))
            return super().save(step, state, extra, metric)

    return Recording


def _identity_step(loss_fn, optimizer, **kw):
    """A JAX train step that changes nothing but the step count."""
    def step(state, batch, rng):
        return state.replace(step=state.step + 1), {
            "loss_total": jnp.zeros(()), "sample_size": jnp.ones(())}
    return step


@pytest.mark.parametrize("task", sorted(TASKS))
def test_cli_validation_equals_jax_cli(eval_dirs, tmp_path, monkeypatch,
                                       task):
    """Each CLI validating on the same weights and batches: the JAX CLI
    from the seeded tree (``init_params`` returns it; its update is the
    identity), the port's from that tree converted and saved at update 0
    (learning rate 0), every dropout off (``NO_DROPOUT``); one update, a
    validation and a checkpoint: the validation records (loss within the
    4-decimal rounding, WER / BLEU / accuracy equal) and the best metric
    that each CLI hands its checkpoint manager."""
    from wav2vec_s_tpu.train import cli as jax_cli

    root, dirs = eval_dirs
    head = "s2s" if task.startswith("s2s") else task
    d, params, model = dirs[head]
    build = "build_" + head
    real = getattr(jax_cli, build)

    def built(cfg):
        *rest, _ = real(cfg)
        return (*rest, lambda batch: params)

    monkeypatch.setattr(jax_cli, build, built)
    monkeypatch.setattr(jax_cli, "make_train_step", _identity_step)
    metrics = {}
    for pkg, module in (("jax", jax_cli), ("port", cli)):
        monkeypatch.setattr(module, "CheckpointManager",
                            _recording(module.CheckpointManager,
                                       metrics.setdefault(pkg, [])))
    CheckpointManager(tmp_path / "port", keep_last=0).save(
        0, TrainState.create(model, build_optimizer(OptimConfig())))
    argv = {k: v for k, v in TASKS[task].items() if k != "data.vocab"}
    argv.update({
        "run.max_update": 1, "run.log_interval": 1,
        "run.validate_interval_updates": 1, "run.save_interval_updates": 1,
        "data.train_manifest": root / "dev.tsv",
        "data.valid_manifest": root / "dev.tsv", "data.max_tokens": 100000,
        "optim.lr": 0.0, **NO_DROPOUT})
    yaml = d / ("ctc.yaml" if head == "ctc" else "caat.yaml")

    def args(pkg):
        return [f"run.save_dir={tmp_path / pkg}"] + [
            f"{k}={v}" for k, v in argv.items()]

    want = _main(jax_cli.main, ["--platform", "cpu", "--config", str(yaml),
                                "run.num_devices=1", *args("jax")])
    got = _main(cli.main, ["--device", "cpu", "--config", str(yaml),
                           *args("port")])
    (v_want,) = [r for r in want if r["tag"] == "valid"]
    (v_got,) = [r for r in got if r["tag"] == "valid"]
    assert v_got.keys() == v_want.keys()
    np.testing.assert_allclose(v_got["valid_loss"], v_want["valid_loss"],
                               rtol=1e-5, atol=1e-4)
    for k in v_want.keys() - {"valid_loss"}:
        assert v_got[k] == v_want[k], k
    if task in ("s2s", "s2s_accuracy"):
        assert v_got["valid_accuracy"] > 0
    if task == "s2s":
        assert v_got["valid_bleu"] > 0
    # the save after the validation, then the final one (no metric)
    assert [s for s, _ in metrics["port"]] == [s for s, _ in
                                               metrics["jax"]] == [1, 1]
    (_, m_jax), (_, m_port) = metrics["jax"][0], metrics["port"][0]
    np.testing.assert_allclose(m_port, m_jax, rtol=1e-5)
    np.testing.assert_allclose(m_port, _metric(task, v_got), atol=1e-4)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_ctc_decode_equals_jax_cli(eval_dirs, capsys, batch_size):
    root, dirs = eval_dirs
    d = dirs["ctc"][0]
    got, want = _both(capsys, lambda pkg: [
        "ctc-decode", "--config", str(d / "ctc.yaml"), "--ckpt-dir",
        str(d / pkg), "--manifest", str(root / "dev.tsv"), "--batch-size",
        str(batch_size)])
    assert got == want
    lines = [json.loads(ln) for ln in got.splitlines()]
    assert len(lines) == 5 and "WER" in lines[-1]
    assert any(ln["hypo"] for ln in lines[:-1])


def test_generate_equals_jax_cli(eval_dirs, capsys):
    """One utterance (the JAX engine compiles for ~9 s)."""
    root, dirs = eval_dirs
    d = dirs["caat"][0]
    got, want = _both(capsys, lambda pkg: [
        "generate", "--config", str(d / "caat.yaml"), "--ckpt-dir",
        str(d / pkg), "--manifest", str(root / "dev.tsv"), "--metric",
        "wer", "--intra-beam", "3", "--max-instances", "1"])
    assert got == want
    lines = [json.loads(ln) for ln in got.splitlines()]
    assert len(lines) == 2 and lines[-1]["n"] == 1 and "WER" in lines[-1]
    assert all(0 < len(ln["hypo"].split()) < 16 for ln in lines[:-1])
