"""``python -m wav2vec_s_tpu_torch.eval.cli`` on a checkpoint written by the
port's ``CheckpointManager``, every subcommand with ``--device cpu``.

- ``batch-decode`` under each of the six ``--decoder`` choices, and
  ``sweep``, print the BLEU / WER and AL of the texts and delays that the
  port's decoder gives when it is called directly on the same
  length-sorted batches (equal);
- ``simul`` prints the scores of the port's ``SimulEvaluator`` (equal, but
  for the wall-clock AL_CA); ``interactive`` prints the ``S-``/``W-``/``H-``
  lines of the same agent;
- ``score`` prints what the JAX package's ``cmd_score`` prints on the same
  files; ``average`` of two checkpoints writes their mean; ``eval-lm``
  equals the NLL summed by hand over ``W2V2CaatModel.lm_log_probs``, which
  equals the JAX model's (1e-5);
- ``--decoder fused`` raises ``NotImplementedError`` naming its ROADMAP
  list, ``batch-decode`` of an fbank configuration a ``ValueError`` that
  names the subcommands which decode it, and ``simul`` of an fbank
  configuration over this raw-audio checkpoint the strict load's error
  (the fbank and text paths are held in
  ``test_torch_port_family_cli.py``); ``--device cuda
  raises without a card (``generate`` and ``ctc-decode`` are held against
  the JAX CLI in ``test_torch_port_asr_cli.py``).

The model is the tiny one of ``test_torch_port_serving.py`` (its weights
emit on these clips); the configuration is given by dot-overrides alone.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_serving import models
from wav2vec_s_tpu_torch.checkpoint.io import (
    CheckpointManager, average_last_checkpoints, load_params)
from wav2vec_s_tpu_torch.data.audio import write_wav
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.eval import cli
from wav2vec_s_tpu_torch.eval.bleu import corpus_bleu
from wav2vec_s_tpu_torch.eval.wer import corpus_wer
from wav2vec_s_tpu_torch.models.caat import W2V2CaatModel
from wav2vec_s_tpu_torch.stream import agent as port_agent
from wav2vec_s_tpu_torch.stream.batched import (
    CachedFusedGreedyDecoder, OneShotCorpusDecoder)
from wav2vec_s_tpu_torch.stream.beam_batched import (
    BatchedBeamStreamingDecoder, FusedBeamStreamingDecoder,
    FusedOneShotBeamDecoder, OneShotBeamDecoder)
from wav2vec_s_tpu_torch.stream.engine import StreamingEngine
from wav2vec_s_tpu_torch.stream.latency import average_lagging
from wav2vec_s_tpu_torch.stream.searcher import StreamingTransducerSearcher
from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
from wav2vec_s_tpu_torch.train.step import TrainState

LENGTHS = (1300, 900, 1100, 700)
BATCH = 3                                     # batches of 3 and 1
TEXTS = ["w5 w22 w5", "w22 w3", "w1 w2 w22 w22", "w5"]


def _overrides():
    ov = {"context.main_context": W2V_TINY.main_context,
          "context.right_context": W2V_TINY.right_context,
          "model.conv_feature_layers": "((16,10,5),(16,3,2),(16,2,2))"}
    for f in ("encoder_layers", "encoder_embed_dim", "encoder_ffn_embed_dim",
              "encoder_attention_heads", "final_dim", "encoder_layerdrop",
              "feature_grad_mult"):
        ov[f"model.{f}"] = getattr(W2V_TINY, f)
    for f in ("decoder_layers", "decoder_embed_dim", "decoder_ffn_embed_dim",
              "decoder_attention_heads", "jointer_layers",
              "jointer_embed_dim", "jointer_ffn_embed_dim",
              "jointer_attention_heads", "transducer_downsample",
              "tokens_per_step", "dropout", "attention_dropout",
              "activation_dropout"):
        ov[f"caat.{f}"] = getattr(CAAT_TINY, f)
    return ov


def _save(mgr, step, model):
    state = TrainState.create(model, build_optimizer(OptimConfig()))
    mgr.save(step, state)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Checkpoints (step 1: perturbed weights, step 2: the test model),
    wavs, a tsv, a dict, a text file; -> (root, base argv, model)."""
    root = tmp_path_factory.mktemp("eval_cli")
    model = models()[2]
    other = W2V2CaatModel(model.w2v_cfg, model.cfg)
    other.load_state_dict(model.state_dict())
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in other.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=g))
    mgr = CheckpointManager(root / "ckpt", keep_last=0)
    _save(mgr, 1, other)
    _save(mgr, 2, model)

    vocab = Dictionary()
    words = [f"w{i}" for i in range(CAAT_TINY.vocab_size - vocab.nspecial)]
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    rng = np.random.default_rng(11)
    lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
    for i, (n, text) in enumerate(zip(LENGTHS, TEXTS)):
        write_wav(root / f"utt{i}.wav",
                  rng.standard_normal(n).astype(np.float32) * 0.3)
        lines.append(f"utt{i}\t{root}/utt{i}.wav\t{n}\t{text}\t{text}")
    (root / "dev.tsv").write_text("\n".join(lines) + "\n")
    (root / "lm.txt").write_text("w1 w2 w3\n\nw22 w5 w5 w22 w7\nw9\n")
    ov = dict(_overrides(), **{"data.vocab": root / "dict.txt"})
    base = ["--ckpt-dir", str(root / "ckpt"), "--device", "cpu"]
    return root, base, [f"{k}={v}" for k, v in ov.items()]


def _json_lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _corpus_audio(root):
    from wav2vec_s_tpu_torch.data.audio import read_audio

    return [read_audio(root / f"utt{i}.wav") for i in range(len(LENGTHS))]


DECODERS = {"cached": CachedFusedGreedyDecoder,
            "oneshot": OneShotCorpusDecoder,
            "beam": BatchedBeamStreamingDecoder,
            "oneshot-beam": OneShotBeamDecoder,
            "fused-beam": FusedOneShotBeamDecoder,
            "stream-beam": FusedBeamStreamingDecoder}


def _direct(root, name, srb, metric):
    """The decoder called directly with the JAX CLI's arguments on the
    length-sorted batches -> the CLI's JSON line but for the timing."""
    model, wavs = models()[2], _corpus_audio(root)
    vocab = Dictionary.load(root / "dict.txt")
    t_cap = 128            # 1300 samples: 64 frames + rc 2, rounded up
    if name in ("cached", "oneshot"):
        kw = dict(max_emit_per_chunk=4 * srb, blocks_per_step=srb,
                  t_cap=t_cap)
    else:
        kw = dict(beam_size=5, inter_beam=1, gen_beam=2.0, eager=True,
                  len_scale=0.7, t_cap=t_cap, blocks_per_step=srb)
    dec = DECODERS[name](model, vocab, model.w2v_cfg, **kw)
    order = sorted(range(len(wavs)), key=lambda i: -len(wavs[i]))
    hyps, delays = [None] * len(wavs), [None] * len(wavs)
    for s in range(0, len(wavs), BATCH):
        rows = order[s:s + BATCH]
        texts, dels = dec.decode_corpus([wavs[i] for i in rows])
        for r, t, d in zip(rows, texts, dels):
            hyps[r], delays[r] = t, d
    al = [average_lagging(d, len(w) / 16.0, max(len(r.split()), 1))
          for d, w, r in zip(delays, wavs, TEXTS) if d]
    score = corpus_bleu if metric == "bleu" else corpus_wer
    return {metric.upper(): score(hyps, TEXTS),
            "AL": float(np.mean(al)) if al else 0.0,
            "n": len(wavs), "step_read_blocks": srb}, hyps


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_batch_decode_equals_direct_decode(corpus, capsys, decoder):
    root, base, ov = corpus
    metric = "wer" if decoder.endswith("beam") else "bleu"
    cli.main(["batch-decode", *base, "--manifest", str(root / "dev.tsv"),
              "--decoder", decoder, "--batch-size", str(BATCH), "--metric",
              metric, *ov])
    (got,) = _json_lines(capsys)
    assert got.pop("audio_sec_per_sec") > 0
    want, hyps = _direct(root, decoder, 2, metric)
    assert got == want
    assert any(hyps), "the decoder emitted nothing"


def test_sweep_equals_direct_decodes(corpus, capsys):
    root, base, ov = corpus
    cli.main(["sweep", *base, "--manifest", str(root / "dev.tsv"),
              "--steps", "1,2", "--batch-size", str(BATCH), *ov])
    got = _json_lines(capsys)
    assert [g["step_read_blocks"] for g in got] == [1, 2]
    for g, srb in zip(got, (1, 2)):
        g.pop("audio_sec_per_sec")
        assert g == _direct(root, "cached", srb, "bleu")[0]


def _agent_factory(root, srb=2):
    """The CLI's agent (its defaults), built directly."""
    model = models()[2]
    searcher = StreamingTransducerSearcher(
        StreamingEngine(model, main_context=W2V_TINY.main_context,
                        right_context=W2V_TINY.right_context),
        Dictionary.load(root / "dict.txt"), len_scale=0.7, eager=True)
    cfg = port_agent.AgentConfig(
        main_context=W2V_TINY.main_context,
        right_context=W2V_TINY.right_context, frame_samples=320,
        step_read_blocks=srb, intra_beam=5, inter_beam=1,
        decoder_step_read=256, eager=True, max_len_a=0.048, max_len_b=-5.0,
        len_scale=0.7)
    return lambda: port_agent.SpeechTransducerAgent(searcher, cfg)


def test_simul_equals_simul_evaluator(corpus, capsys):
    root, base, ov = corpus
    cli.main(["simul", *base, "--manifest", str(root / "dev.tsv"),
              "--max-instances", "2", "--metric", "wer", *ov])
    (got,) = _json_lines(capsys)
    ev = port_agent.SimulEvaluator(_agent_factory(root), segment_size_ms=25)
    want = ev.evaluate(_corpus_audio(root)[:2], TEXTS[:2], metric="wer")
    got.pop("AL_CA"), want.pop("AL_CA")
    assert got == want and got["num_instances"] == 2


def test_interactive_prints_words_as_emitted(corpus, capsys):
    root, base, ov = corpus
    (root / "inputs.txt").write_text(
        f"{root}/utt0.wav\textra\n\n{root}/utt2.wav\n")
    cli.main(["interactive", *base, "--input", str(root / "inputs.txt"),
              *ov])
    out = capsys.readouterr().out.splitlines()
    ev = port_agent.SimulEvaluator(_agent_factory(root), segment_size_ms=25)
    wavs = _corpus_audio(root)
    for uid, clip in ((0, 0), (2, 2)):       # line 1 is blank: skipped
        lines = [ln.split("\t") for ln in out
                 if ln.split("\t")[0][2:] == str(uid)]
        assert lines[0] == [f"S-{uid}", f"{root}/utt{clip}.wav"]
        want = ev.run_instance(wavs[clip], TEXTS[clip])
        words = [ln for ln in lines if ln[0] == f"W-{uid}"]
        assert [w[2] for w in words] == want.hypo.split()
        assert [w[1] for w in words] == [f"{d:.1f}" for d in want.delays_ms]
        assert lines[-1] == [f"H-{uid}", want.hypo]
    assert any(ln.startswith("W-") for ln in out)


@pytest.mark.parametrize("flags", [["--metric", "both"],
                                   ["--sentence-bleu"],
                                   ["--metric", "bleu", "--ignore-case"]])
def test_score_equals_jax(tmp_path, capsys, flags):
    from wav2vec_s_tpu.eval import cli as jax_cli

    (tmp_path / "sys.txt").write_text(
        "The cat sat on the mat\nhello World\n\na b c d e\n")
    (tmp_path / "ref.txt").write_text(
        "the cat sat on a mat\nhello world\nnothing\na b c d\n")
    argv = ["score", "-s", str(tmp_path / "sys.txt"), "-r",
            str(tmp_path / "ref.txt"), *flags]
    cli.main(argv)
    got = capsys.readouterr().out
    jax_cli.main(argv)
    assert got == capsys.readouterr().out
    assert got.strip()


def test_average_writes_the_mean(corpus, tmp_path):
    root, _, _ = corpus
    cli.main(["average", "--ckpt-dir", str(root / "ckpt"), "--k", "2",
              "--out", str(tmp_path / "avg.npz")])
    avg = np.load(tmp_path / "avg.npz")
    mgr = CheckpointManager(root / "ckpt", keep_last=0)
    a, b = (mgr.restore(s)[0]["model"] for s in (1, 2))
    assert sorted(avg.files) == sorted(a)
    for k in a:
        want = ((a[k].double() + b[k].double()) / 2).to(a[k].dtype)
        np.testing.assert_array_equal(avg[k], want.numpy(), err_msg=k)
    assert not np.array_equal(avg["decoder.lm.layers.0.fc1.weight"],
                              b["decoder.lm.layers.0.fc1.weight"].numpy())


@pytest.mark.parametrize("read", [lambda d: load_params(d),
                                  lambda d: load_params(d, 2),
                                  lambda d: average_last_checkpoints(d, 2)],
                         ids=["latest", "average_k", "average_last"])
def test_reading_a_missing_directory_leaves_it_absent(tmp_path, read):
    missing = tmp_path / "no" / "ckpt"
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        read(missing)
    assert not (tmp_path / "no").exists()


def test_eval_lm_equals_direct_nll(corpus, capsys):
    import jax.numpy as jnp

    root, base, ov = corpus
    cli.main(["eval-lm", *base, "--text", str(root / "lm.txt"),
              "--batch-size", "2", *ov])
    (got,) = _json_lines(capsys)
    jax_model, params, model = models()
    vocab = Dictionary.load(root / "dict.txt")
    nll = n_tok = 0.0
    sentences = [ln for ln in (root / "lm.txt").read_text().splitlines()
                 if ln.strip()]
    for ln in sentences:
        tgt = vocab.encode(ln.split(), append_eos=True)
        prev = torch.tensor([[vocab.bos()] + tgt[:-1]])
        lp = model.lm_log_probs(prev)[0]
        want_lp = jax_model.apply({"params": params}, jnp.asarray(prev.numpy()),
                                  method=type(jax_model).lm_log_probs)[0]
        np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp),
                                   atol=1e-5)
        nll -= float(lp[torch.arange(len(tgt)), torch.tensor(tgt)].sum())
        n_tok += len(tgt)
    loss = nll / n_tok
    assert got["ntokens"] == n_tok and got["nsentences"] == len(sentences)
    assert got["loss"] == pytest.approx(round(loss, 4), abs=1e-4)
    assert got["perplexity"] == pytest.approx(np.exp(loss), rel=1e-3)


RAISES = {
    "fused": (["batch-decode", "--manifest", "{tsv}", "--decoder", "fused"],
              NotImplementedError, "Not to port"),
    # the fbank family decodes through simul / interactive alone
    "fbank_batch_decode": (["batch-decode", "--manifest", "{tsv}",
                            "data.features=fbank"], ValueError,
                           "'simul' and 'interactive'"),
    # an fbank configuration over this raw-audio checkpoint: the strict
    # load refuses it
    "fbank_simul": (["simul", "--manifest", "{tsv}", "data.features=fbank"],
                    RuntimeError, "Missing key"),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_unported_paths_raise_naming_their_item(corpus, case):
    root, base, ov = corpus
    argv, exc, match = RAISES[case]
    argv = [a.replace("{tsv}", str(root / "dev.tsv")) for a in argv]
    with pytest.raises(exc, match=match):
        cli.main([argv[0], *base, *argv[1:], *ov])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_device_cuda_raises_without_a_card(corpus):
    root, base, ov = corpus
    base = [a if a != "cpu" else "cuda" for a in base]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["batch-decode", *base, "--manifest", str(root / "dev.tsv"),
                  *ov])
