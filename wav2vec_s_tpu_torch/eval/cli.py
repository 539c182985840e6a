"""Evaluation CLI (port of ``wav2vec_s_tpu/eval/cli.py``).

Subcommands re-providing the reference's eval entry points:

- ``average``  ~ fairseq/scripts/average_checkpoints.py: the average of the
  last K checkpoints of a directory, written as an ``.npz`` keyed by the
  fairseq/rain parameter names
- ``simul``    ~ the SimulEval harness run (simuleval CLI): streaming decode
  by the agent with AL/AP/DAL + quality, in-process
- ``generate`` ~ fairseq-generate (fairseq_cli/generate.py): offline CAAT
  transducer decode of each utterance (one streaming search over the whole
  wav) + BLEU / WER
- ``ctc-decode`` ~ fairseq's argmax WER eval for ``Wav2VecCtc``
  checkpoints trained with ``run.task: ctc``: length-sorted batches
- ``interactive`` ~ fairseq-interactive: words printed as they are emitted
- ``eval-lm``  ~ fairseq-eval-lm: perplexity of the decoupled CAAT decoder
  as a language model
- ``batch-decode`` ~ batched decode of a corpus by one of the port's
  decoders, quality + AL + throughput
- ``sweep``    ~ the eval scripts' DECISION_STEP loop: one batch-decode
  per operating point
- ``score``    ~ fairseq-score: BLEU/WER of a system file against a
  reference file

A checkpoint of the fbank family (``data.features=fbank``) decodes through
``simul`` and ``interactive`` (``FbankStreamingEngine`` under the same
agent), as in the JAX CLI; the other decoding subcommands run the raw-audio
CAAT model only, and the text family has no eval-CLI path: both raise.

What differs from the JAX CLI: ``--device cuda|cpu`` (default ``cuda``,
which raises without a card) takes the place of ``--platform``;
``--config`` is optional (the dot-overrides alone can describe the run, and
PyYAML is imported only for a ``--config``); checkpoints are the port's
(``checkpoint/io.py``).

Usage:
  python -m wav2vec_s_tpu_torch.eval.cli batch-decode --ckpt-dir D \\
      --manifest dev.tsv --decoder cached data.vocab=dict.txt \\
      model.dtype=bfloat16 caat.dtype=bfloat16
  python -m wav2vec_s_tpu_torch.eval.cli simul --config train.yaml \\
      --ckpt-dir D --manifest dev.tsv [--step-read-blocks 2] [--metric wer]
  python -m wav2vec_s_tpu_torch.eval.cli average --ckpt-dir D --k 5 \\
      --out avg.npz
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from wav2vec_s_tpu_torch.checkpoint.io import load_params
from wav2vec_s_tpu_torch.train.config import load_config

def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(give --device cpu to run on the host)")
    return dev


def _check_features(cfg, args, want: str = "raw") -> None:
    """Raise unless the configuration's ``data.features`` is ``want``."""
    if cfg.data.features != want:
        raise ValueError(
            f"data.features={cfg.data.features}: eval.cli {args.cmd} decodes "
            f"{want} audio; the fbank family decodes through 'simul' and "
            f"'interactive', and the text family has no eval-CLI path (its "
            f"agent is models/text_caat.TextTransducerAgent), as in the JAX "
            f"package")


def _build_caat(cfg, args, fbank: bool = False):
    """(model on ``--device`` with the checkpoint's weights, tgt_dict,
    model_cfg, caat_cfg) of a raw-audio CAAT configuration, or with
    ``fbank`` of the fbank family's (the agent's two families)."""
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary
    from wav2vec_s_tpu_torch.models.caat import W2V2CaatModel
    from wav2vec_s_tpu_torch.models.fbank import FbankCaatModel
    from wav2vec_s_tpu_torch.train.cli import caat_configs

    _check_features(cfg, args, "fbank" if fbank else "raw")
    device = _device(args)
    tgt_dict = Dictionary.load(cfg.data.vocab)
    model_cfg, caat_cfg = caat_configs(cfg, len(tgt_dict))
    params = load_params(args.ckpt_dir, args.average_k)
    with device:
        model = (FbankCaatModel if fbank else W2V2CaatModel)(model_cfg,
                                                             caat_cfg)
    model.load_state_dict(params, strict=True)
    return model.eval(), tgt_dict, model_cfg, caat_cfg


def _tokenizer(cfg):
    from wav2vec_s_tpu_torch.data.tokenizer import build_tokenizer

    if cfg.data.tokenizer == "word":
        return None
    return build_tokenizer(cfg.data.tokenizer, cfg.data.spm_model or None)


def _corpus(args, cfg):
    """(wavs, refs) of the first ``--max-instances`` rows of the manifest."""
    from wav2vec_s_tpu_torch.data.audio import read_audio
    from wav2vec_s_tpu_torch.data.manifests import read_s2t_manifest

    man = read_s2t_manifest(args.manifest, cfg.data.audio_root)
    n = min(len(man.ids), args.max_instances or len(man.ids))
    wavs = [read_audio(man.audio_paths[i]) for i in range(n)]
    refs = [man.tgt_texts[i] if args.metric == "bleu"
            else (man.src_texts[i] or man.tgt_texts[i]) for i in range(n)]
    return wavs, refs


def cmd_average(args):
    params = load_params(args.ckpt_dir, args.k)
    np.savez(args.out, **{k: v.detach().cpu().numpy()
                          for k, v in params.items()})
    print(f"averaged {args.k} checkpoints -> {args.out} "
          f"({len(params)} tensors)", file=sys.stderr)


def _agent_factory(args, cfg):
    """A factory of fresh ``SpeechTransducerAgent``s over one searcher: raw
    audio through ``StreamingEngine`` (320 samples per frame), or an fbank
    checkpoint through ``FbankStreamingEngine``, the chunked carry-over
    featurizer (rain TransducerAgent / OnlineSpeechModels,
    transducer_agent.py:170-614; 160 samples per feature frame times the
    front-end's subsampling)."""
    from wav2vec_s_tpu_torch.stream.agent import (
        AgentConfig, SpeechTransducerAgent)
    from wav2vec_s_tpu_torch.stream.engine import StreamingEngine
    from wav2vec_s_tpu_torch.stream.fbank_engine import FbankStreamingEngine
    from wav2vec_s_tpu_torch.stream.searcher import (
        StreamingTransducerSearcher)

    fbank = cfg.data.features == "fbank"
    model, tgt_dict, model_cfg, caat_cfg = _build_caat(cfg, args, fbank)
    ctx = dict(main_context=cfg.context.main_context,
               right_context=cfg.context.right_context)
    if fbank:
        engine = FbankStreamingEngine(model, **ctx)
        frame_samples = 160 * engine.subsample
    else:
        engine = StreamingEngine(model, **ctx)
        frame_samples = 320
    searcher = StreamingTransducerSearcher(
        engine, tgt_dict, _tokenizer(cfg),
        len_scale=args.len_scale, eager=args.eager)
    agent_cfg = AgentConfig(
        main_context=cfg.context.main_context,
        right_context=cfg.context.right_context,
        frame_samples=frame_samples,
        step_read_blocks=args.step_read_blocks,
        intra_beam=args.intra_beam, inter_beam=args.inter_beam,
        decoder_step_read=args.decoder_step_read, eager=args.eager,
        max_len_a=args.max_len_a, max_len_b=args.max_len_b,
        len_scale=args.len_scale)
    return lambda: SpeechTransducerAgent(searcher, agent_cfg)


def cmd_simul(args):
    from wav2vec_s_tpu_torch.stream.agent import SimulEvaluator

    cfg = load_config(args.config, args.overrides)
    wavs, refs = _corpus(args, cfg)
    factory = _agent_factory(args, cfg)
    ev = SimulEvaluator(factory, segment_size_ms=args.segment_size)
    scores = ev.evaluate(wavs, refs, metric=args.metric)
    print(json.dumps(scores))


def make_decoder(name, model, tgt_dict, model_cfg, args, t_cap):
    """The batch decoder ``--decoder name`` with the JAX CLI's arguments
    (eval/cli.py:185-212)."""
    from wav2vec_s_tpu_torch.stream.batched import (
        CachedFusedGreedyDecoder, OneShotCorpusDecoder)
    from wav2vec_s_tpu_torch.stream.beam_batched import (
        BatchedBeamStreamingDecoder, FusedBeamStreamingDecoder,
        FusedOneShotBeamDecoder, OneShotBeamDecoder)

    if name == "fused":
        raise NotImplementedError(
            "--decoder fused: the uncached ancestor decoders are on "
            "ROADMAP's 'Not to port' list; --decoder cached decodes the same "
            "emissions")
    greedy_kw = dict(max_emit_per_chunk=4 * args.step_read_blocks,
                     blocks_per_step=args.step_read_blocks, t_cap=t_cap)
    beam_kw = dict(beam_size=args.intra_beam, inter_beam=args.inter_beam,
                   gen_beam=args.gen_beam, eager=args.eager,
                   len_scale=args.len_scale, t_cap=t_cap,
                   blocks_per_step=args.step_read_blocks)
    cls, kw = {
        "cached": (CachedFusedGreedyDecoder, greedy_kw),
        "oneshot": (OneShotCorpusDecoder, greedy_kw),
        "beam": (BatchedBeamStreamingDecoder, beam_kw),
        "oneshot-beam": (OneShotBeamDecoder, beam_kw),
        # no host sync inside the decode; need inter_beam=1: fused-beam =
        # one-shot encode (corpus eval), stream-beam = incremental encode
        # (serving semantics)
        "fused-beam": (FusedOneShotBeamDecoder, beam_kw),
        "stream-beam": (FusedBeamStreamingDecoder, beam_kw),
    }[name]
    return cls(model, tgt_dict, model_cfg, **kw)


def _decode_report(args, cfg, model, tgt_dict, model_cfg, wavs, refs):
    from wav2vec_s_tpu_torch.eval.bleu import corpus_bleu
    from wav2vec_s_tpu_torch.eval.wer import corpus_wer
    from wav2vec_s_tpu_torch.models.feature_extractor import (
        conv_output_length)
    from wav2vec_s_tpu_torch.stream.latency import average_lagging

    n = len(wavs)
    frames = conv_output_length(max(len(w) for w in wavs),
                                model_cfg.conv_feature_layers)
    t_cap = -(-(frames + model_cfg.right_context) // 128) * 128
    dec = make_decoder(args.decoder, model, tgt_dict, model_cfg, args, t_cap)

    # length-sorted batches: similar lengths share padded shapes
    order = sorted(range(n), key=lambda i: -len(wavs[i]))
    bs = args.batch_size or n
    hyps = [None] * n
    delays = [None] * n
    t0 = time.time()
    for s in range(0, n, bs):
        rows = order[s:s + bs]
        th, td = dec.decode_corpus([wavs[i] for i in rows])
        for r, h, d in zip(rows, th, td):
            hyps[r], delays[r] = h, d
    dt = time.time() - t0
    audio_sec = sum(len(w) for w in wavs) / 16000.0
    al = [average_lagging(d, len(w) / 16.0, max(len(r.split()), 1))
          for d, w, r in zip(delays, wavs, refs) if d]
    quality = (corpus_bleu(hyps, refs) if args.metric == "bleu"
               else corpus_wer(hyps, refs))
    print(json.dumps({
        args.metric.upper(): quality,
        "AL": float(np.mean(al)) if al else 0.0,
        # four significant digits: a slow decode of a short corpus (a CPU
        # run) still reads above 0
        "audio_sec_per_sec": float(f"{audio_sec / dt:.4g}"),
        "n": n,
        "step_read_blocks": args.step_read_blocks,
    }))


def cmd_batch_decode(args):
    """Batched streaming decode of a corpus: the throughput path.

    ``--decoder`` picks the engine: ``cached`` streams through the O(T)
    incremental encoder (serving semantics); ``oneshot`` encodes each
    utterance once and replays the decision loop (corpus-eval fast path,
    the same emissions); ``beam``/``oneshot-beam``/``fused-beam``/
    ``stream-beam`` are the quality twins at ``--intra-beam``.  Utterances
    are length-sorted into ``--batch-size`` buckets; only the decode loop
    is timed."""
    cfg = load_config(args.config, args.overrides)
    model, tgt_dict, model_cfg, _ = _build_caat(cfg, args)
    wavs, refs = _corpus(args, cfg)
    _decode_report(args, cfg, model, tgt_dict, model_cfg, wavs, refs)


def cmd_sweep(args):
    """Quality@latency operating-point sweep: one batched decode per
    DECISION_STEP, one JSON line each (the reference's eval loop,
    wav2vec_s_scripts/eval/eval_wav2vec_s_caat_st.sh:3).  The model and
    the corpus are loaded once."""
    cfg = load_config(args.config, args.overrides)
    model, tgt_dict, model_cfg, _ = _build_caat(cfg, args)
    wavs, refs = _corpus(args, cfg)
    for srb in (int(s) for s in args.steps.split(",")):
        args.step_read_blocks = srb
        _decode_report(args, cfg, model, tgt_dict, model_cfg, wavs, refs)


def cmd_generate(args):
    """Offline CAAT decode of each utterance of the manifest (one streaming
    search over the whole wav, ``eval/generator.transducer_offline_decode``)
    + corpus BLEU / WER against its ``tgt_text``; one JSON line per
    utterance, then the score."""
    from wav2vec_s_tpu_torch.data.audio import read_audio
    from wav2vec_s_tpu_torch.data.manifests import read_s2t_manifest
    from wav2vec_s_tpu_torch.eval.bleu import corpus_bleu
    from wav2vec_s_tpu_torch.eval.generator import transducer_offline_decode
    from wav2vec_s_tpu_torch.eval.wer import corpus_wer
    from wav2vec_s_tpu_torch.stream.engine import StreamingEngine
    from wav2vec_s_tpu_torch.stream.searcher import (
        StreamingTransducerSearcher)

    cfg = load_config(args.config, args.overrides)
    model, tgt_dict, _, _ = _build_caat(cfg, args)
    engine = StreamingEngine(model, main_context=cfg.context.main_context,
                             right_context=cfg.context.right_context)
    searcher = StreamingTransducerSearcher(engine, tgt_dict,
                                           len_scale=args.len_scale)
    man = read_s2t_manifest(args.manifest, cfg.data.audio_root)
    n = min(len(man.ids), args.max_instances or len(man.ids))
    hyps, refs = [], []
    for i in range(n):
        wav = read_audio(man.audio_paths[i])
        hypo = transducer_offline_decode(searcher, wav,
                                         intra_beam=args.intra_beam)
        hyps.append(hypo)
        refs.append(man.tgt_texts[i])
        print(json.dumps({"id": man.ids[i], "hypo": hypo,
                          "ref": refs[-1]}))
    score = (corpus_bleu(hyps, refs) if args.metric == "bleu"
             else corpus_wer(hyps, refs))
    print(json.dumps({args.metric.upper(): score, "n": n}))


def cmd_ctc_decode(args):
    """Batched offline CTC decode + WER over a manifest: the eval side of
    the ``run.task: ctc`` fine-tune (fairseq's argmax WER path for
    Wav2VecCtc, wav2vec2_asr.py:154 + criterions/ctc.py; blank = bos).
    Utterances go in length-sorted batches of ``--batch-size``, each padded
    to the 640-multiple bucket of its longest wav; one JSON line per
    utterance, then the WER."""
    from wav2vec_s_tpu_torch.data.audio import instance_normalize, read_audio
    from wav2vec_s_tpu_torch.data.batching import bucket_for, length_buckets
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary
    from wav2vec_s_tpu_torch.data.manifests import read_s2t_manifest
    from wav2vec_s_tpu_torch.eval.generator import make_ctc_greedy_decoder
    from wav2vec_s_tpu_torch.eval.wer import corpus_wer
    from wav2vec_s_tpu_torch.models.asr import Wav2VecCtc
    from wav2vec_s_tpu_torch.stream.searcher import detok_pieces
    from wav2vec_s_tpu_torch.train.cli import encoder_config

    cfg = load_config(args.config, args.overrides)
    _check_features(cfg, args)
    device = _device(args)
    tgt_dict = Dictionary.load(cfg.data.vocab)
    params = load_params(args.ckpt_dir, args.average_k)
    with device:
        model = Wav2VecCtc(encoder_config(cfg), vocab_size=len(tgt_dict))
    model.load_state_dict(params, strict=True)
    decode = make_ctc_greedy_decoder(
        model, tgt_dict, cfg.context.main_context,
        cfg.context.right_context, blank=tgt_dict.bos())
    tokenizer = _tokenizer(cfg)

    man = read_s2t_manifest(args.manifest, cfg.data.audio_root)
    n = min(len(man.ids), args.max_instances or len(man.ids))
    order = sorted(range(n), key=lambda i: man.n_frames[i])
    buckets = length_buckets(int(max(man.n_frames[i] for i in order)),
                             multiple=640)
    hyps, refs = [None] * n, [None] * n
    for lo in range(0, n, args.batch_size):
        idx = order[lo:lo + args.batch_size]
        wavs = [read_audio(man.audio_paths[i]) for i in idx]
        if cfg.data.normalize:
            wavs = [instance_normalize(w) for w in wavs]
        S = bucket_for(max(len(w) for w in wavs), buckets)
        src = np.zeros((len(idx), S), np.float32)
        pad = np.ones((len(idx), S), bool)
        for r, w in enumerate(wavs):
            src[r, :len(w)] = w[:S]
            pad[r, :len(w)] = False
        pfx, lens = decode(torch.from_numpy(src), torch.from_numpy(pad))
        for r, i in enumerate(idx):
            hyps[i] = detok_pieces(tgt_dict, tokenizer, pfx[r, 1:lens[r]])
            refs[i] = man.src_texts[i] or man.tgt_texts[i]
            print(json.dumps({"id": man.ids[i], "hypo": hyps[i],
                              "ref": refs[i]}))
    print(json.dumps({"WER": corpus_wer(hyps, refs), "n": n}))


def cmd_interactive(args):
    """Interactive streaming decode (fairseq_cli/interactive.py twin).

    Reads one utterance per line from ``--input`` (default: stdin): a wav
    path, optionally followed by tab-separated fields, and decodes it with
    the streaming agent, printing words as they are emitted with the ms of
    audio consumed at emission:

        S-0   /path/utt.wav
        W-0   475.0   hello
        W-0   950.0   world
        H-0   hello world
    """
    from wav2vec_s_tpu_torch.data.audio import read_audio
    from wav2vec_s_tpu_torch.stream.agent import SAMPLES_PER_MS

    cfg = load_config(args.config, args.overrides)
    factory = _agent_factory(args, cfg)
    seg = args.segment_size * SAMPLES_PER_MS

    src = open(args.input) if args.input != "-" else sys.stdin
    try:
        for uid, line in enumerate(src):
            path = line.strip().split("\t")[0]
            if not path:
                continue
            print(f"S-{uid}\t{path}", flush=True)
            wav = read_audio(path)
            agent = factory()
            words, offset = [], 0
            while offset < len(wav):
                chunk = wav[offset:offset + seg]
                offset = min(offset + seg, len(wav))
                agent.push(chunk, is_end=(offset >= len(wav)))
                while True:
                    w = agent.pop_word()
                    if w is None:
                        break
                    words.append(w)
                    print(f"W-{uid}\t{offset / SAMPLES_PER_MS:.1f}\t{w}",
                          flush=True)
            print(f"H-{uid}\t{' '.join(words)}", flush=True)
    finally:
        if src is not sys.stdin:
            src.close()


def cmd_eval_lm(args):
    """Perplexity of the decoupled CAAT decoder as a language model
    (fairseq_cli/eval_lm.py twin for this framework's only LM surface).

    Scores each line of ``--text`` (tokenized with the configured
    tokenizer, eos-terminated) under ``W2V2CaatModel.lm_log_probs`` and
    reports summed NLL, loss in base 2, and perplexity.
    """
    cfg = load_config(args.config, args.overrides)
    model, tgt_dict, model_cfg, caat_cfg = _build_caat(cfg, args)
    tokenizer = _tokenizer(cfg)
    dev = next(model.parameters()).device

    def score(prev, tgt):
        lp = model.lm_log_probs(prev)
        nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
        keep = (tgt != caat_cfg.pad).float()
        return (nll * keep).sum(), keep.sum()

    with open(args.text) as fh:
        lines = [ln for ln in fh if ln.strip()]
    total_nll = total_tok = 0.0
    bs = args.batch_size or 32
    for s in range(0, len(lines), bs):
        chunk = lines[s:s + bs]
        toks = [tgt_dict.encode(
            tokenizer.encode(ln) if tokenizer else ln.split(),
            append_eos=True) for ln in chunk]
        # U padded to a multiple of 16, as the JAX CLI's bucket grid
        u_max = -(-max(len(t) for t in toks) // 16) * 16
        tgt = np.full((len(toks), u_max), caat_cfg.pad, np.int64)
        for i, t in enumerate(toks):
            tgt[i, :len(t)] = t
        prev = np.concatenate(
            [np.full((len(toks), 1), caat_cfg.bos, np.int64),
             tgt[:, :-1]], axis=1)
        nll, ntok = score(torch.from_numpy(prev).to(dev),
                          torch.from_numpy(tgt).to(dev))
        total_nll += float(nll)
        total_tok += float(ntok)
    loss = total_nll / max(total_tok, 1.0)
    print(json.dumps({
        "loss": round(loss, 4),
        "loss_base2": round(loss / math.log(2), 4),
        "perplexity": round(math.exp(loss), 4),
        "ntokens": int(total_tok),
        "nsentences": len(lines),
    }))


def cmd_score(args):
    """BLEU/WER of a system file vs a reference file — the fairseq-score
    twin (fairseq/fairseq_cli/score.py): ``--sys -`` reads stdin,
    ``--ignore-case`` lowercases both sides, ``--sentence-bleu`` prints
    per-line smoothed BLEU instead of the corpus score."""
    from wav2vec_s_tpu_torch.eval.bleu import corpus_bleu, sentence_bleu
    from wav2vec_s_tpu_torch.eval.wer import corpus_wer

    def read(path):
        if path == "-":
            lines = [ln.rstrip("\n") for ln in sys.stdin]
        else:
            with open(path) as fh:
                lines = [ln.rstrip("\n") for ln in fh]
        return [ln.lower() for ln in lines] if args.ignore_case else lines

    hyps, refs = read(args.sys), read(args.ref)
    if len(hyps) != len(refs):
        raise SystemExit(
            f"line count mismatch: sys={len(hyps)} ref={len(refs)}")
    if args.sentence_bleu:
        for i, (h, r) in enumerate(zip(hyps, refs)):
            print(json.dumps({"i": i, "BLEU": round(sentence_bleu(h, r), 2)}))
        return
    out = {"n": len(hyps)}
    if args.metric in ("bleu", "both"):
        out["BLEU"] = round(corpus_bleu(hyps, refs), 2)
    if args.metric in ("wer", "both"):
        out["WER"] = round(corpus_wer(hyps, refs), 4)
    print(json.dumps(out))


def main(argv=None):
    p = argparse.ArgumentParser("wav2vec_s_tpu_torch eval")
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("average")
    pa.add_argument("--ckpt-dir", required=True)
    pa.add_argument("--k", type=int, default=5)
    pa.add_argument("--out", required=True)

    def common(sp, manifest=True):
        sp.add_argument("--config", default=None)
        sp.add_argument("--ckpt-dir", required=True)
        sp.add_argument("--manifest", required=manifest)
        sp.add_argument("--average-k", type=int, default=0)
        sp.add_argument("--metric", default="bleu", choices=["bleu", "wer"])
        sp.add_argument("--intra-beam", type=int, default=5)
        sp.add_argument("--inter-beam", type=int, default=1)
        sp.add_argument("--gen-beam", type=float, default=2.0)
        sp.add_argument("--step-read-blocks", type=int, default=2)
        sp.add_argument("--decoder-step-read", type=int, default=256)
        sp.add_argument("--segment-size", type=int, default=25)
        sp.add_argument("--eager", action="store_true", default=True)
        sp.add_argument("--len-scale", type=float, default=0.7)
        sp.add_argument("--max-len-a", type=float, default=0.048)
        sp.add_argument("--max-len-b", type=float, default=-5.0)
        sp.add_argument("--max-instances", type=int, default=0)
        sp.add_argument("--device", default="cuda",
                        help="torch device (cpu for testing)")
        sp.add_argument("--decoder", default="cached",
                        choices=["fused", "cached", "oneshot", "beam",
                                 "oneshot-beam", "fused-beam",
                                 "stream-beam"])
        sp.add_argument("--batch-size", type=int, default=128)
        sp.add_argument("overrides", nargs="*", default=[])

    ps = sub.add_parser("simul")
    common(ps)
    pg = sub.add_parser("generate")
    common(pg)
    pb = sub.add_parser("batch-decode")
    common(pb)
    pc = sub.add_parser("ctc-decode")
    common(pc)
    psw = sub.add_parser("sweep")
    common(psw)
    psw.add_argument("--steps", default="2,4,10,20",
                     help="comma list of DECISION_STEP operating points")

    pi = sub.add_parser("interactive")
    common(pi, manifest=False)
    pi.add_argument("--input", default="-",
                    help="file of wav paths, one per line ('-' = stdin)")
    pl = sub.add_parser("eval-lm")
    common(pl, manifest=False)
    pl.add_argument("--text", required=True,
                    help="plain-text file to score, one sentence per line")

    px = sub.add_parser("score")
    px.add_argument("-s", "--sys", default="-", help="system output file "
                    "('-' = stdin)")
    px.add_argument("-r", "--ref", required=True, help="reference file")
    px.add_argument("--metric", default="bleu",
                    choices=["bleu", "wer", "both"])
    px.add_argument("--ignore-case", action="store_true")
    px.add_argument("--sentence-bleu", action="store_true",
                    help="per-line smoothed BLEU instead of corpus BLEU")

    args = p.parse_args(list(argv) if argv is not None else None)
    if hasattr(args, "device"):
        _device(args)                    # raise at once without a card
    {"average": cmd_average, "simul": cmd_simul,
     "generate": cmd_generate, "interactive": cmd_interactive,
     "eval-lm": cmd_eval_lm, "ctc-decode": cmd_ctc_decode,
     "batch-decode": cmd_batch_decode, "sweep": cmd_sweep,
     "score": cmd_score}[args.cmd](args)


if __name__ == "__main__":
    main()
