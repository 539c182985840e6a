"""Corpus decoding: corpora of equal-length streams decoded back to back.

Traffic keys: ``decoder`` (``cached``: ``CachedFusedGreedyDecoder``, the
streaming agent; ``oneshot``: ``OneShotCorpusDecoder``), ``streams``,
``stream_seconds``, ``blocks_per_step``, ``max_len``,
``max_emit_per_chunk``, ``t_cap``, ``encode_batch`` (one-shot), ``model_overrides`` (program options of the
model, e.g. ``attention_impl``), ``pool_streams`` (distinct seeded noise
streams a corpus draws its rows from), ``amplitude``, ``trace_corpora``
(corpora in the profiled slice of the device metrics; one more is profiled
with the host's operators for the breakdown), ``check_streams`` (streams
of the last corpus whose decisions the reference scores: the widest logit
gap), ``enc_streams`` (streams of the last corpus whose encoder output
and last log-probs it compares).

The window stages corpus k + 1 on a helper thread while corpus k decodes,
and ends with the corpus during which ``--seconds`` ran out:
``decode_audio_s_per_s`` is the audio of every corpus decoded over the
wall time of all of them.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from w2vs_bench import served as sv
from w2vs_bench import work
from w2vs_bench.model import (SEED_MASK, build_program_model, make_vocab,
                              make_weights, reference_module)
from w2vs_bench.trace import Slice, Tracer

AUDIO_SALT = 0x5EED_A0D10


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cell.config
        self.tr = ctx.cell.traffic
        self.tracer = Tracer(ctx.trace)
        self.on_card = ctx.device.type == "cuda"
        self.decoded = []            # (corpus k, pool rows, texts, delays)
        self.corpus_s = []           # (wall s, main thread's CPU s) each

    # -- set-up -------------------------------------------------------------
    def setup(self):
        from wav2vec_s_tpu_torch.stream.batched import (
            CachedFusedGreedyDecoder, OneShotCorpusDecoder)

        t, ctx = self.tr, self.ctx
        model, w2v, caat = build_program_model(
            self.cfg, ctx.seed, ctx.device, t.get("model_overrides"))
        self.vocab = make_vocab(caat.vocab_size)
        cls = {"cached": CachedFusedGreedyDecoder,
               "oneshot": OneShotCorpusDecoder}[t["decoder"]]
        dec = cls(model, self.vocab, w2v, max_len=t["max_len"],
                  max_emit_per_chunk=t["max_emit_per_chunk"],
                  t_cap=t["t_cap"], blocks_per_step=t["blocks_per_step"])
        dec.transfer_dtype = "int16"          # the SimulEval server's wire
        if "encode_batch" in t:
            dec.encode_batch = t["encode_batch"]
        del model
        self.dec = dec
        enc = dec._encoder(t["streams"])
        self._hook_outputs(dec, enc)
        self.geo = (enc.rf, enc.hop, enc.rc, enc.n_main, enc.window)
        self.n_samples = int(round(t["stream_seconds"] * 16000))
        gen = torch.Generator(device=ctx.device).manual_seed(
            (ctx.seed ^ AUDIO_SALT) & SEED_MASK)
        pool = torch.randn((t["pool_streams"], self.n_samples), generator=gen,
                           device=ctx.device) * (t["amplitude"] * 32768.0)
        self.pool = pool.round().clamp(-32768, 32767).to(torch.int16).cpu(
            ).numpy()
        self.stager = ThreadPoolExecutor(max_workers=1)
        dec.decode_corpus(dec.stage(self._corpus(-1)[1]))      # warm-up
        if self.on_card:
            torch.cuda.synchronize()

    def _hook_outputs(self, dec, enc):
        """Keep references to what the timed path produced last: the
        encoder output of the latest corpus (the streaming state's output
        cache, or the one-shot encoder's outputs) and the jointer's latest
        log-probs.  The hooks hold references only: no device work."""
        from wav2vec_s_tpu_torch.stream import caat_step

        self.enc_out, self.last_lp, self._sub = None, None, []
        if self.tr["decoder"] == "cached":
            init = enc.init

            def keep_state():
                self.enc_out = None          # the old state goes first
                self.enc_out = init()
                return self.enc_out
            enc.init = keep_state
        else:
            encode = dec.model.encode

            def keep_encode(*a, **k):
                out = encode(*a, **k)
                if sum(x.shape[0] for x in self._sub) >= self.tr["streams"]:
                    self._sub = []
                self._sub.append(out[0])
                return out
            dec.model.encode = keep_encode
        step = caat_step.jointer_step

        def keep_lp(*a, **k):
            self.last_lp = step(*a, **k)
            return self.last_lp
        caat_step.jointer_step = keep_lp
        self._unhook = lambda: setattr(caat_step, "jointer_step", step)

    def _corpus(self, k: int):
        """Corpus k's pool rows (a seeded draw) and waveforms."""
        rng = np.random.default_rng([self.ctx.seed & SEED_MASK, k + 1])
        rows = rng.permutation(len(self.pool))[:self.tr["streams"]]
        return rows, [self.pool[i] for i in rows]

    # -- the window -----------------------------------------------------------
    def _run(self, stop):
        """Decode corpora until ``stop(k)``; returns the corpora run."""
        dec, tracer = self.dec, self.tracer

        def stage(k):
            rows, wavs = self._corpus(k)
            with tracer.span("stage"):
                return rows, dec.stage(wavs)

        nxt = self.stager.submit(stage, 0)
        k = 0
        while True:
            t0, c0 = time.perf_counter(), time.thread_time()
            rows, handle = nxt.result()
            nxt = self.stager.submit(stage, k + 1)
            with tracer.span("decode_corpus"):
                texts, delays = dec.decode_corpus(handle)
            self.decoded.append((k, rows, texts, delays))
            self.corpus_s.append((time.perf_counter() - t0,
                                  time.thread_time() - c0))
            k += 1
            if stop(k):
                break
        nxt.result()
        return k

    def measure(self):
        from wav2vec_s_tpu_torch.ops.chunk_attention import (
            chunk_cache_attention)
        from wav2vec_s_tpu_torch.ops.flash_attention import (
            blockwise_flash_attention_packed)

        self.counters = (chunk_cache_attention,
                         blockwise_flash_attention_packed)
        for fn in self.counters:
            fn.launches = 0
            fn.path_launches = {k: 0 for k in fn.path_launches}
        ctx, t = self.ctx, self.tr
        per_corpus = t["streams"] * self.n_samples / 16000.0
        self.corpus_s = []
        if not ctx.trace:
            ctx.window_start = time.perf_counter()
            n = self._run(lambda k: time.perf_counter() - ctx.window_start
                          >= ctx.seconds)
            wall = time.perf_counter() - ctx.window_start
            return {"metrics": {"decode_audio_s_per_s": n * per_corpus / wall},
                    "attempted": n * t["streams"], "failed": 0}
        ctx.window_start = time.perf_counter()
        with self.tracer.profile(self.on_card, host=False) as prof:
            n = self._run(lambda k: k >= t["trace_corpora"])
        sl = Slice(prof["kernels"], prof["spans"], prof["host_ops"],
                   prof["wall_s"], self._work(n * per_corpus))
        with self.tracer.profile(self.on_card, host=True) as prof:
            self._run(lambda k: k >= 1)
        hosted = Slice(prof["kernels"], prof["spans"], prof["host_ops"],
                       prof["wall_s"], {})
        return {"slice": sl, "host_slice": hosted,
                "attempted": (n + 1) * t["streams"], "failed": 0}

    def _work(self, audio_s: float) -> dict:
        """What the slice did: its audio, the model FLOPs of the streams it
        served, and the shapes of every K1 / K2 call it made."""
        t, w = self.tr, self.cfg["w2v"]
        mc, rc = w["main_context"], w["right_context"]
        blocks = t["blocks_per_step"]
        D, L = w["encoder_embed_dim"], w["encoder_layers"]
        B = t["streams"]
        flops, k1, k2 = 0.0, [], []
        for k, rows, texts, delays in self.decoded:
            for text, d in zip(texts, delays):
                s = sv.served(None, text, d, self.vocab, self.n_samples,
                              self.geo)
                flops += sv.decode_flops(s, self.cfg, t)
            n_chunks = sv.chunks_of(self.n_samples, *self.geo[:4])
            n_main = mc * blocks
            if t["decoder"] == "cached":
                R = blocks * (mc + rc)
                intra = work.chunk_pairs(0, mc, rc, blocks)
                k1 += [work.k1_call(B, R, c * n_main, D, intra)
                       for c in range(n_chunks)] * L
            else:
                T = n_chunks * n_main + rc
                T += T % 2
                S = T + work.copy_rows(T, mc, rc)
                eb = min(t["encode_batch"], B)
                while B % eb:
                    eb -= 1
                k2 += ([work.k2_call(eb, S, D, work.block_pairs(T, mc, rc))]
                       * (L * (B // eb)))
        return {"audio_s": audio_s, "model_flops": flops,
                "k1_calls": k1, "k2_calls": k2}

    def log_lines(self):
        k1, k2 = self.counters
        n = len(self.decoded)
        chunks = sv.chunks_of(self.n_samples, *self.geo[:4])
        words = sum(len(d) for _, _, _, ds in self.decoded for d in ds)
        return [f"corpora {n} x {self.tr['streams']} streams, tokens "
                f"{words}; K1 launches {k1.launches} {k1.path_launches} "
                f"(layers x chunks x corpora = "
                f"{self.cfg['w2v']['encoder_layers'] * chunks * n}), "
                f"K2 launches {k2.launches} {k2.path_launches}",
                "corpus wall s: " + " ".join(f"{w:.4f}" for w, _ in
                                             self.corpus_s),
                "corpus main-thread CPU s: " + " ".join(
                    f"{c:.4f}" for _, c in self.corpus_s)]

    # -- after the window -------------------------------------------------
    def release(self):
        """Keep the sampled streams' encoder output and last log-probs from
        the last corpus, then free the decoder."""
        self.stager.shutdown(wait=True)
        self._unhook()
        enc = (self.enc_out.out_cache.transpose(0, 1)
               if self.tr["decoder"] == "cached" else torch.cat(self._sub))
        n_frames = (sv.chunks_of(self.n_samples, *self.geo[:4])
                    * self.geo[3] + self.geo[2])
        rows = self.sample(self.tr["enc_streams"], 8)
        self.served_out = [(i, enc[i, :n_frames].clone(),
                            self.last_lp[i].clone()) for i in rows]
        self.enc_out = self._sub = self.last_lp = None
        del self.dec

    def sample(self, n: int, salt: int):
        """A seeded draw of ``n`` streams of the last corpus."""
        rng = np.random.default_rng([self.ctx.seed & SEED_MASK, salt])
        pick = rng.choice(self.tr["streams"], size=min(n, self.tr["streams"]),
                          replace=False)
        return sorted(int(i) for i in pick)

    def check(self, control: bool = False):
        """The largest relative error of the sampled streams' encoder
        outputs and absolute error of their last log-probs against the
        reference, and the widest logit gap of the served decisions of
        ``check_streams`` streams (``control``: the fp8 reference in the
        program's place)."""
        ctx, t = self.ctx, self.tr
        ref = reference_module(self.cfg)
        weights = make_weights(self.cfg, ctx.seed, ctx.device)
        _, rows, texts, delays = self.decoded[-1]

        def audio(i):
            return torch.from_numpy(self.pool[rows[i]]).to(
                ctx.device).float() / 32768.0

        gap_rows = self.sample(t["check_streams"], 7)
        served, bad = {}, []
        for i in sorted(set(gap_rows) | {i for i, _, _ in self.served_out}):
            try:
                served[i] = sv.served(i, texts[i], delays[i], self.vocab,
                                      self.n_samples, self.geo)
            except ValueError as e:
                bad.append(str(e))
        gaps = []
        for i in gap_rows:
            if i in served:
                gaps += sv.judge(ref, weights, self.cfg, t, served[i],
                                 audio(i), control)
        errs = []
        for i, enc_rows, lp in self.served_out:
            if i not in served:
                continue
            s = served[i]
            in_last = s.chunk_of.count(s.n_chunks - 1)
            prefix = (s.tokens[:-1] if in_last == t["max_emit_per_chunk"]
                      else s.tokens)
            errs.append(ref.served_errors(
                weights, self.cfg["w2v"], self.cfg["caat"], audio(i),
                enc_rows.shape[0], enc_rows, prefix, enc_rows.shape[0], lp,
                control))
        ctx.say(f"check: {len(errs)} streams' encoder outputs and last "
                f"log-probs; widest logit gap over {len(gaps)} decisions of "
                f"{len(gap_rows)} streams: "
                f"{max(gaps) if gaps else None!r}"
                + (f"; malformed: {bad}" if bad else ""))
        return sv.checks(errs, gaps, bad, ctx.cell.limits)
