"""Serving at a full card: ``ServingSession`` with every slot busy.

Traffic keys: ``slots``, ``t_cap``, ``blocks_per_step``, ``max_len``,
``max_emit_per_chunk``; stream lengths ``min_seconds`` to ``max_seconds``,
drawn in blocks of ``length_block`` streams that each hold the same evenly
spaced lengths in a seeded order (so every seed serves the same mix);
``stall_share`` of each block stalls one step in ``stall_every`` (no audio
arrives that step, at a seeded phase); audio is a seeded slice of a
``pool_seconds`` noise buffer at ``amplitude``; ``warm_steps`` steps of the
same traffic run before the window, ``trace_steps`` steps are profiled
for the device metrics and ``host_trace_steps`` more with the host's
operators for the breakdown;
after the window the reference scores the decisions of ``check_streams``
streams the window finished (the longest among them: the widest logit
gap) and the encoder output rows and last log-probs of ``enc_streams``
streams still in their slots.

The loop is closed at the slot: each step every stream that is not
stalling gets the audio of its next chunk (the first step a window's worth,
the last chunk with the rest and the end), then ``step()`` runs; a stream
that finished frees its slot and the next stream takes it before the next
step.  ``serve_step_p95_ms`` is the 95th percentile of the host time of
every ``step()`` in the window (each ends in its own device read);
``serve_audio_s_per_s`` counts 0.64 s of audio for every chunk a step
consumed, over the window's wall time.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from w2vs_bench import served as sv
from w2vs_bench.model import (SEED_MASK, build_program_model, make_vocab,
                              make_weights, reference_module, text_ids)
from w2vs_bench.trace import Slice, Tracer

AUDIO_SALT = 0x5EED_5E7E


@dataclasses.dataclass
class Stream:
    sid: str
    n: int                  # the stream's index in the seed's sequence
    start: int              # first sample in the pool
    length: int             # samples
    n_chunks: int
    stalls: bool
    phase: int
    admitted: int           # step index of admission
    pushed: int = 0
    chunk: int = 0          # chunks the session has run for it
    tokens: int = 0
    words: list = dataclasses.field(default_factory=list)
    last_k: int = 0         # tokens emitted in the latest step it ran


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cell.config
        self.tr = ctx.cell.traffic
        self.tracer = Tracer(ctx.trace)
        self.on_card = ctx.device.type == "cuda"
        self.finished = {}        # sid -> (Stream, text, delays)
        self.steps_run = 0

    def setup(self):
        from wav2vec_s_tpu_torch.stream.serving import ServingSession

        t, ctx = self.tr, self.ctx
        model, w2v, caat = build_program_model(self.cfg, ctx.seed, ctx.device)
        self.vocab = make_vocab(caat.vocab_size)
        self.sess = ServingSession(
            model, self.vocab, w2v, n_slots=t["slots"], t_cap=t["t_cap"],
            blocks_per_step=t["blocks_per_step"], max_len=t["max_len"],
            max_emit_per_chunk=t["max_emit_per_chunk"])
        del model
        self._hook_lp()
        enc = self.sess.enc
        self.geo = (enc.rf, enc.hop, enc.rc, enc.n_main, enc.window)
        self.stride = enc.n_main * enc.hop
        gen = torch.Generator(device=ctx.device).manual_seed(
            (ctx.seed ^ AUDIO_SALT) & SEED_MASK)
        self.pool = (torch.randn(int(t["pool_seconds"] * 16000),
                                 generator=gen, device=ctx.device)
                     * t["amplitude"]).cpu().numpy()
        self.next_n = 0
        self.active = {}
        self._blocks = {}
        self._fill()
        for _ in range(t["warm_steps"]):
            self._step()
        if self.on_card:
            torch.cuda.synchronize()

    def _hook_lp(self):
        """Keep a reference to the jointer's latest log-probs (one row per
        slot) for the check; no device work."""
        from wav2vec_s_tpu_torch.stream import caat_step

        step = caat_step.jointer_step
        self.last_lp = None

        def keep_lp(*a, **k):
            self.last_lp = step(*a, **k)
            return self.last_lp
        caat_step.jointer_step = keep_lp
        self._unhook = lambda: setattr(caat_step, "jointer_step", step)

    # -- traffic -------------------------------------------------------------
    def _block(self, b: int):
        """Lengths, stall flags and phases of the streams of block b."""
        if b not in self._blocks:
            t = self.tr
            m = t["length_block"]
            rng = np.random.default_rng([self.ctx.seed & SEED_MASK, b])
            secs = np.linspace(t["min_seconds"], t["max_seconds"], m)
            lengths = (secs[rng.permutation(m)] * 16000).astype(np.int64)
            stalls = np.zeros(m, bool)
            n_stall = int(round(t["stall_share"] * m))
            stalls[rng.permutation(m)[:n_stall]] = True
            phases = rng.integers(0, t["stall_every"], m)
            starts = rng.integers(0, len(self.pool) - lengths + 1)
            self._blocks = {b: (lengths, stalls, phases, starts)}
        return self._blocks[b]

    def _new_stream(self) -> Stream:
        n = self.next_n
        self.next_n += 1
        m = self.tr["length_block"]
        lengths, stalls, phases, starts = self._block(n // m)
        L = int(lengths[n % m])
        return Stream(f"s{n}", n, int(starts[n % m]), L,
                      sv.chunks_of(L, *self.geo[:4]), bool(stalls[n % m]),
                      int(phases[n % m]), self.steps_run)

    def _fill(self):
        while len(self.active) < self.tr["slots"]:
            st = self._new_stream()
            with self.tracer.span("add_stream"):
                ok = self.sess.add_stream(st.sid)
            if not ok:
                raise RuntimeError("no free slot for a new stream")
            self.active[st.sid] = st

    def _step(self):
        """Push, step, retire and refill; returns (host s of step(), the
        ready streams with their chunk and flush flag, tokens per stream)."""
        t = self.tr
        W = self.geo[4]
        ready = []
        for st in self.active.values():
            if st.stalls and (self.steps_run - st.admitted) % t[
                    "stall_every"] == st.phase:
                st.last_k = 0
                continue
            last = st.chunk == st.n_chunks - 1
            target = st.length if last else st.chunk * self.stride + W
            audio = self.pool[st.start + st.pushed:st.start + target]
            with self.tracer.span("push"):
                self.sess.push(st.sid, audio, is_end=last)
            st.pushed = target
            ready.append((st, st.chunk, last))
        t0 = time.perf_counter()
        with self.tracer.span("step"):
            words = self.sess.step()
        dt = time.perf_counter() - t0
        self.steps_run += 1
        emitted = []
        for st, c, last in ready:
            new = words.get(st.sid, [])
            k = len(new)
            emitted.append((st, c, last, k, st.tokens))
            st.tokens += k
            st.words += new
            st.last_k = k
            st.chunk += 1
            if st.chunk == st.n_chunks:
                text, delays = self.sess.result(st.sid)
                self.finished[st.sid] = (st, text, delays)
                del self.active[st.sid]
        self._fill()
        return dt, emitted

    # -- the window -------------------------------------------------------
    def measure(self):
        ctx, t = self.ctx, self.tr
        self.window_finished = len(self.finished)
        self.comp0 = self.sess.compactions
        chunk_s = self.stride / 16000.0
        if not ctx.trace:
            times, chunks = [], 0
            ctx.window_start = time.perf_counter()
            while time.perf_counter() - ctx.window_start < ctx.seconds:
                dt, emitted = self._step()
                times.append(dt)
                chunks += len(emitted)
            wall = time.perf_counter() - ctx.window_start
            self.times = times
            return {"metrics": {
                "serve_audio_s_per_s": chunks * chunk_s / wall,
                "serve_step_p95_ms": float(np.percentile(times, 95)) * 1e3},
                "attempted": self.next_n, "failed": 0}
        ctx.window_start = time.perf_counter()
        flops, chunks = 0.0, 0
        with self.tracer.profile(self.on_card, host=False) as prof:
            for _ in range(t["trace_steps"]):
                _, emitted = self._step()
                chunks += len(emitted)
                flops += sum(sv.chunk_flops(self.cfg, t, c, last, k, before)
                             for _, c, last, k, before in emitted)
        self.times = []
        sl = Slice(prof["kernels"], prof["spans"], prof["host_ops"],
                   prof["wall_s"], {"steps": t["trace_steps"],
                                    "audio_s": chunks * chunk_s,
                                    "model_flops": flops})
        with self.tracer.profile(self.on_card, host=True) as prof:
            for _ in range(t["host_trace_steps"]):
                self._step()
        hosted = Slice(prof["kernels"], prof["spans"], prof["host_ops"],
                       prof["wall_s"], {})
        return {"slice": sl, "host_slice": hosted, "attempted": self.next_n,
                "failed": 0}

    def log_lines(self):
        s = self.sess
        caches = (s._estate.k_cache + s._estate.v_cache + [s._estate.out_cache]
                  + s._jk + s._jv + s._lm.k + s._lm.v)
        n_bytes = sum(x.numel() * x.element_size() for x in caches)
        times = np.asarray(self.times) * 1e3
        out = [f"steps {self.steps_run} (window {len(times)}), streams "
               f"admitted {self.next_n}, finished in the window "
               f"{len(self.finished) - self.window_finished}, compactions "
               f"{s.compactions} (window {s.compactions - self.comp0}), "
               f"slot caches {n_bytes} bytes = {n_bytes // self.tr['slots']}"
               f" per slot"]
        if len(times):
            out.append(f"step ms: p50 {np.percentile(times, 50):.3f} p95 "
                       f"{np.percentile(times, 95):.3f} max {times.max():.3f}"
                       f" over {len(times)} steps")
        return out

    # -- after the window -------------------------------------------------
    def release(self):
        """Keep, for a seeded draw of the streams in the slots, the encoder
        rows the session holds for them (a slot's visible rows, in order,
        are its stream's committed frames) and their row of the jointer's
        last log-probs; then free the session."""
        self._unhook()
        sess = self.sess
        live = sorted((st for st in self.active.values() if st.chunk > 0),
                      key=lambda st: st.n)
        rng = np.random.default_rng([self.ctx.seed & SEED_MASK, 8])
        k = min(self.tr["enc_streams"], len(live))
        self.served_out = []
        for j in sorted(rng.choice(len(live), size=k, replace=False)):
            st = live[j]
            slot = sess._by_id[st.sid]
            rows = sess._vis[slot].nonzero()[:, 0]
            self.served_out.append(
                (st, sess._estate.out_cache[rows, slot].clone(),
                 self.last_lp[slot].clone()))
        self.last_lp = None
        del self.sess

    def sample(self):
        """A seeded draw of the streams finished in the window, the longest
        of them first."""
        done = list(self.finished)[self.window_finished:]
        if not done:
            return []
        longest = max(done, key=lambda sid: self.finished[sid][0].length)
        rest = [sid for sid in done if sid != longest]
        rng = np.random.default_rng([self.ctx.seed & SEED_MASK, 7])
        k = min(self.tr["check_streams"] - 1, len(rest))
        pick = rng.choice(len(rest), size=k, replace=False) if k else []
        return [longest] + [rest[j] for j in sorted(pick)]

    def check(self, control: bool = False):
        """The largest relative error of the sampled live streams' encoder
        rows and absolute error of their last log-probs against the
        reference, and the widest logit gap of the decisions of the sampled
        finished streams (``control``: the fp8 reference in the program's
        place)."""
        ctx, t = self.ctx, self.tr
        ref = reference_module(self.cfg)
        weights = make_weights(self.cfg, ctx.seed, ctx.device)
        gaps, bad = [], []
        pick = self.sample()
        for sid in pick:
            st, text, delays = self.finished[sid]
            try:
                s = sv.served(sid, text, delays, self.vocab, st.length,
                              self.geo)
            except ValueError as e:
                bad.append(str(e))
                continue
            gaps += sv.judge(ref, weights, self.cfg, t, s,
                             self._audio(st, st.length), control)
        rf, hop, rc, n_main, _ = self.geo
        errs = []
        for st, rows, lp in self.served_out:
            n = st.chunk * n_main
            toks = text_ids("".join(st.words).replace("▁", " "), self.vocab)
            if rows.shape[0] != n or len(toks) != st.tokens:
                bad.append(f"stream {st.sid}: {rows.shape[0]} encoder rows "
                           f"visible after {st.chunk} chunks, {len(toks)} of "
                           f"{st.tokens} tokens read")
                continue
            prefix = (toks[:-1] if st.last_k == t["max_emit_per_chunk"]
                      else toks)
            # frames < n depend on frames < n + rc alone
            audio = self._audio(st, (n + rc - 1) * hop + rf)
            errs.append(ref.served_errors(
                weights, self.cfg["w2v"], self.cfg["caat"], audio, n + rc,
                rows, prefix, n, lp, control))
        ctx.say(f"check: {len(errs)} live streams' encoder rows and last "
                f"log-probs; widest logit gap over {len(gaps)} decisions of "
                f"{len(pick)} finished streams: "
                f"{max(gaps) if gaps else None!r}"
                + (f"; malformed: {bad}" if bad else ""))
        return sv.checks(errs, gaps, bad, ctx.cell.limits)

    def _audio(self, st: Stream, n: int):
        return torch.from_numpy(
            self.pool[st.start:st.start + n]).to(self.ctx.device)
