"""Batched multi-stream greedy streaming decode over the cached CAAT path.

Port of ``CachedFusedGreedyDecoder`` (``wav2vec_s_tpu/stream/batched.py``):
N streams run in lockstep; per chunk of ``n_main`` new frames
  1. the int16 (or float32) window is converted on the device,
  2. the incremental encoder step runs the conv front-end and every encoder
     layer (chunk attention: the hand-written kernel on CUDA),
  3. the committed frames are projected to jointer K/V and appended,
  4. ``max_emit`` greedy emissions run against the position-aligned LM
     cache and the one-query jointer (``caat_step.greedy_emit``, the body
     the serving session runs too).
Nothing is read back to the host inside the chunk loop: per-chunk prefix
lengths are copied into a history on the device and fetched once at the
end.

A decoder keeps the emission loop's state (jointer K/V, LM caches,
prefixes, lengths, the length history) for the number of streams of the
last corpus, sized for the longest corpus ``t_cap`` holds, and resets it
in place for each corpus of as many streams, whatever its length.  On CUDA
the ``max_emit`` iterations of one chunk are a CUDA graph, captured once
per cache capacity at its first use and replayed for every later chunk
and corpus of that width: an iteration is a few hundred small kernels (a
jointer and an LM step over every layer), which eager dispatch leaves the
card waiting for.  A corpus of another width drops the state and its
graphs.  On the CPU the same body runs eagerly over the same buffers.

Under a profiler the spans ``w2vs/decoder.*`` (``utils/debug.span``) tile
a corpus: ``setup``, per chunk ``encoder_step`` / ``jointer_kv`` /
``emit_loop`` (one-shot: ``encode`` per sub-batch and one ``jointer_kv``,
then ``emit_loop`` per chunk), ``readback`` and ``texts``; the emission
counters (``count_emissions``) are taken from the prefix lengths read back,
and ``decoder.emit_iters_graphed`` from the chunks replayed.

``OneShotCorpusDecoder`` is the corpus-evaluation twin: the whole utterance
is encoded at once (blockwise, prefix-exact at block granularity) and the
same greedy loop is replayed on the chunk schedule, with the same texts and
delays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from wav2vec_s_tpu_torch.models.modules import compute_copy
from wav2vec_s_tpu_torch.stream import caat_step
from wav2vec_s_tpu_torch.stream.incremental import IncrementalBlockwiseEncoder
from wav2vec_s_tpu_torch.utils.debug import count, span, tracing


EMISSION_COUNTERS = ("emit_iters", "emit_iters_live", "emit_iters_emitting",
                     "tokens")


def count_emissions(layer: str, emitted: np.ndarray, max_emit: int,
                    names=EMISSION_COUNTERS) -> None:
    """Count the masked emission loop's work under ``<layer>.<name>`` for
    each of ``names``: ``emitted`` [runs, streams] holds the tokens each
    stream emitted in each run of ``max_emit`` iterations (the streams it
    ran for).  A stream emits in iterations 0 .. e - 1 and is blocked from
    iteration e on, so a run's iterations with an unblocked stream at their
    start (what the JAX ``while_loop`` runs) are ``min(max_emit, max e +
    1)``, and those in which a token came out ``max e``."""
    most = emitted.max(axis=1, initial=-1)         # -1: no stream ran
    value = {"emit_iters": max_emit * emitted.shape[0],
             "emit_iters_live": np.minimum(most + 1, max_emit).sum(),
             "emit_iters_emitting": np.maximum(most, 0).sum(),
             "tokens": emitted.sum()}
    for name in names:
        count(f"{layer}.{name}", value[name])


@dataclasses.dataclass
class EmitLoop:
    """The greedy loop's device state for ``key`` = ``(N, t_cap)``, reset
    in place for every corpus of N streams.

    jk/jv: per-layer time-major [t_cap, N, D] jointer K/V; lm: the LM
    state, a row for every prefix position the most chunks ``t_cap`` holds
    can reach; prefixes: [N, max_len + 1] ids; lens: [N] prefix lengths;
    visible: [N] encoder frames the jointer sees in the current chunk;
    hist: [that many chunks, N], row k the lengths after chunk k; graphs:
    on CUDA, cache capacity -> the CUDA graph of one chunk's loop over that
    many rows, all in the memory pool ``pool`` (None on the CPU, where the
    loop runs eagerly)."""

    key: tuple
    jk: List[torch.Tensor]
    jv: List[torch.Tensor]
    lm: caat_step.LMState
    prefixes: torch.Tensor
    lens: torch.Tensor
    visible: torch.Tensor
    hist: torch.Tensor
    graphs: Dict[int, "torch.cuda.CUDAGraph"]
    pool: Optional[tuple]


def capture(body: Callable[[], None], pool) -> "torch.cuda.CUDAGraph":
    """Run ``body`` once eagerly, on a side stream (lazy set-up such as
    cuBLAS handles stays out of the graph), then capture it into a CUDA
    graph in the memory pool ``pool``.  Capture runs nothing, so the
    eager run's result stands.  ``thread_local`` capture leaves other
    threads free to use the card meanwhile (a corpus staged on a helper
    thread copies to the card)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        body()
    return graph


class CachedFusedGreedyDecoder:
    """Cached greedy streaming decoder.

    Arguments are those of the JAX ``IncrementalGreedyDecoder`` except
    ``params``: the ``W2V2CaatModel`` carries its parameters and its device.
    The decoder works on a copy whose matmul weights are cast to the
    compute dtype once.
    """

    #: host->device wire format for the audio: "float32", or "int16" PCM
    #: (what the SimulEval server sends; converted by /32768 on the device)
    transfer_dtype = "float32"

    def __init__(self, model, vocab, w2v_cfg, max_len: int = 200,
                 max_emit_per_chunk: int = 8, t_cap: int = 2048,
                 blocks_per_step: int = 1):
        self.model = compute_copy(model, model.cfg.compute_dtype)
        self.device = model.decoder.lm.embed_tokens.weight.device
        self.vocab = vocab
        self.w2v_cfg = w2v_cfg
        self.max_len = max_len
        self.max_emit = max_emit_per_chunk
        self.mc = w2v_cfg.main_context
        self.rc = w2v_cfg.right_context
        self.t_cap = t_cap
        self.blocks_per_step = blocks_per_step
        self._enc_cache = {}         # n_streams -> encoder
        self._loop: Optional[EmitLoop] = None

    def _encoder(self, n: int) -> IncrementalBlockwiseEncoder:
        enc = self._enc_cache.get(n)
        if enc is None:
            enc = self._enc_cache[n] = IncrementalBlockwiseEncoder(
                self.w2v_cfg, self.model.encoder.w2v2_model, n,
                t_cap=self.t_cap, blocks_per_step=self.blocks_per_step,
                proj=self.model.encoder.encoder_proj)
        return enc

    def stage(self, wavs: List[np.ndarray]):
        """Assemble a corpus on the host and copy it to the device.

        Returns the handle ``(N, max_samples, audio)`` for
        ``decode_corpus``; in int16 mode the host clips ``w * 32768``."""
        N = len(wavs)
        W = self._encoder(N).window
        max_samples = max(len(w) for w in wavs)
        int16 = self.transfer_dtype == "int16"
        audio = np.zeros((N, max_samples + W),
                         np.int16 if int16 else np.float32)
        for i, w in enumerate(wavs):
            if int16 and w.dtype != np.int16:
                audio[i, :len(w)] = np.clip(w * 32768.0, -32768, 32767)
            else:
                audio[i, :len(w)] = w
        return N, max_samples, torch.from_numpy(audio).to(self.device)

    def _emit_loop(self, N: int, dtype) -> EmitLoop:
        """The loop state for N streams, reset (prefixes to bos, lengths to
        1, the LM to its bos step; the caller fills the jointer K/V): the
        last corpus's if it had N streams, else new, the old state and its
        graphs dropped first.  It is sized for the most chunks ``t_cap``
        holds (the last commits ``n_chunks * n_main + rc`` frames), so a
        corpus of another length keeps the state and its graphs."""
        key = (N, self.t_cap)
        loop = self._loop
        if loop is None or loop.key != key:
            self._loop = loop = None     # free the old state and graphs first
            model, dev = self.model, self.device
            caat = model.cfg
            chunks = max((self.t_cap - self.rc) // self._encoder(N).n_main, 1)
            # LM cache rows: a step writes at the prefix length, which
            # starts at 1 (bos) and grows by one an emission, to max_len
            u_cap = min(self.max_len, chunks * self.max_emit) + 1
            jk = [torch.empty((self.t_cap, N, caat.jointer_embed_dim),
                              dtype=dtype, device=dev)
                  for _ in range(caat.jointer_layers)]
            loop = self._loop = EmitLoop(
                key=key, jk=jk, jv=[torch.empty_like(k) for k in jk],
                lm=caat_step.lm_init(model, caat, N, u_cap),
                prefixes=torch.empty((N, self.max_len + 1), dtype=torch.long,
                                     device=dev),
                lens=torch.empty(N, dtype=torch.long, device=dev),
                visible=torch.empty(N, dtype=torch.long, device=dev),
                hist=torch.empty((chunks, N), dtype=torch.long, device=dev),
                graphs={},
                pool=(torch.cuda.graph_pool_handle() if dev.type == "cuda"
                      else None))
        else:
            caat_step.lm_reset(self.model, self.model.cfg, loop.lm)
        loop.prefixes.fill_(self.vocab.pad())
        loop.prefixes[:, 0] = self.vocab.bos()
        loop.lens.fill_(1)
        return loop

    def _greedy(self, loop: EmitLoop, cap: int) -> None:
        """One chunk's greedy emissions (``caat_step.greedy_emit``) over
        the first ``cap`` rows of the cached jointer K/V and the LM state,
        in place in ``loop``."""
        caat_step.greedy_emit(
            self.model, self.model.cfg, loop.lm,
            [x[:cap] for x in loop.jk], [x[:cap] for x in loop.jv],
            loop.visible, loop.prefixes, loop.lens,
            torch.zeros_like(loop.lens, dtype=torch.bool),
            max_emit=self.max_emit, max_len=self.max_len,
            blank=self.vocab.bos(), pad=self.vocab.pad())

    def _emit_chunk(self, loop: EmitLoop, k: int, cap: int,
                    visible: int) -> None:
        """Chunk ``k``'s emissions with ``visible`` encoder frames revealed
        and the jointer K/V read up to row ``cap``; its lengths go to row
        ``k`` of the history.  On CUDA the loop replays the graph of
        ``cap``, or runs it eagerly and captures that graph at its first
        use; while tracing, the counter ``decoder.emit_iters_graphed``
        counts the ``max_emit`` iterations of each chunk replayed."""
        loop.visible.fill_(visible)
        graph = loop.graphs.get(cap)
        if graph is not None:
            graph.replay()
        elif loop.pool is None:
            self._greedy(loop, cap)
        else:
            loop.graphs[cap] = capture(lambda: self._greedy(loop, cap),
                                       loop.pool)
        count("decoder.emit_iters_graphed",
              0 if graph is None else self.max_emit)
        loop.hist[k].copy_(loop.lens)

    def _finish(self, loop: EmitLoop, n_chunks: int, stride: int, W: int):
        """Read the prefixes and the length history back; texts and
        delays."""
        with span("decoder.readback"):
            lens_hist = loop.hist[:n_chunks].cpu()
            prefixes = loop.prefixes.cpu()
        with span("decoder.texts"):
            return self._texts_and_delays(prefixes, lens_hist, n_chunks,
                                          stride, W, prefixes.shape[0])

    def _texts_and_delays(self, prefixes, lens_hist, n_chunks, stride, W, N):
        """Per-chunk delay bookkeeping + surface assembly (host); while
        tracing, the emission counters of the corpus."""
        vocab = self.vocab
        lens_all = np.asarray(lens_hist)
        if tracing():
            count_emissions("decoder", np.diff(lens_all, axis=0, prepend=1),
                            self.max_emit)
        delays = [[] for _ in range(N)]
        prev = np.ones(N, np.int64)
        for k in range(n_chunks):
            ms = (k * stride + W) / 16.0
            for i in range(N):
                delays[i].extend([ms] * int(lens_all[k, i] - prev[i]))
            prev = lens_all[k]

        texts = []
        pfx = np.asarray(prefixes)
        for i in range(N):
            ids = pfx[i, 1:int(prev[i])]
            pieces = [vocab[int(t)] for t in ids
                      if int(t) >= vocab.nspecial]
            texts.append("".join(pieces).replace("▁", " ").strip()
                         if pieces else "")
        return texts, delays

    @torch.no_grad()
    def decode_corpus(self, wavs):
        """Stream a corpus (a list of waveforms, or a ``stage`` handle) in
        lockstep; returns (texts, per-word delays in ms)."""
        if isinstance(wavs, tuple) and len(wavs) == 3:
            N, max_samples, audio = wavs          # pre-staged handle
        else:
            N, max_samples, audio = self.stage(wavs)
        with span("decoder.setup"):
            enc = self._encoder(N)
            hop, W, n_main, rc = enc.hop, enc.window, enc.n_main, self.rc
            int16 = self.transfer_dtype == "int16"
            total_frames = (max_samples - enc.rf) // hop + 1
            n_chunks = max((total_frames - rc) // n_main, 1)
            stride = n_main * hop

            model = self.model
            caat = model.cfg
            t_cap = self.t_cap
            estate = enc.init()
            loop = self._emit_loop(N, estate.out_cache.dtype)
            jk, jv = loop.jk, loop.jv
            for x in jk + jv:
                x.zero_()

        # cache capacity per chunk, in steps of seg rows: early chunks
        # attend only a prefix of the encoder/jointer K/V buffers (a free
        # view in torch; the JAX package compiled one scan per capacity)
        seg = 256

        def cap_of(v):
            return min(-(-v // seg) * seg, t_cap)

        for k in range(n_chunks):
            flush = k == n_chunks - 1
            n_new = n_main + rc if flush else n_main
            cap = cap_of(k * n_main + n_new)
            with span("decoder.encoder_step"):
                win = audio[:, k * stride:k * stride + W]
                win = win.float() / 32768.0 if int16 else win
                t0 = estate.t_main
                estate = enc.step_fn_cap(cap, flush=flush)(estate, win)
            with span("decoder.jointer_kv"):
                k_new, v_new = caat_step.jointer_kv(
                    model, caat, estate.out_cache[t0:t0 + n_new])
                caat_step.jointer_kv_append(jk, jv, k_new, v_new, t0)
            with span("decoder.emit_loop"):
                self._emit_chunk(loop, k, cap, estate.t_main)
        return self._finish(loop, n_chunks, stride, W)


class OneShotCorpusDecoder(CachedFusedGreedyDecoder):
    """Corpus-eval fast path: one-shot blockwise encode + replayed greedy loop.

    Port of the JAX ``OneShotCorpusDecoder`` (``wav2vec_s_tpu/stream/
    batched.py:657-785``).  When every utterance is on disk before decoding
    starts (the SimulEval corpus flow), the policy sees the encoder only
    through its per-frame outputs, and the blockwise mask makes those
    prefix-exact at block granularity: the incremental encoder commits,
    chunk by chunk, exactly the frames one full-utterance encode produces.
    So the encoder runs ONCE per utterance (large matmuls; with
    ``attention_impl="flash"`` the block-sparse kernel), the jointer K/V of
    every frame are projected at once, and the greedy loop runs against the
    visibility schedule of the chunks.  Texts and delays equal
    ``CachedFusedGreedyDecoder``'s.
    """

    #: streams encoded per sub-batch (lowered until it divides N): the
    #: first conv layer holds [encode_batch, 512, samples / 5] activations
    encode_batch = 32

    @torch.no_grad()
    def decode_corpus(self, wavs):
        if isinstance(wavs, tuple) and len(wavs) == 3:
            N, max_samples, audio = wavs          # pre-staged handle
        else:
            N, max_samples, audio = self.stage(wavs)
        with span("decoder.setup"):
            enc = self._encoder(N)
        hop, W, n_main, rc = enc.hop, enc.window, enc.n_main, self.rc
        int16 = self.transfer_dtype == "int16"
        total_frames = (max_samples - enc.rf) // hop + 1
        n_chunks = max((total_frames - rc) // n_main, 1)
        stride = n_main * hop
        # the frames the policy ever sees (the flush commits the final
        # look-ahead); the block layout is built over these, not over all
        # frames, which decides which rc copies are valid
        t_frames = n_chunks * n_main + rc
        n_samples = (t_frames - 1) * hop + enc.rf
        t_cap = self.t_cap
        if t_cap < t_frames:
            raise ValueError(f"t_cap={t_cap} does not hold the "
                             f"{t_frames} frames of this corpus")

        model = self.model
        caat = model.cfg
        eb = min(self.encode_batch, N)
        while N % eb:
            eb -= 1

        # encoder output, time-major and padded to t_cap like the caches of
        # the incremental path
        enc_tm = None
        for i in range(0, N, eb):
            with span("decoder.encode"):
                au = audio[i:i + eb, :n_samples]
                au = au.float() / 32768.0 if int16 else au
                e, _ = model.encode(au, None, self.mc, rc)  # [eb, t_frames, D]
                if enc_tm is None:
                    enc_tm = e.new_zeros((t_cap, N, e.shape[-1]))
                enc_tm[:t_frames, i:i + eb] = e.transpose(0, 1)
        with span("decoder.setup"):
            loop = self._emit_loop(N, enc_tm.dtype)
        # chunk k reveals (k+1)*n_main frames, the last also the flushed
        # look-ahead; the jointer reads a prefix view of its K/V in steps
        # of seg rows.  The K/V are projected into the loop's buffers seg
        # rows at a time, so that one slice's projection is all it holds
        # besides
        seg = 128
        with span("decoder.jointer_kv"):
            for t0 in range(0, t_cap, seg):
                caat_step.jointer_kv_append(
                    loop.jk, loop.jv,
                    *caat_step.jointer_kv(model, caat, enc_tm[t0:t0 + seg]),
                    t0)
        for k in range(n_chunks):
            vis = (k + 1) * n_main + (rc if k == n_chunks - 1 else 0)
            cap = min(-(-vis // seg) * seg, t_cap)
            with span("decoder.emit_loop"):
                self._emit_chunk(loop, k, cap, vis)
        return self._finish(loop, n_chunks, stride, W)
