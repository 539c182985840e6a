"""Continuous-batching streaming serving over N device slots (torch).

Port of ``wav2vec_s_tpu/stream/serving.py``.  The corpus decoders
(``stream/batched.py``) are wave-synchronous: every stream of a batch
starts and ends together.  Live serving is not: streams join, stall (audio
arrives slower than the card decodes) and finish on their own.  This module
multiplexes live streams onto a fixed number of SLOTS that advance in
lockstep:

- **Global cache rows, per-slot visibility.**  Every step appends the
  chunk's encoder K/V, outputs and jointer K/V at the same global row offset
  for all N slots.  A slot's stream sees only the rows written while it was
  active, tracked by a boolean plane ``vis [N, t_cap]``; rows written during
  someone else's turn stay masked out of its attention.  Absent or stalled
  slots compute values that are never marked visible.
- **Per-slot positions.**  Sinusoidal positions come from each slot's own
  frame count, so a stream that joined at global row 400 still sees
  positions 0, 1, 2, ...: the same math as decoding it alone.
- **Slot recycling.**  A finished slot is reset by a mask: its prefix
  becomes [bos], its visibility row clears, and one masked LM step on bos
  rebuilds its ``h_last`` (writing bos K/V at row 0 changes nothing for the
  other streams: those values depend on the position and the weights only).
- **Compaction.**  Global rows grow monotonically; when the capacity runs
  out, the caches roll down by the least first-visible row of the active
  slots, the serving analogue of freeing KV-cache pages.

What differs from the JAX session: the JAX emission ``while_loop`` ends
once every row is blocked; here the step runs the greedy decoders' masked
body (``caat_step.greedy_emit``, ``max_emit_per_chunk`` iterations) and
reads nothing back inside it.  Blocked rows do not change, so the results
are the same.  The step keeps its device state in place, as the decoders
do: between compactions the prefixes, lengths, frame counts and LM caches
keep their tensors from step to step.  The global write offset ``t_main``
is a host int; a step reads ``lens`` and ``prefixes`` back once, as the
JAX host API does.  The reset's LM step runs only in steps that reset a
slot (``reset`` is a host array): in the others it would change nothing.
Emission semantics (greedy blank -> advance, delay bookkeeping) equal
``CachedFusedGreedyDecoder``'s per stream
(``tests/test_torch_port_serving.py``).

Under a profiler the spans ``w2vs/serving.*`` (``utils/debug.span``) tile
a step: ``compact`` (when it runs), ``gather``, ``upload``, ``reset`` (in
steps that reset a slot), ``encoder_step``, ``jointer_kv``, ``emit_loop``,
``readback`` and ``words``; the counters ``serving.emit_iters`` and
``serving.emit_iters_live`` (``batched.count_emissions`` over the fired
slots), ``serving.plane_rows_read`` (slots x the plane's rows that the
attention reads, from the shape of the plane it is handed) and
``serving.plane_rows_visible`` (the rows of the plane visible to each
slot's stream when the jointer reads it, from the slots' chunk counts) and
``serving.jointer_rows_loaded`` (the rows the jointer's attention loads:
the sum of the slots' extents, once a step) come from host bookkeeping.

**Extents.**  A slot's stream sees no row before its ``first_row`` and
none past the step's last written row, so each step hands the jointer the
extent ``[first_row, t_main)`` of every occupied slot (an empty slot an
empty one) with the plane (a ``caat_step.SlotPlane``), and
``ops/decode_attention`` loads only those rows; the plane still masks the
rows written while the slot stalled.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from wav2vec_s_tpu_torch.models.modules import compute_copy
from wav2vec_s_tpu_torch.stream import caat_step
from wav2vec_s_tpu_torch.stream.batched import count_emissions
from wav2vec_s_tpu_torch.stream.incremental import IncrementalBlockwiseEncoder
from wav2vec_s_tpu_torch.utils.debug import count, span, tracing


@dataclasses.dataclass
class _Slot:
    stream_id: Optional[str] = None
    buf: Optional[np.ndarray] = None        # received samples
    n_buf: int = 0
    ended: bool = False
    chunk_idx: int = 0
    n_chunks: int = -1                      # known once ended
    first_row: int = 0                      # earliest visible global row
    pieces: List[str] = dataclasses.field(default_factory=list)
    delays_ms: List[float] = dataclasses.field(default_factory=list)
    emitted: int = 1                        # prefix rows consumed (bos)
    fresh: bool = True                      # needs the in-step reset


class ServingSession:
    """Continuous-batching greedy transducer serving.

    API:
      add_stream(sid) -> bool      claim a free slot (False = all busy)
      push(sid, samples, is_end)   feed audio (float32 @ 16 kHz); the end
                               must come with the last chunk's audio
      step() -> {sid: [words...]}  advance every ready slot by one chunk
      drain()                      step until every admitted stream ended
      result(sid) -> (text, delays_ms)   after the stream finished

    Arguments are those of the JAX session except ``params``: the
    ``W2V2CaatModel`` carries its parameters and its device; the session
    works on a copy whose matmul weights are cast to the compute dtype.
    ``steps`` and ``compactions`` count the device steps and the cache
    compactions run so far.
    """

    def __init__(self, model, vocab, w2v_cfg, n_slots: int = 16,
                 t_cap: int = 1024, blocks_per_step: int = 2,
                 max_len: int = 256, max_emit_per_chunk: int = 4):
        self.model = compute_copy(model, model.cfg.compute_dtype)
        self.device = model.decoder.lm.embed_tokens.weight.device
        self.vocab = vocab
        self.n = n_slots
        self.t_cap = t_cap
        self.max_len = max_len
        self.max_emit = max_emit_per_chunk
        self.enc = IncrementalBlockwiseEncoder(
            w2v_cfg, self.model.encoder.w2v2_model, n_slots, t_cap=t_cap,
            blocks_per_step=blocks_per_step,
            proj=self.model.encoder.encoder_proj)
        self.rc = self.enc.rc
        self.n_main = self.enc.n_main
        self.stride = self.enc.n_main * self.enc.hop
        self.window = self.enc.window
        self._rows_per_step = self.n_main + self.rc
        self._enc_step = self.enc.make_serving_step()

        self.slots = [_Slot() for _ in range(n_slots)]
        self._by_id: Dict[str, int] = {}
        self._results: Dict[str, tuple] = {}
        self.steps = 0
        self.compactions = 0

        caat = self.model.cfg
        N, dev = n_slots, self.device
        self._estate = self.enc.init()
        cdtype = self._estate.out_cache.dtype
        self._vis = torch.zeros((N, t_cap), dtype=torch.bool, device=dev)
        self._jk = [torch.zeros((t_cap, N, caat.jointer_embed_dim),
                                dtype=cdtype, device=dev)
                    for _ in range(caat.jointer_layers)]
        self._jv = [torch.zeros_like(k) for k in self._jk]
        self._prefixes = torch.full((N, max_len + 1), vocab.pad(),
                                    dtype=torch.long, device=dev)
        self._prefixes[:, 0] = vocab.bos()
        self._lens = torch.ones(N, dtype=torch.long, device=dev)
        self._frames = torch.zeros(N, dtype=torch.long, device=dev)
        self._lm = caat_step.lm_init(self.model, caat, N, max_len + 1)
        self._row_is_main = (torch.arange(self._rows_per_step, device=dev)
                             < self.n_main)

    # -- device step -----------------------------------------------------
    @torch.no_grad()
    def _device_step(self, window, ready, flush, reset, extent,
                     any_reset: bool):
        """One step on the device, in place: the prefixes, lengths, frame
        counts, plane and LM state keep their tensors (only a compaction
        rolls the plane and the caches into new ones)."""
        model, caat = self.model, self.model.cfg
        blank, pad = self.vocab.bos(), self.vocab.pad()
        N, n_new = self.n, self._rows_per_step
        vis = self._vis              # the plane both attentions are handed

        if any_reset:                                # recycled slots
            with span("serving.reset"):
                self._prefixes.masked_fill_(reset[:, None], pad)
                self._prefixes[:, 0].masked_fill_(reset, blank)
                self._lens.masked_fill_(reset, 1)
                self._frames.masked_fill_(reset, 0)
                vis &= ~reset[:, None]
                caat_step.lm_step(model, caat, self._lm,
                                  torch.full_like(self._lens, blank),
                                  torch.zeros_like(self._lens), reset)

        with span("serving.encoder_step"):
            t0 = self._estate.t_main
            self._estate = self._enc_step(self._estate, window, self._frames,
                                          vis)
            # visibility: main rows where ready; the rc tail where flushing
            new_plane = ready[:, None] & (self._row_is_main[None]
                                          | flush[:, None])  # [N, n_new]
            vis[:, t0:t0 + n_new] |= new_plane

        with span("serving.jointer_kv"):
            k_new, v_new = caat_step.jointer_kv(
                model, caat, self._estate.out_cache[t0:t0 + n_new])
            caat_step.jointer_kv_append(self._jk, self._jv, k_new, v_new,
                                        t0)

        # the decoders' emission body, masked by `ready` and driven by the
        # visibility plane, which the encoder's attention read too
        count("serving.plane_rows_read", vis.numel())
        with span("serving.emit_loop"):
            caat_step.greedy_emit(
                model, caat, self._lm, self._jk, self._jv,
                caat_step.SlotPlane(vis, extent[:N], extent[N]),
                self._prefixes, self._lens, ~ready, max_emit=self.max_emit,
                max_len=self.max_len, blank=blank, pad=pad)
            self._frames.add_(torch.where(ready, self.n_main, 0))

    def _compact(self):
        active_rows = [s.first_row for s in self.slots
                       if s.stream_id is not None and not s.fresh]
        t_main = self._estate.t_main
        shift = min(active_rows) if active_rows else t_main
        if shift <= 0:
            return
        st = self._estate

        def roll_t(buf):
            return torch.roll(buf, -shift, dims=0)

        keep = (torch.arange(self.t_cap, device=self.device)[None]
                < t_main - shift)                            # [1, t_cap]
        self._vis = torch.roll(self._vis, -shift, dims=1) & keep
        st.k_cache = [roll_t(b) for b in st.k_cache]
        st.v_cache = [roll_t(b) for b in st.v_cache]
        st.out_cache = roll_t(st.out_cache)
        st.t_main = t_main - shift
        self._jk = [roll_t(b) for b in self._jk]
        self._jv = [roll_t(b) for b in self._jv]
        for s in self.slots:
            if s.stream_id is not None:
                s.first_row -= shift
        self.compactions += 1

    # -- host API ----------------------------------------------------------
    def add_stream(self, stream_id: str) -> bool:
        if stream_id in self._by_id:
            raise ValueError(f"stream {stream_id} already active")
        for i, s in enumerate(self.slots):
            if s.stream_id is None:
                self.slots[i] = _Slot(stream_id=stream_id,
                                      buf=np.zeros(0, np.float32),
                                      fresh=True)
                self._by_id[stream_id] = i
                return True
        return False

    def push(self, stream_id: str, samples, is_end: bool = False):
        s = self.slots[self._by_id[stream_id]]
        samples = np.asarray(samples, np.float32)
        if len(samples):
            s.buf = np.concatenate([s.buf, samples])
        s.n_buf = len(s.buf)
        if is_end:
            s.ended = True
            total_frames = max((s.n_buf - self.enc.rf) // self.enc.hop + 1,
                               1)
            s.n_chunks = max((total_frames - self.rc) // self.n_main, 1)
            if s.chunk_idx >= s.n_chunks:
                # its last chunk already ran without the end's look-ahead
                # flush: the JAX session would wait for it forever
                raise RuntimeError(
                    f"stream {stream_id}: the end came after its last chunk "
                    f"ran ({s.chunk_idx} of {s.n_chunks}); push the end with "
                    f"the last chunk's audio")

    def _ready(self, s: _Slot) -> bool:
        if s.stream_id is None:
            return False
        need = s.chunk_idx * self.stride + self.window
        return s.n_buf >= need or (s.ended and s.chunk_idx < s.n_chunks)

    def step(self) -> Dict[str, List[str]]:
        """Advance every ready slot by one chunk; returns new words."""
        N, W = self.n, self.window
        if self._estate.t_main + self._rows_per_step > self.t_cap:
            with span("serving.compact"):
                self._compact()
            if self._estate.t_main + self._rows_per_step > self.t_cap:
                raise RuntimeError(
                    f"t_cap={self.t_cap} exhausted: the longest active "
                    "stream exceeds the session's cache capacity")
        t_main = self._estate.t_main

        with span("serving.gather"):
            window = np.zeros((N, W), np.float32)
            ready = np.zeros(N, bool)
            flush = np.zeros(N, bool)
            reset = np.zeros(N, bool)
            # each slot's extent [lo, hi): from its first row to the step's
            # last row, empty for a free slot; one int64 array [lo..., hi]
            extent = np.full(N + 1, t_main + self._rows_per_step, np.int64)
            fired = []
            for i, s in enumerate(self.slots):
                if s.stream_id is None:
                    continue
                if s.fresh:
                    reset[i] = True
                    s.fresh = False
                    s.first_row = t_main
                extent[i] = s.first_row
                if self._ready(s):
                    ready[i] = True
                    start = s.chunk_idx * self.stride
                    chunk = s.buf[start:start + W]
                    window[i, :len(chunk)] = chunk
                    flush[i] = s.ended and s.chunk_idx == s.n_chunks - 1
                    fired.append(i)

        if not fired and not reset.any():
            return {}

        count("serving.jointer_rows_loaded",
              int(extent[N] * N - extent[:N].sum()))
        dev = self.device
        with span("serving.upload"):
            planes = [torch.from_numpy(a).to(dev)
                      for a in (window, ready, flush, reset, extent)]
        self._device_step(*planes, bool(reset.any()))
        self.steps += 1

        with span("serving.readback"):
            lens = self._lens.cpu().numpy()
            pfx = self._prefixes.cpu().numpy()
        with span("serving.words"):
            if tracing():
                self._count_step(lens, fired, int(flush.sum()))
            out: Dict[str, List[str]] = {}
            for i in fired:
                s = self.slots[i]
                ms = (s.chunk_idx * self.stride + W) / 16.0
                new_words = []
                for u in range(s.emitted, int(lens[i])):
                    tok = int(pfx[i, u])
                    if tok >= self.vocab.nspecial:
                        s.pieces.append(self.vocab[tok])
                    s.delays_ms.append(ms)
                    new_words.append(self.vocab[tok]
                                     if tok >= self.vocab.nspecial else "")
                s.emitted = int(lens[i])
                s.chunk_idx += 1
                if new_words:
                    out[s.stream_id] = [w for w in new_words if w]
                if s.ended and s.chunk_idx >= s.n_chunks:
                    text = ("".join(s.pieces).replace("▁", " ").strip()
                            if s.pieces else "")
                    self._results[s.stream_id] = (text, list(s.delays_ms))
                    del self._by_id[s.stream_id]
                    self.slots[i] = _Slot()
        return out

    def _count_step(self, lens, fired, n_flushed: int) -> None:
        """The step's counters, before the slots advance past the step: the
        fired slots' emissions, and the rows visible to each slot's stream
        when the jointer read the plane (the fired ones' chunk of main rows
        included, and the look-ahead tail of those that flushed)."""
        emitted = [int(lens[i]) - self.slots[i].emitted for i in fired]
        count_emissions("serving", np.array(emitted, np.int64)[None],
                        self.max_emit, ("emit_iters", "emit_iters_live"))
        chunks = sum(s.chunk_idx for s in self.slots
                     if s.stream_id is not None) + len(fired)
        count("serving.plane_rows_visible",
              chunks * self.n_main + n_flushed * self.rc)

    def drain(self) -> None:
        """Run steps until every admitted stream has finished (requires all
        of them to have been end-pushed)."""
        while self._by_id:
            if not any(self._ready(s) for s in self.slots):
                stuck = [s.stream_id for s in self.slots
                         if s.stream_id is not None]
                raise RuntimeError(
                    f"streams {stuck} are stalled (not ended and no "
                    "buffered audio)")
            self.step()

    def result(self, stream_id: str):
        return self._results[stream_id]
