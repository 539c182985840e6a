"""Batched multi-stream greedy streaming decode over the cached CAAT path.

Port of ``CachedFusedGreedyDecoder`` (``wav2vec_s_tpu/stream/batched.py``):
N streams run in lockstep; per chunk of ``n_main`` new frames
  1. the int16 (or float32) window is converted on the device,
  2. the incremental encoder step runs the conv front-end and every encoder
     layer (chunk attention: the hand-written kernel on CUDA),
  3. the committed frames are projected to jointer K/V and appended,
  4. ``max_emit`` greedy emissions run against the slot-aligned LM cache
     and the one-query jointer.
Nothing is read back to the host inside the chunk loop: per-chunk prefix
lengths are stacked on the device and fetched once at the end.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from wav2vec_s_tpu_torch.models.modules import compute_copy
from wav2vec_s_tpu_torch.stream import caat_step
from wav2vec_s_tpu_torch.stream.incremental import IncrementalBlockwiseEncoder


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

    def _make_greedy(self):
        """Greedy emission loop over cached jointer K/V + slot LM state.

        The JAX decoder runs a ``while_loop`` that exits once every stream
        has emitted blank; in eager torch that test is a host sync per
        emission.  This runs the fixed ``max_emit`` iterations with masked
        updates instead — blocked streams never write, so the emissions are
        the same (the JAX package documents and tests this equivalence for
        its "unroll" loop)."""
        model, caat = self.model, self.model.cfg
        blank, pad = self.vocab.bos(), self.vocab.pad()
        max_emit, max_len = self.max_emit, self.max_len

        def greedy(prefixes, lens, lm, jk, jv, visible):
            rows = torch.arange(prefixes.shape[0], device=prefixes.device)
            blocked = torch.zeros_like(lens, dtype=torch.bool)
            for _ in range(max_emit):
                lp = caat_step.jointer_step(model, caat, lm.h_last, jk, jv,
                                            visible)
                lp[:, pad] = -float("inf")
                tok = torch.argmax(lp, dim=-1)   # first maximum, as jnp
                emit = ~blocked & (tok != blank) & (lens < max_len)
                prefixes[rows, lens] = torch.where(emit, tok,
                                                   prefixes[rows, lens])
                lm = caat_step.lm_slot_step(model, caat, lm, tok, lens, emit)
                lens = lens + emit
                blocked = blocked | ~emit
            return prefixes, lens, lm

        return greedy

    def _texts_and_delays(self, prefixes, lens_hist, n_chunks, stride, W, N):
        """Per-chunk delay bookkeeping + surface assembly (host)."""
        vocab = self.vocab
        lens_all = np.asarray(lens_hist)
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
        enc = self._encoder(N)
        hop, W, n_main, rc = enc.hop, enc.window, enc.n_main, self.rc
        int16 = self.transfer_dtype == "int16"
        total_frames = (max_samples - enc.rf) // hop + 1
        n_chunks = max((total_frames - rc) // n_main, 1)
        stride = n_main * hop
        # LM cache slots: bos + one per greedy iteration of the chunk loop
        n_slots = -(-(n_chunks * self.max_emit + 1) // 8) * 8

        model, vocab = self.model, self.vocab
        caat = model.cfg
        t_cap, dev = self.t_cap, self.device
        estate = enc.init()
        cdtype = estate.out_cache.dtype
        jk = [torch.zeros((t_cap, N, caat.jointer_embed_dim), dtype=cdtype,
                          device=dev) for _ in range(caat.jointer_layers)]
        jv = [torch.zeros_like(k) for k in jk]
        prefixes = torch.full((N, self.max_len + 1), vocab.pad(),
                              dtype=torch.long, device=dev)
        prefixes[:, 0] = vocab.bos()
        lens = torch.ones(N, dtype=torch.long, device=dev)
        lm = caat_step.lm_slot_init(model, caat, N, n_slots)
        greedy = self._make_greedy()

        # cache capacity per chunk, in steps of seg rows: early chunks
        # attend only a prefix of the encoder/jointer K/V buffers (a free
        # view in torch; the JAX package compiled one scan per capacity)
        seg = 256

        def cap_of(v):
            return min(-(-v // seg) * seg, t_cap)

        hist = []
        for k in range(n_chunks):
            flush = k == n_chunks - 1
            n_new = n_main + rc if flush else n_main
            cap = cap_of(k * n_main + n_new)
            win = audio[:, k * stride:k * stride + W]
            win = win.float() / 32768.0 if int16 else win
            t0 = estate.t_main
            estate = enc.step_fn_cap(cap, flush=flush)(estate, win)
            k_new, v_new = caat_step.jointer_kv(
                model, caat, estate.out_cache[t0:t0 + n_new])
            caat_step.jointer_kv_append(jk, jv, k_new, v_new, t0)
            visible = torch.full((N,), estate.t_main, device=dev)
            prefixes, lens, lm = greedy(prefixes, lens, lm,
                                        [x[:cap] for x in jk],
                                        [x[:cap] for x in jv], visible)
            hist.append(lens)
        lens_hist = torch.stack(hist).cpu()
        return self._texts_and_delays(prefixes.cpu(), lens_hist, n_chunks,
                                      stride, W, N)
