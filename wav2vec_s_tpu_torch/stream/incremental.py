"""Incremental blockwise encoder with device-side K/V caches (torch).

Port of ``wav2vec_s_tpu/stream/incremental.py``: one step processes
``n_main = mc * blocks_per_step`` new frames plus the ``rc`` look-ahead for
every stream in the batch.  Per layer, the chunk rows attend the committed
cache rows (< t0) and the chunk itself under the intra-chunk block mask —
``ops.chunk_attention.chunk_cache_attention``, the hand-written kernel on
CUDA tensors — and the main frames' K/V append to fixed-capacity cache
buffers (look-ahead K/V are never committed, except at the final flush).

Layout, as in the JAX package: per-layer TIME-MAJOR ``[T_cap, N, D]``
buffers, one tensor per layer.  Appends write the buffers IN PLACE, so a
step returns the same state object, advanced.  ``t_main`` is a host int
(``k * n_main`` after k steps): reading it never syncs with the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from wav2vec_s_tpu_torch.models.feature_extractor import conv_receptive_stride
from wav2vec_s_tpu_torch.models.modules import (
    attn_input, dense, gelu, layer_tail, ln)
from wav2vec_s_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from wav2vec_s_tpu_torch.ops.block_mask import MASK_VALUE
from wav2vec_s_tpu_torch.ops.chunk_attention import chunk_cache_attention
from wav2vec_s_tpu_torch.utils.positional import POS_OFFSET, sinusoidal_table


@dataclasses.dataclass
class IncrementalEncoderState:
    k_cache: List[torch.Tensor]   # per layer [T_cap, N, D], time-major
    v_cache: List[torch.Tensor]
    out_cache: torch.Tensor       # [T_cap, N, D_out] encoder outputs
    t_main: int                   # frames committed so far


def init_state(n_streams: int, n_layers: int, dim: int, t_cap: int,
               dtype=torch.float32, out_dim: Optional[int] = None,
               device=None) -> IncrementalEncoderState:
    def z(d):
        return torch.zeros((t_cap, n_streams, d), dtype=dtype, device=device)

    return IncrementalEncoderState(
        k_cache=[z(dim) for _ in range(n_layers)],
        v_cache=[z(dim) for _ in range(n_layers)],
        out_cache=z(out_dim or dim), t_main=0)


def chunk_layout(mc: int, rc: int, blocks: int):
    """Row layout of one step and its intra-chunk bias.

    Rows are [main frames (n_main); copies of block j's look-ahead frames
    [(j+1)mc, (j+1)mc+rc) for j = 0..blocks-1], each copy processed with
    block-j context (the training-mask semantics).  Main keys are visible to
    rows of the same or a later block, copy keys only within their block.
    Returns (copy_src [blocks*rc] frame index of each copy row,
    intra_bias [R, R] float32)."""
    n_main = mc * blocks
    copy_src = (np.concatenate([np.arange((j + 1) * mc, (j + 1) * mc + rc)
                                for j in range(blocks)])
                if rc else np.zeros(0, np.int64))
    row_block = np.concatenate(
        [np.arange(n_main) // mc, np.repeat(np.arange(blocks), rc)])
    key_is_copy = np.concatenate(
        [np.zeros(n_main, bool), np.ones(blocks * rc, bool)])
    allowed = np.where(key_is_copy[None, :],
                       row_block[:, None] == row_block[None, :],
                       row_block[:, None] >= row_block[None, :])
    intra_bias = np.where(allowed, 0.0, MASK_VALUE).astype(np.float32)
    return copy_src, intra_bias


class IncrementalBlockwiseEncoder:
    """Binds a ``Wav2Vec2Model`` (its device and parameters) to the step."""

    def __init__(self, w2v_cfg: Wav2Vec2Config, model: Wav2Vec2Model,
                 n_streams: int, t_cap: int = 2048, blocks_per_step: int = 1,
                 proj: Optional[nn.Linear] = None):
        if w2v_cfg.extractor_mode != "layer_norm":
            raise ValueError(
                "incremental streaming needs the stateless (layer-norm) conv "
                "front-end; 'default' group-norm normalizes over time")
        self.cfg = w2v_cfg
        self.model = model
        self.device = model.layer_norm.weight.device
        self.dtype = w2v_cfg.compute_dtype
        self.n = n_streams
        self.t_cap = t_cap
        self.mc = w2v_cfg.main_context
        self.rc = w2v_cfg.right_context
        # DECISION_STEP: blocks advanced per step (reference
        # --step-read-blocks)
        self.blocks = blocks_per_step
        self.n_main = self.mc * blocks_per_step
        rf, hop = conv_receptive_stride(w2v_cfg.conv_feature_layers)
        self.hop, self.rf = hop, rf
        # samples covering frames [t, t + n_main + rc)
        self.window = (self.n_main + self.rc - 1) * hop + rf
        self._table = sinusoidal_table(
            t_cap + POS_OFFSET + 2, w2v_cfg.encoder_embed_dim,
            self.device).to(self.dtype)
        # optional --use-linear-layer projection of the committed rows
        self.proj = proj
        self.out_dim = (proj.out_features if proj is not None
                        else w2v_cfg.encoder_embed_dim)
        copy_src, intra_bias = chunk_layout(self.mc, self.rc, self.blocks)
        self._copy_src = torch.as_tensor(copy_src, device=self.device)
        self._intra_bias = torch.as_tensor(intra_bias, device=self.device)

    def init(self) -> IncrementalEncoderState:
        return init_state(self.n, self.cfg.encoder_layers,
                          self.cfg.encoder_embed_dim, self.t_cap, self.dtype,
                          out_dim=self.out_dim, device=self.device)

    def step_fn_cap(self, kv_cap: int, flush: bool = False):
        """Step whose cache attention sees only the first ``kv_cap`` cache
        rows — valid while t_main <= kv_cap.  In torch the ``[:kv_cap]``
        slice is a free view (the kernel reads only rows < t0 anyway); the
        plain twin computes over exactly ``kv_cap`` rows, as XLA did."""
        return lambda state, window: self._step(state, window, flush, kv_cap)

    def step(self, state: IncrementalEncoderState, window: torch.Tensor,
             flush: bool = False) -> IncrementalEncoderState:
        """window: [N, self.window] samples for frames
        [t_main, t_main + n_main + rc); flush=True also commits the
        look-ahead frames (end of stream)."""
        return self._step(state, window, flush, self.t_cap)

    @torch.no_grad()
    def _step(self, state, window, flush, kv_cap):
        c = self.cfg
        m = self.model
        n_main, rc = self.n_main, self.rc
        n_frames = n_main + rc
        n_rows = n_main + self.blocks * rc
        n_keep = n_main + rc if flush else n_main
        t0 = state.t_main
        if (t0 + n_keep > self.t_cap
                or t0 + POS_OFFSET + n_frames > self._table.shape[0]):
            raise ValueError(f"a step at t0={t0} does not fit "
                             f"t_cap={self.t_cap}")

        window = torch.as_tensor(window, device=self.device)
        feats = m.feature_extractor(window, self.dtype)[:, :n_frames]
        feats = ln(m.layer_norm, feats)
        if m.post_extract_proj is not None:
            feats = dense(m.post_extract_proj, feats)
        # positions: global frame index + fairseq offset
        feats = feats + self._table[t0 + POS_OFFSET:t0 + POS_OFFSET + n_frames]
        if not c.layer_norm_first:
            feats = ln(m.encoder.layer_norm, feats)
        # chunk rows: main frames + per-block look-ahead copies
        x = torch.cat([feats[:, :n_main], feats[:, self._copy_src]], dim=1)

        H = c.encoder_attention_heads
        scale = (c.encoder_embed_dim // H) ** -0.5
        for i, layer in enumerate(m.encoder.layers):
            att = layer.self_attn
            h_in = attn_input(layer, x, c.layer_norm_first)
            q = dense(att.q_proj, h_in) * scale
            k_new = dense(att.k_proj, h_in)
            v_new = dense(att.v_proj, h_in)
            o = chunk_cache_attention(
                q, state.k_cache[i][:kv_cap], state.v_cache[i][:kv_cap],
                k_new, v_new, self._intra_bias, t0, H)
            h = dense(att.out_proj, o)
            # cache the main frames' K/V (+ final look-ahead at flush):
            # written in place, after this layer's attention read the cache
            for cache, new in ((state.k_cache[i], k_new),
                               (state.v_cache[i], v_new)):
                cache[t0:t0 + n_keep] = self._keep(new, n_rows, flush)
            x = layer_tail(layer, x, h, c.layer_norm_first, gelu)

        # pre-LN: the post-stack norm (wav2vec2.py:869)
        x_out = ln(m.encoder.layer_norm, x) if c.layer_norm_first else x
        commit = self._keep(x_out, n_rows, flush)
        if self.proj is not None:
            commit = dense(self.proj, commit)      # --use-linear-layer
        state.out_cache[t0:t0 + n_keep] = commit
        state.t_main = t0 + n_keep
        return state

    def _keep(self, rows: torch.Tensor, n_rows: int, flush: bool):
        """Committed rows of a chunk, time-major: the main frames, plus the
        last block's look-ahead copies at the flush."""
        kept = rows[:, :self.n_main]
        if flush and self.rc:
            kept = torch.cat([kept, rows[:, n_rows - self.rc:]], dim=1)
        return kept.transpose(0, 1)
