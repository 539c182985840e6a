"""Block-wise bounded-context attention layout (the wav2vec-S mechanism).

Port of ``wav2vec_s_tpu/ops/block_mask.py``:

- the sequence is cut into blocks of ``main_context`` (mc) frames;
- every full block ``b`` gets ``right_context`` (rc) look-ahead copies of
  frames ``[(b+1)*mc, (b+1)*mc + rc)``, appended after the T frames
  (length ``T + rc * (T // mc)``); a copy past the end points at the last
  frame and is treated as padding;
- an original frame of block ``b`` attends to the original frames of blocks
  ``<= b`` and to the copies of block ``b``; the copies of block ``b`` behave
  like members of block ``b``.

The layout is a numpy table, computed once per ``(T, mc, rc)`` and cached.
Masks are additive ``-1e4`` biases, not ``-inf``: a fully masked row stays
finite (reference unidirect_w2v2_encoder.py:155-159).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

MASK_VALUE = -1e4


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    seq_len: int
    main_context: int
    right_context: int
    num_blocks: int           # number of blocks that receive rc copies
    rc_len: int               # total appended frames R = rc * num_blocks
    rc_idx: np.ndarray        # [R] source index of each rc copy (clamped)
    rc_invalid: np.ndarray    # [R] True where the copy points past the end
    allowed: np.ndarray       # [T+R, T+R] True = query row may attend to key

    @property
    def total_len(self) -> int:
        return self.seq_len + self.rc_len


@functools.lru_cache(maxsize=64)
def block_layout(seq_len: int, main_context: int,
                 right_context: int) -> BlockLayout:
    T, mc, rc = seq_len, main_context, right_context
    block_idx = np.arange(T) // mc
    if rc == 0:
        allowed = block_idx[:, None] >= block_idx[None, :]
        return BlockLayout(T, mc, rc, 0, 0, np.zeros(0, np.int32),
                           np.zeros(0, bool), allowed)

    num_blocks = T // mc
    rc_block = np.repeat(np.arange(num_blocks), rc)                 # [R]
    rc_idx = ((np.arange(num_blocks)[:, None] + 1) * mc
              + np.arange(rc)[None, :]).reshape(-1)                 # [R]
    rc_invalid = rc_idx > (T - 1)
    rc_idx = np.clip(rc_idx, 0, T - 1)

    full_idx = np.concatenate([block_idx, rc_block])                # [T+R]
    # original keys: a query of (effective) block q sees frame k iff
    # q >= block(k); copy keys only within their own block
    allowed = np.concatenate([full_idx[:, None] >= block_idx[None, :],
                              full_idx[:, None] == rc_block[None, :]], axis=1)
    return BlockLayout(T, mc, rc, num_blocks, rc * num_blocks,
                       rc_idx.astype(np.int32), rc_invalid, allowed)


def append_right_context(x: torch.Tensor, layout: BlockLayout) -> torch.Tensor:
    """[B, T, D] -> [B, T+R, D]: append the look-ahead copies (one gather)."""
    if layout.rc_len == 0:
        return x
    idx = torch.as_tensor(layout.rc_idx, dtype=torch.long, device=x.device)
    return torch.cat([x, x[:, idx]], dim=1)


def strip_right_context(x: torch.Tensor, layout: BlockLayout) -> torch.Tensor:
    """[B, T+R, D] -> [B, T, D] after the layer stack (wav2vec_S.py:426-427)."""
    return x[:, :layout.seq_len]


def extend_padding_mask(padding_mask: torch.Tensor,
                        layout: BlockLayout) -> torch.Tensor:
    """[B, T] bool (True = pad) -> [B, T+R]; copies past the end are pad."""
    if layout.rc_len == 0:
        return padding_mask
    dev = padding_mask.device
    idx = torch.as_tensor(layout.rc_idx, dtype=torch.long, device=dev)
    invalid = torch.as_tensor(layout.rc_invalid, device=dev)
    return torch.cat([padding_mask, padding_mask[:, idx] | invalid[None]],
                     dim=1)


def block_attn_bias(layout: BlockLayout,
                    padding_mask: torch.Tensor | None = None,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive attention bias: [1, 1, S, S] (structure only) or
    [B, 1, S, S] with a [B, T] padding mask, S = T + R; masked entries
    hold ``MASK_VALUE``."""
    if padding_mask is not None:
        device = padding_mask.device
    allowed = torch.as_tensor(layout.allowed, device=device)
    bias = torch.where(allowed, 0.0, MASK_VALUE).to(dtype)[None, None]
    if padding_mask is not None:
        ext = extend_padding_mask(padding_mask, layout)
        key_bias = torch.where(ext, MASK_VALUE, 0.0).to(dtype)
        bias = bias + key_bias[:, None, None, :]
    return bias
