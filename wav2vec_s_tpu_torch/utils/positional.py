"""Sinusoidal positional tables with fairseq-compatible indexing.

Copy of the numpy table of ``wav2vec_s_tpu/utils/positional.py``: row ``p``
holds the embedding of absolute position ``p``, the first real frame uses
row ``PADDING_IDX + 1 = 2`` and row ``PADDING_IDX`` is all zeros; and the
lookup of the full-sequence encoder, ``sinusoidal_positions_from_padding``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PADDING_IDX = 1
POS_OFFSET = PADDING_IDX + 1  # first real position uses row 2


@functools.lru_cache(maxsize=16)
def _sinusoidal_table_np(num_embeddings: int, dim: int) -> np.ndarray:
    """fairseq-layout sinusoidal table: [sin | cos] halves, zero pad row."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * -(np.log(10000.0) / (half - 1)))
    args = np.arange(num_embeddings, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_embeddings, 1))], axis=1)
    table[PADDING_IDX, :] = 0.0
    return table.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _table_on(num_embeddings: int, dim: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_sinusoidal_table_np(num_embeddings, dim)).to(device)


def sinusoidal_table(num_embeddings: int, dim: int,
                     device=None) -> torch.Tensor:
    """[num_embeddings, dim] float32 table on ``device``; one copy per
    device is kept, so callers must not write into it."""
    return _table_on(num_embeddings, dim, str(torch.device(device or "cpu")))


def sinusoidal_positions_from_padding(padding_mask: torch.Tensor, dim: int,
                                      dtype=torch.float32) -> torch.Tensor:
    """[B, T, dim] embeddings for a [B, T] bool padding mask (True = pad):
    the i-th non-pad frame gets row ``i + 2``, pad frames the zero row
    (fairseq ``make_positions`` on the bool mask)."""
    T = padding_mask.shape[1]
    nonpad = (~padding_mask).long()
    positions = torch.cumsum(nonpad, dim=1) * nonpad + PADDING_IDX
    table = sinusoidal_table(T + POS_OFFSET + 1, dim, padding_mask.device)
    return table[positions].to(dtype)
