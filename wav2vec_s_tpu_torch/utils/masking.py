"""Span-mask sampling for masked contrastive pre-training (port of
``wav2vec_s_tpu/utils/masking.py``).

Behavioral twin of the reference's numpy ``compute_mask_indices``
(fairseq/fairseq/data/data_utils.py, used at wav2vec2.py:431-443 with
``mask_prob=0.65, mask_length=10, mask_selection="static",
min_masks=2``):

- ``compute_span_mask_np``: host-side numpy, run by the batcher while it
  assembles a batch; a copy of the JAX package's, so one
  ``np.random.Generator`` gives the same mask bit for bit;
- ``sample_span_mask``: a torch version with a static number of span
  starts per row, drawn from an explicit ``torch.Generator`` (the JAX
  package's in-jit twin; no path of either package calls it).

Both sample exactly ``num_spans = int(mask_prob * T / L + rand)`` span
starts with overlap allowed; the batcher then pins every row to
``expected_mask_count`` masked frames, so the model gathers a fixed
``[B, M]`` of positions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def num_mask_spans(seq_len: int, mask_prob: float, mask_length: int,
                   min_masks: int = 2, rand: float = 0.0) -> int:
    """Number of span starts the reference samples for a row of
    ``seq_len``."""
    all_num_mask = int(mask_prob * seq_len / float(mask_length) + rand)
    return max(min_masks, all_num_mask)


def expected_mask_count(seq_len: int, mask_prob: float = 0.65,
                        mask_length: int = 10, min_masks: int = 2) -> int:
    """Fixed per-length mask count (overlap makes the reference's realised
    count vary around ~0.8 * n_spans * L; pinning it keeps the gather shape
    of every batch of one length the same)."""
    n_spans = num_mask_spans(seq_len, mask_prob, mask_length, min_masks)
    approx = int(round(n_spans * mask_length * 0.8))
    return max(mask_length, min(approx, seq_len - 1))


def compute_span_mask_np(
    shape: tuple[int, int],
    padding_mask: Optional[np.ndarray],
    mask_prob: float,
    mask_length: int,
    rng: np.random.Generator,
    min_masks: int = 2,
    require_same_masks: bool = True,
    exact_count: Optional[int] = None,
) -> np.ndarray:
    """Sample a [B, T] boolean span mask (True = masked).

    Static span selection with overlap allowed; with ``require_same_masks``
    every row ends up with the batch's smallest count of masked frames;
    with ``exact_count`` every row is trimmed or topped up to exactly that
    many (at most its length - 1)."""
    B, T = shape
    mask = np.zeros((B, T), dtype=bool)
    rand_add = rng.random()
    for b in range(B):
        sz = T
        if padding_mask is not None:
            sz = int(T - padding_mask[b].sum())
        num_mask = num_mask_spans(sz, mask_prob, mask_length, min_masks,
                                  rand_add)
        hi = max(1, sz - mask_length)
        starts = rng.integers(0, hi, size=num_mask)
        idx = (starts[:, None] + np.arange(mask_length)[None, :]).reshape(-1)
        idx = idx[idx < sz]
        mask[b, idx] = True
    if exact_count is not None:
        for b in range(B):
            sz = T
            if padding_mask is not None:
                sz = int(T - padding_mask[b].sum())
            want = min(exact_count, max(sz - 1, 1))
            on = np.flatnonzero(mask[b])
            if len(on) > want:
                off = rng.choice(on, size=len(on) - want, replace=False)
                mask[b, off] = False
            elif len(on) < want:
                cand = np.flatnonzero(~mask[b][:sz])
                add = rng.choice(cand, size=want - len(on), replace=False)
                mask[b, add] = True
        return mask
    if require_same_masks:
        n_min = mask.sum(axis=1).min()
        for b in range(B):
            extra = int(mask[b].sum() - n_min)
            if extra > 0:
                on = np.flatnonzero(mask[b])
                off = rng.choice(on, size=extra, replace=False)
                mask[b, off] = False
    return mask


def sample_span_mask(
    generator: torch.Generator,
    shape: tuple[int, int],
    padding_mask: Optional[torch.Tensor],
    mask_prob: float,
    mask_length: int,
    min_masks: int = 2,
) -> torch.Tensor:
    """[B, T] bool span mask with a static number of span starts per row
    (the count of the full row length: pre-training rows are cropped to
    one length), drawn from ``generator`` on its device; padded frames are
    never masked."""
    B, T = shape
    n_spans = num_mask_spans(T, mask_prob, mask_length, min_masks)
    hi = max(1, T - mask_length)
    starts = torch.randint(0, hi, (B, n_spans), generator=generator,
                           device=generator.device)
    span = (starts[:, :, None] + torch.arange(
        mask_length, device=starts.device)[None, None, :]).reshape(B, -1)
    # spans may run past T only when T <= mask_length: a wider row takes
    # them, and the columns past T are cut (JAX: one_hot of an index >= T)
    mask = torch.zeros((B, T + mask_length), dtype=torch.bool,
                       device=starts.device)
    mask = mask.scatter_(1, span, True)[:, :T]
    if padding_mask is not None:
        mask = mask & ~padding_mask.to(mask.device)
    return mask
