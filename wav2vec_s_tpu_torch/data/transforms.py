"""Feature transforms for the fbank pipeline (own copy of
``wav2vec_s_tpu/data/transforms.py``; ``TFMask`` draws from its seeded
generator in the same order, so both packages mask the same cells).

Twins of rain/data/transforms/audio_encoder.py:42-79: ``Whiten``
(global mean/variance normalization with optional per-utterance fallback)
and ``TFMask`` (SpecAugment-style time/frequency masking).
Host-side numpy, applied in the collater.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Whiten:
    mean: Optional[np.ndarray] = None       # [F] global stats, else per-utt
    std: Optional[np.ndarray] = None

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        if self.mean is not None:
            return ((feats - self.mean) / np.maximum(self.std, 1e-5)
                    ).astype(np.float32)
        m = feats.mean(axis=0, keepdims=True)
        s = feats.std(axis=0, keepdims=True)
        return ((feats - m) / np.maximum(s, 1e-5)).astype(np.float32)


@dataclasses.dataclass
class TFMask:
    """SpecAugment time/frequency masking (training only)."""

    num_time_masks: int = 2
    max_time: int = 40
    num_freq_masks: int = 2
    max_freq: int = 27
    seed: int = 1

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        T, F = feats.shape
        out = feats.copy()
        fill = out.mean()
        for _ in range(self.num_time_masks):
            w = int(self._rng.integers(0, min(self.max_time, max(T // 5, 1)) + 1))
            if w:
                t0 = int(self._rng.integers(0, T - w + 1))
                out[t0:t0 + w] = fill
        for _ in range(self.num_freq_masks):
            w = int(self._rng.integers(0, min(self.max_freq, F - 1) + 1))
            if w:
                f0 = int(self._rng.integers(0, F - w + 1))
                out[:, f0:f0 + w] = fill
        return out
