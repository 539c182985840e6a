"""Streaming engine of the fbank CAAT family (torch port of
``wav2vec_s_tpu/stream/fbank_engine.py``; SURVEY §2.3's
``OnlineSpeechModels`` / ``TransducerAgent`` rows).

The reference's fbank agents cannot re-featurize from raw audio inside the
model (fbank is a host-side transform), so ``OnlineSpeechModels`` keeps a
chunked carry-over extractor: each read appends the new samples, converts
exactly the frames whose 25 ms windows are complete, and carries the
residual samples forward (rain/simul/transducer_agent.py:170-237).
``IncrementalFbank`` is that component (own copy of the JAX one, host
numpy): its frames over any chunking equal the offline ``logmel_fbank``.

``FbankStreamingEngine`` mirrors ``StreamingEngine``'s recompute-over-
buckets design on the feature prefix: a bucketed blockwise encode with the
right-context tail trimmed while the stream is open, and ``decode_scores``
through ``FbankCaatModel.decode_step``; eager torch on the model's device.
It plugs into the same ``StreamingTransducerSearcher`` +
``SpeechTransducerAgent`` + ``SimulEvaluator`` stack as the raw-audio path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from wav2vec_s_tpu_torch.data.audio import FRAME, SHIFT, fbank_frames
from wav2vec_s_tpu_torch.data.batching import bucket_for


class IncrementalFbank:
    """Chunked log-mel extraction with sample carry-over.

    ``push(samples)`` returns the newly completed frames; the
    concatenation over any chunking equals ``logmel_fbank(full_signal)``
    exactly (same windows, same pre-emphasis including the cross-chunk
    previous-sample term).
    """

    def __init__(self):
        self.buf = np.zeros(0, np.float32)
        self.n_frames = 0

    def push(self, samples: np.ndarray) -> np.ndarray:
        self.buf = np.concatenate(
            [self.buf, np.asarray(samples, np.float32)])
        if len(self.buf) < FRAME:
            return np.zeros((0, 80), np.float32)
        total = 1 + (len(self.buf) - FRAME) // SHIFT
        if total <= self.n_frames:
            return np.zeros((0, 80), np.float32)
        feats = fbank_frames(self.buf, self.n_frames * SHIFT,
                             total - self.n_frames)
        self.n_frames = total
        return feats


class FbankStreamingEngine:
    """``StreamingEngine`` twin over fbank features (``FbankCaatModel``).
    Feature prefixes are padded to ``feature_buckets`` and token prefixes
    to ``token_buckets``, as the JAX engine pads them for its compiled
    shapes (the padding changes the rounding, so the port keeps it)."""

    def __init__(self, model, main_context: int = 4,
                 right_context: int = 2, subsample: int = 4,
                 feature_buckets: Optional[Sequence[int]] = None,
                 token_buckets: Sequence[int] = (16, 32, 64, 128, 256),
                 max_frames: int = 6000):
        self.model = model
        self.device = model.token_embedding().device
        self.mc, self.rc = main_context, right_context
        self.subsample = subsample
        if feature_buckets is None:
            step = main_context * subsample
            feature_buckets = [step * i for i in range(1, 26)]
            v = feature_buckets[-1]
            while v < max_frames:
                v = int(v * 1.25) // step * step + step
                feature_buckets.append(v)
        self.feature_buckets = list(feature_buckets)
        self.token_buckets = list(token_buckets)
        # per-utterance carry-over extractor state; reset() is called by
        # the agent at utterance start (the prefix-shrink test in
        # encode_prefix stays as a fallback: it alone misses a new
        # utterance whose first prefix is >= the previous total length)
        self.reset()

    def reset(self):
        """Clear the carry-over featurizer (call at utterance start)."""
        self._inc = IncrementalFbank()
        self._feats = np.zeros((0, 80), np.float32)

    def encode_prefix(self, audio: np.ndarray, finished: bool):
        """audio: the FULL sample prefix so far -> (enc [T_eff, D], T_eff).

        Features are extended chunked (only the new samples are
        featurized); the encode recomputes over the feature prefix at a
        bucketed length, trimming the rc look-ahead while open.
        """
        if len(audio) < len(self._inc.buf):          # new utterance
            self.reset()
        new = self._inc.push(np.asarray(audio[len(self._inc.buf):],
                                        np.float32))
        if len(new):
            self._feats = np.concatenate([self._feats, new])
        T = len(self._feats)
        if T == 0:
            D = self.model.enc_cfg.encoder_embed_dim
            return np.zeros((0, D), np.float32), 0
        Tp = bucket_for(T, self.feature_buckets)
        buf = np.zeros((1, Tp, 80), np.float32)
        buf[0, :T] = self._feats
        pad = torch.arange(Tp, device=self.device)[None, :] >= T
        enc, _ = self.model.encode(torch.from_numpy(buf).to(self.device),
                                   pad, self.mc, self.rc)
        t = T // self.subsample
        if not finished:
            t = max(t - self.rc, 0)
        return enc[0, :t].float().cpu().numpy(), t

    def decode_scores(self, prefixes: np.ndarray, lens: np.ndarray,
                      enc: np.ndarray, visible: int) -> np.ndarray:
        """prefixes [K, U] right-padded ids; enc [T, D] encoded frames;
        ``visible`` frames revealed to the jointer -> log-probs [K, V], a
        writable host array."""
        K, U = prefixes.shape
        U_pad = bucket_for(U, self.token_buckets)
        toks = np.full((K, U_pad), self.model.cfg.pad, np.int64)
        toks[:, :U] = prefixes
        T = enc.shape[0]
        S = bucket_for(max(T, 1),
                       [b // self.subsample for b in self.feature_buckets])
        enc_buf = np.zeros((K, S, enc.shape[1]), np.float32)
        enc_buf[:, :T] = enc[None]
        mask = np.ones((K, S), bool)
        mask[:, :min(visible, T)] = False
        dev = self.device
        out = self.model.decode_step(
            torch.from_numpy(toks).to(dev),
            torch.from_numpy(lens.astype(np.int64)).to(dev),
            torch.from_numpy(enc_buf).to(dev, self.model.cfg.compute_dtype),
            torch.from_numpy(mask).to(dev))
        return out.cpu().numpy()
