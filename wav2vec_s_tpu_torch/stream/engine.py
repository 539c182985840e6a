"""Inference engine of the host beam searcher (torch).

Port of ``wav2vec_s_tpu/stream/engine.py``: the CAAT model behind the two
calls ``stream/searcher.StreamingTransducerSearcher`` makes (the MMA agent,
``stream/mma_agent.py``, uses the encoder call alone),

- ``encode_prefix(prefix_audio, finished)`` — full-prefix blockwise encode
  with the right-context tail trimmed while the stream is open.  The
  block-attention layout bounds every frame's context to its own block +
  rc look-ahead, so the full-prefix re-encode produces the frames a cached
  incremental encoder commits;
- ``decode_scores(prefixes, lens, enc, visible)`` — next-symbol log-probs
  for a beam of prefixes through ``W2V2CaatModel.decode_step``
  (recompute-over-cache likewise).

Audio prefixes and token prefixes are padded to geometric buckets, as in
the JAX package, where the buckets bound the number of compiled shapes:
the padding changes the float rounding of a result, so the port keeps it
and with it the values the searcher sees.  The model carries its parameters
and its device; arrays cross the interface as numpy, float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from wav2vec_s_tpu_torch.data.batching import bucket_for
from wav2vec_s_tpu_torch.models.feature_extractor import (
    conv_output_length, conv_receptive_stride)


class StreamingEngine:
    def __init__(self, model, main_context: int = 16,
                 right_context: int = 8,
                 audio_buckets: Optional[Sequence[int]] = None,
                 token_buckets: Sequence[int] = (16, 32, 64, 128, 256),
                 max_audio_sec: float = 60.0):
        self.model = model
        self.device = next(model.parameters()).device
        self.mc, self.rc = main_context, right_context
        # frame accounting follows the model's conv stack (default: 320
        # samples per frame), not a hardcoded hop
        self.conv_layers = model.w2v_cfg.conv_feature_layers
        _, hop = conv_receptive_stride(self.conv_layers)
        if audio_buckets is None:
            # one bucket per main-context step up to ~8 s, then geometric
            step = self.mc * hop
            audio_buckets = [step * i for i in range(1, 26)]
            v = audio_buckets[-1]
            while v < max_audio_sec * 16000:
                v = int(v * 1.25) // step * step + step
                audio_buckets.append(v)
        self.audio_buckets = list(audio_buckets)
        self.token_buckets = list(token_buckets)

    # -- encoder -------------------------------------------------------
    def encode_prefix(self, audio: np.ndarray, finished: bool):
        """audio: [n] float32 prefix -> (enc [T_eff, D] float32, T_eff).

        Trims the trailing right-context frames while not finished."""
        n = len(audio)
        S = bucket_for(n, self.audio_buckets)
        buf = np.zeros((1, S), np.float32)
        buf[0, :n] = audio
        pad = torch.arange(S, device=self.device)[None, :] >= n
        enc, _ = self.model.encode(torch.from_numpy(buf).to(self.device),
                                   pad, self.mc, self.rc)
        t = conv_output_length(n, self.conv_layers)
        if not finished:
            t = max(t - self.rc, 0)
        return enc[0, :t].float().cpu().numpy(), t

    # -- decoder -------------------------------------------------------
    def decode_scores(self, prefixes: np.ndarray, lens: np.ndarray,
                      enc: np.ndarray, visible: int) -> np.ndarray:
        """prefixes: [K, U] right-padded ids; enc: [T, D] encoded frames;
        ``visible``: number of frames revealed to the jointer.  Returns
        log-probs [K, V], a writable host array (the searcher overwrites
        columns)."""
        K, U = prefixes.shape
        U_pad = bucket_for(U, self.token_buckets)
        toks = np.full((K, U_pad), self.model.cfg.pad, np.int64)
        toks[:, :U] = prefixes
        T = enc.shape[0]
        S = bucket_for(max(T, 1), [conv_output_length(b, self.conv_layers)
                                   for b in self.audio_buckets])
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


class EnsembleEngine:
    """Model ensemble for streaming decode (twin of rain's ``OnlineModels``,
    rain/simul/transducer_agent.py:22-167): per-model encoders, next-symbol
    distributions averaged in probability space (logsumexp - log N, the
    fairseq EnsembleModel rule).  Drop-in for ``StreamingEngine``: the
    searcher treats the encoder state as opaque."""

    def __init__(self, engines):
        assert engines, "need at least one engine"
        self.engines = list(engines)

    def encode_prefix(self, audio, finished: bool):
        outs = [e.encode_prefix(audio, finished) for e in self.engines]
        t_eff = outs[0][1]
        assert all(o[1] == t_eff for o in outs), "encoders disagree on length"
        return [o[0] for o in outs], t_eff

    def decode_scores(self, prefixes, lens, encs, visible):
        lps = np.stack([
            e.decode_scores(prefixes, lens, enc, visible)
            for e, enc in zip(self.engines, encs)])
        m = lps.max(axis=0)
        return m + np.log(np.exp(lps - m).mean(axis=0))
