"""wait-k simultaneous baseline (torch port of
``wav2vec_s_tpu/models/waitk.py``).

Twin of rain's wait-k stack (rain/layers/waitk_decoder.py:27-325, models
waitk_transformer.py:68-137, agent rain/simul/waitk_agent.py): the
seq2seq model of ``models/asr.py`` on the blockwise wav2vec-S encoder,
whose target step i may only cross-attend to the first
``(i + k) * stride`` source frames.  Parameter names are those of the
port's ``Wav2Vec2Seq2Seq`` (``encoder.w2v2_model.*``,
``decoder.embed_tokens``, ``decoder.layers.{i}.*``, ``decoder.layer_norm``
when pre-LN): the reference's rain names of this model are not at hand,
and the JAX tree's paths map onto these one to one
(``checkpoint/convert.waitk_state_dict_from_jax``).

Streaming policy (``WaitkAgent``): READ until k blocks of ``stride``
frames have arrived, then alternate WRITE and READ one block at a time;
each WRITE recomputes the model over the whole source so far, greedily.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wav2vec_s_tpu_torch.models.asr import Seq2SeqDecoder, _S2SEncoder
from wav2vec_s_tpu_torch.models.caat.config import CaatConfig
from wav2vec_s_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from wav2vec_s_tpu_torch.ops.block_mask import MASK_VALUE
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext


def waitk_cross_bias(tgt_len: int, src_len: int, k: int, stride: int,
                     device=None, dtype=torch.float32) -> torch.Tensor:
    """[U, S] additive mask: step i sees frames t < (i + k) * stride."""
    limit = (torch.arange(tgt_len, device=device)[:, None] + k) * stride
    t = torch.arange(src_len, device=device)[None, :]
    return torch.where(t < limit, 0.0, MASK_VALUE).to(dtype)


class WaitkDecoder(Seq2SeqDecoder):
    """The seq2seq decoder under the wait-k mask (JAX ``WaitkDecoder``):
    the encoder attention's bias is the wait-k mask plus the padding
    mask, both at ``MASK_VALUE``."""

    def __init__(self, cfg: CaatConfig, enc_dim: int, waitk: int = 3,
                 stride: int = 1):
        super().__init__(cfg, enc_dim)
        self.waitk, self.stride = waitk, stride

    def cross_bias(self, U: int, enc_pad: torch.Tensor) -> torch.Tensor:
        wk = waitk_cross_bias(U, enc_pad.shape[1], self.waitk, self.stride,
                              enc_pad.device)
        return wk[None, None] + super().cross_bias(U, enc_pad)


class WaitkModel(torch.nn.Module):
    """wav2vec encoder + wait-k decoder (the speech wait-k baseline)."""

    #: the encoder that the freeze schedules reach (``CaatModelBase``)
    encoder_prefix = "encoder.w2v2_model."

    def __init__(self, w2v_cfg: Wav2Vec2Config, cfg: CaatConfig,
                 waitk: int = 3, stride: int = 8):
        super().__init__()
        self.w2v_cfg, self.cfg = w2v_cfg, cfg
        self.encoder = _S2SEncoder(w2v_cfg, "blockwise")
        self.decoder = WaitkDecoder(cfg, w2v_cfg.encoder_embed_dim, waitk,
                                    stride)

    def forward(self, source: torch.Tensor, prev_tokens: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """source [B, S] samples, prev_tokens [B, U] (eos first) ->
        float32 logits [B, U, V]; the encoder at the config's (mc, rc)."""
        enc, enc_pad = self.encoder.w2v2_model.extract_features(
            source, padding_mask, ctx=ctx)
        if enc_pad is None:
            enc_pad = torch.zeros(enc.shape[:2], dtype=torch.bool,
                                  device=enc.device)
        return self.decoder(prev_tokens, enc, enc_pad, ctx)


class WaitkAgent:
    """Streaming wait-k policy over ``WaitkModel`` on its device.

    READ until (k + tokens written) * stride frames have arrived; then one
    WRITE per additional ``stride`` frames: a greedy step recomputed over
    the whole source, at its own length (no padding: the JAX agent jits per
    shape and pads nothing, so padding would change the rounding and the
    words).  ``SimulEvaluator``'s agent API: ``push`` / ``pop_word`` /
    ``finished``."""

    def __init__(self, model: WaitkModel, vocab, waitk: int = 3,
                 stride: int = 8, frames_per_sample: float = 1 / 320.0,
                 max_len: int = 100):
        self.model = model
        self.device = next(model.parameters()).device
        self.vocab = vocab
        self.k = waitk
        self.stride = stride
        self.fps = frames_per_sample
        self.max_len = max_len
        self.reset()

    def reset(self):
        self.samples = np.zeros(0, np.float32)
        self.tokens = [self.vocab.eos()]
        self.queue = []
        self.finished = False
        self.done_decoding = False

    def _frames(self):
        return int(len(self.samples) * self.fps)

    def push(self, samples, is_end):
        self.samples = np.concatenate(
            [self.samples, np.asarray(samples, np.float32)])
        while not self.done_decoding:
            needed = (len(self.tokens) - 1 + self.k) * self.stride
            if self._frames() < needed and not is_end:
                break
            if len(self.samples) < 400:
                break
            self._emit_one()
            if not is_end:
                break
        if is_end:
            while not self.done_decoding:
                self._emit_one()
            self.finished = True

    @torch.no_grad()
    def _emit_one(self):
        src = torch.from_numpy(self.samples)[None].to(self.device)
        U = len(self.tokens)
        prev = torch.tensor([self.tokens], device=self.device)
        logits = self.model(src, prev)
        lp = torch.log_softmax(logits[0, U - 1], dim=-1).cpu().numpy()
        lp[self.vocab.pad()] = -np.inf
        tok = int(lp.argmax())
        if tok == self.vocab.eos() or U >= self.max_len:
            self.done_decoding = True
            return
        self.tokens.append(tok)
        self.queue.append(self.vocab[tok].replace("▁", ""))

    def pop_word(self):
        return self.queue.pop(0) if self.queue else None
