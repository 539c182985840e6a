"""W2V2-CAAT parameter container (torch port of
``wav2vec_s_tpu/models/caat/transducer_model.py``).

Module tree and names follow rain's ``w2v2_caat`` state dict
(rain/models/w2v2_transducer.py:101-313), the naming
``wav2vec_s_tpu/checkpoint/torch_export.export_caat_params`` emits:

- ``encoder.w2v2_model.*``        the wav2vec-S encoder;
- ``encoder.encoder_proj``        optional ``--use-linear-layer`` projection;
- ``decoder.lm.*``                the IsolatedDecoder LM;
- ``decoder.jointer.layers.{i}``  the jointer;
- ``decoder.transducer_out.output_proj``  the vocabulary projection, the
  same tensor as ``decoder.lm.embed_tokens.weight`` when
  ``share_input_output_embed``.

``encode`` is the one-shot encoder forward (``extract_features`` plus the
optional projection).  The loss waits for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from wav2vec_s_tpu_torch.models.caat.config import CaatConfig
from wav2vec_s_tpu_torch.models.caat.decoder import IsolatedDecoder
from wav2vec_s_tpu_torch.models.caat.jointer import MHAJointNet
from wav2vec_s_tpu_torch.models.modules import dense
from wav2vec_s_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model


class _Encoder(nn.Module):
    def __init__(self, w2v_cfg: Wav2Vec2Config, cfg: CaatConfig):
        super().__init__()
        self.w2v2_model = Wav2Vec2Model(w2v_cfg)
        self.encoder_proj = (nn.Linear(w2v_cfg.encoder_embed_dim,
                                       cfg.decoder_embed_dim)
                             if cfg.encoder_proj else None)


class _TransducerOut(nn.Module):
    def __init__(self, cfg: CaatConfig, embed: nn.Embedding):
        super().__init__()
        self.output_proj = nn.Linear(cfg.decoder_embed_dim, cfg.vocab_size,
                                     bias=False)
        if cfg.share_input_output_embed:
            self.output_proj.weight = embed.weight


class _Decoder(nn.Module):
    def __init__(self, cfg: CaatConfig, enc_dim: int):
        super().__init__()
        self.lm = IsolatedDecoder(cfg)
        self.jointer = MHAJointNet(cfg, enc_dim)
        self.transducer_out = _TransducerOut(cfg, self.lm.embed_tokens)


class W2V2CaatModel(nn.Module):
    def __init__(self, w2v_cfg: Wav2Vec2Config, cfg: CaatConfig):
        super().__init__()
        self.w2v_cfg = w2v_cfg
        self.cfg = cfg
        self.encoder = _Encoder(w2v_cfg, cfg)
        # the jointer's keys/values read the encoder output: projected to
        # the decoder width with --use-linear-layer, else the encoder width
        enc_dim = (cfg.decoder_embed_dim if cfg.encoder_proj
                   else w2v_cfg.encoder_embed_dim)
        self.decoder = _Decoder(cfg, enc_dim)

    @torch.no_grad()
    def encode(self, source: torch.Tensor,
               padding_mask: Optional[torch.Tensor] = None,
               main_context: Optional[int] = None,
               right_context: Optional[int] = None):
        """One-shot blockwise encode (JAX ``W2V2CaatModel.encode``):
        source [B, S] samples -> ([B, T, D_out] features, frame padding
        mask or None)."""
        enc, enc_pad = self.encoder.w2v2_model.extract_features(
            source, padding_mask, main_context, right_context)
        if self.encoder.encoder_proj is not None:
            enc = dense(self.encoder.encoder_proj, enc)
        return enc, enc_pad
