"""wav2vec-S encoder configuration and parameter container (torch).

Port of the parts of ``wav2vec_s_tpu/models/wav2vec2.py`` that the
incremental streaming path reads: ``Wav2Vec2Config`` (streaming and
encoder fields) and a ``Wav2Vec2Model`` holding the fairseq-named
parameters of the conv front-end, the feature norm/projection and the
encoder layers.  The quantizer and the pre-training head are not part of
this container; ``mask_emb`` is, because fine-tuned checkpoints carry it.
The forward math lives in ``stream/incremental.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from wav2vec_s_tpu_torch.models.feature_extractor import (
    ConvFeatureExtractor, DEFAULT_CONV_LAYERS)
from wav2vec_s_tpu_torch.models.modules import TransformerEncoderLayer


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    # conv front-end
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS
    extractor_mode: str = "layer_norm"     # only "layer_norm" streams
    conv_bias: bool = False
    # encoder
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    layer_norm_first: bool = False
    # streaming context (wav2vec-S)
    main_context: int = 16
    right_context: int = 8
    dtype: str = "float32"

    @property
    def layer_norm_num(self) -> int:
        # fork quirk (wav2vec2.py:317): LN only in conv block 0 for 12-layer
        # models, in all 7 blocks for 24-layer models.
        return 1 if self.encoder_layers == 12 else 7

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def wav2vec_s_base_config(**kw) -> Wav2Vec2Config:
    """wav2vec-S Base (examples/wav2vec/config/pretraining/
    wav2vec-S_base_librispeech.yaml)."""
    return Wav2Vec2Config(**kw)


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.encoder_embed_dim)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(cfg.encoder_embed_dim,
                                    cfg.encoder_ffn_embed_dim,
                                    cfg.encoder_attention_heads)
            for _ in range(cfg.encoder_layers))


class Wav2Vec2Model(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = ConvFeatureExtractor(
            cfg.conv_feature_layers, cfg.layer_norm_num, cfg.conv_bias)
        embed = cfg.conv_feature_layers[-1][0]
        self.layer_norm = nn.LayerNorm(embed)
        self.post_extract_proj = (nn.Linear(embed, cfg.encoder_embed_dim)
                                  if embed != cfg.encoder_embed_dim else None)
        self.mask_emb = nn.Parameter(torch.zeros(cfg.encoder_embed_dim))
        self.encoder = TransformerEncoder(cfg)
