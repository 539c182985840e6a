"""Waveform conv front-end (torch).

Port of ``wav2vec_s_tpu/models/feature_extractor.py``: strided Conv1d
blocks, each followed by its norm and exact GELU, in one of the two modes
of fairseq's ``ConvFeatureExtractionModel`` (wav2vec2.py:702-781):

- ``"layer_norm"``: an fp32 layer norm over channels, only in the first
  ``layer_norm_num`` blocks (the fork quirk, wav2vec2.py:317,766), under
  fairseq's ``Sequential(conv, dropout, Sequential(Transpose, LayerNorm,
  Transpose), GELU)`` names (``conv_layers.{i}.0``, ``conv_layers.{i}.2.1``);
- ``"default"`` (wav2vec 2.0): an fp32 group norm with one group per
  channel in block 0 alone, ``Sequential(conv, dropout, Fp32GroupNorm,
  GELU)`` (``conv_layers.0.2``), the others bare.  It normalises each
  channel over the whole utterance, so it is a function of the whole
  input (the incremental streaming encoder refuses it).

The convolutions are plain ``F.conv1d``: XLA, not a Pallas kernel, ran
them on the TPU.  Input [N, S] samples, output feature-last [N, T, C].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wav2vec_s_tpu_torch.models.modules import (
    fp32_group_norm, fp32_layer_norm, gelu)

# (dim, kernel, stride) per block — `conv_feature_layers` default
DEFAULT_CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
    (512, 3, 2), (512, 2, 2), (512, 2, 2),
)
MODES = ("default", "layer_norm")


def conv_output_length(t: int, layers=DEFAULT_CONV_LAYERS) -> int:
    for _, k, s in layers:
        t = (t - k) // s + 1
    return t


def conv_receptive_stride(layers=DEFAULT_CONV_LAYERS) -> tuple[int, int]:
    """(receptive_field, hop) in samples — (400, 320) for the default stack."""
    rf, hop = 1, 1
    for _, k, s in layers:
        rf = rf + (k - 1) * hop
        hop *= s
    return rf, hop


class ConvFeatureExtractor(nn.Module):
    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]]
                 = DEFAULT_CONV_LAYERS, layer_norm_num: int = 1,
                 conv_bias: bool = False, mode: str = "layer_norm"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"extractor mode {mode!r} is not one of {MODES}")
        self.mode = mode
        blocks = []
        in_ch = 1
        for i, (dim, k, stride) in enumerate(conv_layers):
            if mode == "layer_norm" and i < layer_norm_num:
                norm = nn.Sequential(nn.Identity(), nn.LayerNorm(dim),
                                     nn.Identity())
            elif mode == "default" and i == 0:
                norm = nn.GroupNorm(dim, dim)
            else:
                norm = nn.Identity()
            blocks.append(nn.Sequential(
                nn.Conv1d(in_ch, dim, k, stride=stride, bias=conv_bias),
                nn.Identity(), norm, nn.Identity()))
            in_ch = dim
        self.conv_layers = nn.ModuleList(blocks)

    def forward(self, source: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """source: [N, S] waveform -> [N, T, C] features in ``dtype``."""
        x = source[:, None, :].to(dtype)                   # [N, 1, S]
        for block in self.conv_layers:
            conv, norm = block[0], block[2]
            b = None if conv.bias is None else conv.bias.to(dtype)
            x = F.conv1d(x, conv.weight.to(dtype), b, stride=conv.stride)
            if isinstance(norm, nn.Sequential):
                ln = norm[1]
                x = fp32_layer_norm(x.transpose(1, 2), ln.weight, ln.bias,
                                    ln.eps).transpose(1, 2)
            elif isinstance(norm, nn.GroupNorm):
                x = fp32_group_norm(x.transpose(1, 2), norm.weight,
                                    norm.bias, norm.num_groups,
                                    norm.eps).transpose(1, 2)
            x = gelu(x)
        return x.transpose(1, 2)
