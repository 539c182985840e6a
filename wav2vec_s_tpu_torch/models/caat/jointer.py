"""CAAT jointer parameters (torch port of
``wav2vec_s_tpu/models/caat/jointer.py``).

``TransformerJointerLayer`` (rain/layers/attention_transducer.py:591-851):
cross-attention from the LM state to the encoder frames (``enc_attn``),
then a relu FFN, with ``attn_layer_norm``/``final_layer_norm`` in either
order.  Named ``decoder.jointer.layers.{i}.*`` in rain's state dict.  The
keys and values are projected from the encoder output, whose width
``enc_dim`` may differ from the jointer's.  The one-query step the greedy
decode runs is ``stream/caat_step.jointer_step``.

The full lattice form the fine-tuning loss runs (JAX ``jointer.py``):
every decoder state attends G source prefixes at once (group g sees the
encoder frames t < (g + 1) * downsample), giving joint states
[B, G, U+1, D]; queries and the group axis fold into one attention over
[B, H, G*U, S] under an additive [B|1, G, S] group bias.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wav2vec_s_tpu_torch.models.caat.config import CaatConfig
from wav2vec_s_tpu_torch.models.modules import (
    MultiheadAttention, dense, dot_product_attention, ln, split_site)
from wav2vec_s_tpu_torch.ops.block_mask import MASK_VALUE
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext, drop


def num_groups(src_len: int, downsample: int) -> int:
    return max(1, math.ceil(src_len / downsample))


def group_attn_bias(src_len: int, downsample: int,
                    padding_mask: Optional[torch.Tensor] = None,
                    device=None) -> torch.Tensor:
    """Additive float32 bias [1|B, G, S]: group g attends to the frames
    t < (g + 1) * downsample (rain ``_gen_group_mask``, a finite mask value
    keeps fully padded rows NaN-free)."""
    if padding_mask is not None:
        device = padding_mask.device
    G = num_groups(src_len, downsample)
    limits = (torch.arange(1, G + 1, device=device) * downsample)[:, None]
    t = torch.arange(src_len, device=device)[None, :]
    bias = torch.where(limits <= t, MASK_VALUE, 0.0)[None]
    if padding_mask is not None:
        bias = bias + torch.where(padding_mask, MASK_VALUE, 0.0)[:, None, :]
    return bias


def group_lengths(padding_mask: torch.Tensor, downsample: int) -> torch.Tensor:
    """[B] int32 number of valid groups = ceil(nonpad_len / ds)."""
    lens = (~padding_mask).sum(dim=1)
    return torch.div(lens + downsample - 1, downsample,
                     rounding_mode="floor").to(torch.int32)


def expand_attention(att: MultiheadAttention, query: torch.Tensor,
                     source: torch.Tensor, group_bias: Optional[torch.Tensor],
                     dropout_rate: float = 0.0,
                     ctx: Optional[DropoutContext] = None) -> torch.Tensor:
    """``ExpandMultiheadAttention``: query [B, G, U, D] or [B, U, D] (the
    first layer's decoder states, shared by every group); source [B, S, Dk];
    group_bias [B|1, G, S] -> [B, G, U, D], ``out_proj`` applied.  Under
    tensor parallelism the projections hold this rank's heads
    (``models/modules.self_attention``)."""
    q = dense(att.q_proj, query)
    if q.dim() == 3:
        q = q[:, None]
    B, _, U, D = q.shape
    G = q.shape[1] if group_bias is None else group_bias.shape[1]
    Dh = att.head_dim
    H = D // Dh
    S = source.shape[1]
    q = q.expand(B, G, U, D).reshape(B, G * U, H, Dh).transpose(1, 2)
    k = dense(att.k_proj, source).reshape(B, S, H, Dh).transpose(1, 2)
    v = dense(att.v_proj, source).reshape(B, S, H, Dh).transpose(1, 2)
    bias = None
    if group_bias is not None:          # [B|1, G, S] -> [B|1, 1, G*U, S]
        gb = group_bias[:, :, None, :].expand(-1, G, U, S)
        bias = gb.reshape(group_bias.shape[0], 1, G * U, S)
    out = dot_product_attention(q, k, v, bias, dropout_rate, ctx,
                                split_site(att.q_proj, q, 1))
    out = out.transpose(1, 2).reshape(B, G, U, D)
    return dense(att.out_proj, out)


class TransformerJointerLayer(nn.Module):
    def __init__(self, cfg: CaatConfig, enc_dim: int):
        super().__init__()
        self.cfg = cfg
        D = cfg.jointer_embed_dim
        self.enc_attn = MultiheadAttention(D, cfg.jointer_attention_heads,
                                           kdim=enc_dim)
        self.attn_layer_norm = nn.LayerNorm(D)
        self.final_layer_norm = nn.LayerNorm(D)
        self.fc1 = nn.Linear(D, cfg.jointer_ffn_embed_dim)
        self.fc2 = nn.Linear(cfg.jointer_ffn_embed_dim, D)

    def forward(self, x: torch.Tensor, source: torch.Tensor,
                group_bias: Optional[torch.Tensor],
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """x: [B, G, U, D] (or [B, U, D] in the first layer) -> [B, G, U, D];
        dropout on the attention probabilities, after the attention, and
        inside and after the FFN (JAX ``jointer.py:106-138``)."""
        c = self.cfg
        pre = c.decoder_normalize_before
        residual = x if x.dim() == 4 else x[:, None]
        h = ln(self.attn_layer_norm, x) if pre else x
        h = expand_attention(self.enc_attn, h, source, group_bias,
                             c.attention_dropout, ctx)
        x = residual + drop(ctx, h, c.dropout)
        if not pre:
            x = ln(self.attn_layer_norm, x)
        residual = x
        h = ln(self.final_layer_norm, x) if pre else x
        h = F.relu(dense(self.fc1, h))
        h = drop(ctx, h, c.activation_dropout, split_site(self.fc1, h, -1))
        x = residual + drop(ctx, dense(self.fc2, h), c.dropout)
        if not pre:
            x = ln(self.final_layer_norm, x)
        return x


class MHAJointNet(nn.Module):
    def __init__(self, cfg: CaatConfig, enc_dim: int):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            TransformerJointerLayer(cfg, enc_dim)
            for _ in range(cfg.jointer_layers))

    def forward(self, decoder_state: torch.Tensor, encoder_out: torch.Tensor,
                encoder_padding_mask: torch.Tensor,
                downsample: Optional[int] = None,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """decoder_state [B, U, D], encoder_out [B, S, Dk], padding mask
        [B, S] -> joint states [B, G, U, D]; ``downsample`` <= 0 gives one
        full-context group."""
        ds = (self.cfg.transducer_downsample if downsample is None
              else downsample)
        S = encoder_out.shape[1]
        if ds > 0:
            bias = group_attn_bias(S, ds, encoder_padding_mask)
        else:
            bias = torch.where(encoder_padding_mask, MASK_VALUE,
                               0.0)[:, None, :]
        x = decoder_state
        for layer in self.layers:
            x = layer(x, encoder_out, bias, ctx)
        return x
