"""IsolatedDecoder parameters (torch port of
``wav2vec_s_tpu/models/caat/decoder.py``).

The CAAT causal LM (rain/layers/attention_transducer.py:60-287): token
embedding, self-attention-only layers with a relu FFN, and a final layer
norm when pre-LN.  Named ``decoder.lm.*`` in rain's state dict, including
fairseq's ``version`` buffer.  ``forward`` is the teacher-forcing form the
fine-tuning loss runs (JAX ``decoder.py:30-84``); the incremental step
math is ``stream/caat_step.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wav2vec_s_tpu_torch.models.caat.config import CaatConfig
from wav2vec_s_tpu_torch.models.modules import (
    Dropouts, TransformerEncoderLayer, ln)
from wav2vec_s_tpu_torch.ops.block_mask import MASK_VALUE
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext, drop
from wav2vec_s_tpu_torch.utils.positional import PADDING_IDX, sinusoidal_table


class IsolatedDecoder(nn.Module):
    def __init__(self, cfg: CaatConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.decoder_embed_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, D)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(D, cfg.decoder_ffn_embed_dim,
                                    cfg.decoder_attention_heads)
            for _ in range(cfg.decoder_layers))
        self.layer_norm = (nn.LayerNorm(D) if cfg.decoder_normalize_before
                           else None)
        self.register_buffer("version", torch.tensor([3.0]))

    def forward(self, prev_tokens: torch.Tensor,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """prev_tokens: [B, U+1] = [bos; targets] -> hidden [B, U+1, D] in
        the compute dtype.  Scaled embedding, fairseq sinusoidal positions
        (a random start offset in [0, rand_pos_decoder) per row while
        training, drawn on the host from ``ctx``), input dropout, causal
        plus padding bias (``MASK_VALUE``), relu layers, final norm."""
        c = self.cfg
        D = c.decoder_embed_dim
        B, U1 = prev_tokens.shape
        dev = prev_tokens.device
        x = self.embed_tokens.weight.to(c.compute_dtype)[prev_tokens]
        x = x * (D ** 0.5)

        pad_mask = prev_tokens == c.pad
        nonpad = (~pad_mask).long()
        positions = torch.cumsum(nonpad, dim=1) * nonpad + PADDING_IDX
        if ctx is not None and c.rand_pos_decoder > 0:
            offset = ctx.randint(c.rand_pos_decoder, (B, 1))
            positions = positions + offset.to(dev, non_blocking=True) * nonpad
        table = sinusoidal_table(U1 + PADDING_IDX + 1 + c.rand_pos_decoder,
                                 D, dev)
        x = x + table[positions].to(x.dtype)
        x = drop(ctx, x, c.dropout)

        causal = torch.triu(torch.full((U1, U1), MASK_VALUE, device=dev),
                            diagonal=1)
        bias = (causal[None, None]
                + torch.where(pad_mask, MASK_VALUE, 0.0)[:, None, None, :])
        rates = Dropouts(c.dropout, c.attention_dropout, c.activation_dropout)
        for layer in self.layers:
            x = layer(x, bias, c.decoder_normalize_before, F.relu, rates,
                      ctx)
        if self.layer_norm is not None:
            x = ln(self.layer_norm, x)
        return x
