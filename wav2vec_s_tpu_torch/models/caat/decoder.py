"""IsolatedDecoder parameters (torch port of
``wav2vec_s_tpu/models/caat/decoder.py``).

The CAAT causal LM (rain/layers/attention_transducer.py:60-287): token
embedding, self-attention-only layers with a relu FFN, and a final layer
norm when pre-LN.  Named ``decoder.lm.*`` in rain's state dict, including
fairseq's ``version`` buffer.  The incremental step math is
``stream/caat_step.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from wav2vec_s_tpu_torch.models.caat.config import CaatConfig
from wav2vec_s_tpu_torch.models.modules import TransformerEncoderLayer


class IsolatedDecoder(nn.Module):
    def __init__(self, cfg: CaatConfig):
        super().__init__()
        D = cfg.decoder_embed_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, D)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(D, cfg.decoder_ffn_embed_dim,
                                    cfg.decoder_attention_heads)
            for _ in range(cfg.decoder_layers))
        self.layer_norm = (nn.LayerNorm(D) if cfg.decoder_normalize_before
                           else None)
        self.register_buffer("version", torch.tensor([3.0]))
