"""CAAT jointer parameters (torch port of
``wav2vec_s_tpu/models/caat/jointer.py``).

``TransformerJointerLayer`` (rain/layers/attention_transducer.py:591-851):
cross-attention from the LM state to the encoder frames (``enc_attn``),
then a relu FFN, with ``attn_layer_norm``/``final_layer_norm`` in either
order.  Named ``decoder.jointer.layers.{i}.*`` in rain's state dict.  The
one-query step the greedy decode runs is ``stream/caat_step.jointer_step``.
"""

from __future__ import annotations

from torch import nn

from wav2vec_s_tpu_torch.models.caat.config import CaatConfig
from wav2vec_s_tpu_torch.models.modules import MultiheadAttention


class TransformerJointerLayer(nn.Module):
    def __init__(self, cfg: CaatConfig):
        super().__init__()
        D = cfg.jointer_embed_dim
        self.enc_attn = MultiheadAttention(D, cfg.jointer_attention_heads)
        self.attn_layer_norm = nn.LayerNorm(D)
        self.final_layer_norm = nn.LayerNorm(D)
        self.fc1 = nn.Linear(D, cfg.jointer_ffn_embed_dim)
        self.fc2 = nn.Linear(cfg.jointer_ffn_embed_dim, D)


class MHAJointNet(nn.Module):
    def __init__(self, cfg: CaatConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerJointerLayer(cfg) for _ in range(cfg.jointer_layers))
