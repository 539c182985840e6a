"""CAAT configuration (torch port of ``wav2vec_s_tpu/models/caat/config.py``).

Defaults mirror the published fine-tune recipe (``w2v2_caat``,
rain/models/w2v2_transducer.py:317-347): 768-d decoder LM (6 layers, pre-LN,
relu, shared in/out embedding) and a 6-layer 768-d MHA jointer.  Only the
fields the streaming greedy decode reads are kept; the loss and training
fields come with the training slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CaatConfig:
    vocab_size: int = 10000
    # fairseq dictionary special symbols
    bos: int = 0            # doubles as the transducer blank
    pad: int = 1
    eos: int = 2
    # decoder LM (IsolatedDecoder)
    decoder_layers: int = 6
    decoder_embed_dim: int = 768
    decoder_ffn_embed_dim: int = 3072
    decoder_attention_heads: int = 12
    decoder_normalize_before: bool = True
    share_input_output_embed: bool = True
    rand_pos_decoder: int = 30
    max_target_positions: int = 1024
    # jointer
    jointer_layers: int = 6
    jointer_embed_dim: int = 768
    jointer_ffn_embed_dim: int = 3072
    jointer_attention_heads: int = 12
    # --use-linear-layer: project encoder features to decoder_embed_dim
    encoder_proj: bool = False
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def caat_base_config(**kw) -> CaatConfig:
    return CaatConfig(**kw)
