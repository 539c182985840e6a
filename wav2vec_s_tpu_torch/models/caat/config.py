"""CAAT configuration (torch port of ``wav2vec_s_tpu/models/caat/config.py``).

Defaults mirror the published fine-tune recipe (``w2v2_caat``,
rain/models/w2v2_transducer.py:317-347): 768-d decoder LM (6 layers, pre-LN,
relu, shared in/out embedding), a 6-layer 768-d MHA jointer,
transducer_downsample 64 with sampled decision steps, and the loss and
dropout fields of the fine-tuning recipe.  Names and defaults are the JAX
package's; ``frontend`` and ``jointer_type`` pick the fbank family's conv
front-end and jointer (``models/fbank.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    transducer_downsample: int = 64
    # --use-linear-layer: project encoder features to decoder_embed_dim
    encoder_proj: bool = False
    # fbank model family selection (rain encodes these in arch names, e.g.
    # transducer_base_s2 = shallow2d front-end; caat_transformer = mha)
    frontend: str = "shallow2d"   # shallow2d | vgg2d | resnet | resnet_small
    jointer_type: str = "mha"     # mha | concat | attention
    # decision steps: "constant" | "random" (the published recipes train
    # with random); sampled from {2, 4, 10, 20} * step_scale unless
    # decision_steps gives the set
    step_mode: str = "random"
    decision_steps: Optional[Tuple[int, ...]] = None
    # loss
    delay_scale: float = 1.0
    delay_func: str = "diag_positive"
    transducer_temperature: float = 1.0   # gradient smoothing (1.0 = exact)
    transducer_label_smoothing: float = 0.1
    transducer_ce_scale: float = 1.0
    tokens_per_step: int = 6000
    # dropouts
    dropout: float = 0.3
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    dtype: str = "float32"

    @property
    def step_scale(self) -> int:
        return 8 if self.transducer_downsample == 32 else 16

    @property
    def sampled_steps(self) -> Tuple[int, ...]:
        if self.decision_steps:
            return tuple(self.decision_steps)
        return tuple(s * self.step_scale for s in (2, 4, 10, 20))

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def caat_base_config(**kw) -> CaatConfig:
    return CaatConfig(**kw)
