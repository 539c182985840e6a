"""wav2vec-S encoder: configuration, parameters and one-shot forward (torch).

Port of the parts of ``wav2vec_s_tpu/models/wav2vec2.py`` that the
streaming and corpus decoders read: ``Wav2Vec2Config`` (streaming and
encoder fields), a ``Wav2Vec2Model`` holding the fairseq-named parameters
of the conv front-end, the feature norm/projection and the encoder layers,
and the full-utterance forward ``Wav2Vec2Model.extract_features`` through
the blockwise encoder (``TransformerEncoder.forward``, the JAX
``BlockwiseTransformerEncoder``).  The quantizer and the pre-training head
are not part of this container; ``mask_emb`` is, because fine-tuned
checkpoints carry it.  The incremental step lives in
``stream/incremental.py``.

``extract_features`` follows the ambient grad mode: the fine-tuning
forward passes a ``DropoutContext`` (dropout, layerdrop) and back-propagates
through it, the decoders reach it through ``W2V2CaatModel.encode`` under
``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from wav2vec_s_tpu_torch.models.feature_extractor import (
    ConvFeatureExtractor, DEFAULT_CONV_LAYERS)
from wav2vec_s_tpu_torch.models.modules import (
    Dropouts, FlashSpec, GradMultiply, TransformerEncoderLayer, dense,
    encoder_layer, gelu, ln)
from wav2vec_s_tpu_torch.ops.block_mask import (
    append_right_context, block_attn_bias, block_layout, extend_padding_mask,
    strip_right_context)
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext, drop
from wav2vec_s_tpu_torch.utils.positional import (
    sinusoidal_positions_from_padding)


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    # conv front-end
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS
    extractor_mode: str = "layer_norm"     # "default" (group norm) is not
                                           # ported: ``check_ported``
    conv_bias: bool = False
    feature_grad_mult: float = 0.1
    # encoder
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    layer_norm_first: bool = False
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    encoder_layerdrop: float = 0.05
    dropout_input: float = 0.1             # pre-training forward only
    dropout_features: float = 0.1          # pre-training forward only
    # positions: the blockwise encoder adds sinusoidal ones; "conv" belongs
    # to the full-context encoder, which is not ported (``check_ported``)
    pos_type: str = "sin"
    conv_pos: int = 128
    conv_pos_groups: int = 16
    # streaming context (wav2vec-S)
    main_context: int = 16
    right_context: int = 8
    context_type: str = "constant"         # the CLI reads context.context_type
    # quantizer / contrastive head and masking: pre-training only; the
    # fine-tuning and decoding paths build and read none of it
    quantize_targets: bool = True
    final_dim: int = 256
    latent_vars: int = 320
    latent_groups: int = 2
    latent_temp: Tuple[float, float, float] = (2.0, 0.5, 0.999995)
    logit_temp: float = 0.1
    n_negatives: int = 100
    cross_sample_negatives: int = 0
    mask_prob: float = 0.65
    mask_length: int = 10
    # misc
    normalize: bool = False                # read nowhere: data.normalize is
    required_seq_len_multiple: int = 2
    attention_impl: str = "dense"          # "dense" | "flash" (the
                                           # block-sparse kernel)
    remat_extractor: bool = False          # TPU memory switch: not ported
    seq_axis: Optional[str] = None         # TPU mesh axis: not ported
    dtype: str = "float32"

    @property
    def layer_norm_num(self) -> int:
        # fork quirk (wav2vec2.py:317): LN only in conv block 0 for 12-layer
        # models, in all 7 blocks for 24-layer models.
        return 1 if self.encoder_layers == 12 else 7

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def check_ported(cfg: Wav2Vec2Config) -> None:
    """Raise ``NotImplementedError`` for every value that would change the
    forward in the JAX package and is not ported, naming the ROADMAP item.
    The pre-training fields (quantizer, negatives, masking, input and
    feature dropout) are accepted as they are: no ported path reads them."""
    todo = []
    if cfg.extractor_mode != "layer_norm":
        todo.append(f"extractor_mode={cfg.extractor_mode!r} (ROADMAP Queue 1 "
                    f"item 10: the group-norm conv front-end; only "
                    f"'layer_norm' is ported)")
    if cfg.pos_type != "sin":
        todo.append(f"pos_type={cfg.pos_type!r} (ROADMAP Queue 1 item 10: "
                    f"the full-context encoder with conv positions; the "
                    f"blockwise encoder adds sinusoidal positions)")
    if cfg.remat_extractor:
        todo.append("remat_extractor (ROADMAP Queue 1 item 9: a TPU memory "
                    "switch that waits for a measurement on the card)")
    if cfg.seq_axis is not None:
        todo.append(f"seq_axis={cfg.seq_axis!r} (ROADMAP Queue 1 item 11: "
                    f"context parallelism over a TPU mesh axis)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def wav2vec_s_base_config(**kw) -> Wav2Vec2Config:
    """wav2vec-S Base (examples/wav2vec/config/pretraining/
    wav2vec-S_base_librispeech.yaml)."""
    return Wav2Vec2Config(**kw)


class TransformerEncoder(nn.Module):
    """The wav2vec-S blockwise encoder (wav2vec_S.py:355-440)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        if cfg.attention_impl not in ("dense", "flash"):
            raise ValueError(f"attention_impl={cfg.attention_impl!r} is not "
                             f"'dense' or 'flash'")
        self.cfg = cfg
        self.layer_norm = nn.LayerNorm(cfg.encoder_embed_dim)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(cfg.encoder_embed_dim,
                                    cfg.encoder_ffn_embed_dim,
                                    cfg.encoder_attention_heads)
            for _ in range(cfg.encoder_layers))

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                main_context: Optional[int] = None,
                right_context: Optional[int] = None,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """x: [B, T, D] features, padding_mask: [B, T] bool (True = pad) ->
        [B, T, D].  The JAX ``BlockwiseTransformerEncoder`` order: zero the
        pad frames, add positions, post-LN norm, pad T to the seq multiple
        (pad frames masked), dropout, append the rc copies, the layers (each
        skipped on a host layerdrop draw), strip the copies, pre-LN norm,
        cut the pad."""
        c = self.cfg
        mc = c.main_context if main_context is None else main_context
        rc = c.right_context if right_context is None else right_context
        B, T, D = x.shape
        if padding_mask is not None:
            x = x * (~padding_mask)[:, :, None].to(x.dtype)
            pm = padding_mask
        else:
            pm = torch.zeros((B, T), dtype=torch.bool, device=x.device)
        x = x + sinusoidal_positions_from_padding(pm, D, dtype=x.dtype)
        if not c.layer_norm_first:
            x = ln(self.layer_norm, x)

        pad_len = (-T) % c.required_seq_len_multiple
        if pad_len:
            x = torch.cat([x, x.new_zeros((B, pad_len, D))], dim=1)
            pm = torch.cat([pm, pm.new_ones((B, pad_len))], dim=1)
        x = drop(ctx, x, c.dropout)
        layout = block_layout(T + pad_len, mc, rc)
        x = append_right_context(x, layout)
        # the flash kernel takes the exact length: no tile padding
        if c.attention_impl == "flash":
            bias = FlashSpec(extend_padding_mask(pm, layout), T + pad_len,
                             mc, rc)
        else:
            bias = block_attn_bias(layout, pm, dtype=torch.float32)
        rates = Dropouts(c.dropout, c.attention_dropout, c.activation_dropout)
        for layer in self.layers:
            if ctx is not None and ctx.layer_dropped(c.encoder_layerdrop):
                continue
            x = encoder_layer(layer, x, bias, c.layer_norm_first, gelu,
                              rates, ctx)
        x = strip_right_context(x, layout)
        if c.layer_norm_first:
            # the one `layer_norm` runs after the stack in pre-LN models,
            # before it in post-LN models (wav2vec2.py:846-871)
            x = ln(self.layer_norm, x)
        return x[:, :T]


def downsample_padding_mask(padding_mask: torch.Tensor,
                            t_out: int) -> torch.Tensor:
    """[B, T_samples] -> [B, T_frames]; a frame is pad iff *all* its samples
    are pad (reference wav2vec2.py:572-577)."""
    B, T = padding_mask.shape
    extra = T % t_out
    if extra:
        padding_mask = padding_mask[:, :-extra]
    return padding_mask.reshape(B, t_out, -1).all(dim=-1)


class Wav2Vec2Model(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.feature_extractor = ConvFeatureExtractor(
            cfg.conv_feature_layers, cfg.layer_norm_num, cfg.conv_bias)
        embed = cfg.conv_feature_layers[-1][0]
        self.layer_norm = nn.LayerNorm(embed)
        self.post_extract_proj = (nn.Linear(embed, cfg.encoder_embed_dim)
                                  if embed != cfg.encoder_embed_dim else None)
        self.mask_emb = nn.Parameter(torch.zeros(cfg.encoder_embed_dim))
        self.encoder = TransformerEncoder(cfg)

    def forward_features(self, source: torch.Tensor) -> torch.Tensor:
        """[B, S] samples -> [B, T, C] conv features in the compute dtype,
        their gradient scaled by ``feature_grad_mult`` (cut at 0)."""
        feats = self.feature_extractor(source, self.cfg.compute_dtype)
        mult = self.cfg.feature_grad_mult
        if mult == 1.0:
            return feats
        return GradMultiply.apply(feats, mult) if mult > 0 else feats.detach()

    def extract_features(self, source: torch.Tensor,
                         padding_mask: Optional[torch.Tensor] = None,
                         main_context: Optional[int] = None,
                         right_context: Optional[int] = None,
                         ctx: Optional[DropoutContext] = None):
        """Downstream feature path, no masking: ([B, T, D] encoder output,
        [B, T] frame padding mask or None).  ``ctx`` carries the training
        randomness (dropout, layerdrop); None is the inference forward."""
        feats = ln(self.layer_norm, self.forward_features(source))
        if padding_mask is not None:
            padding_mask = downsample_padding_mask(padding_mask,
                                                   feats.shape[1])
        if self.post_extract_proj is not None:
            feats = dense(self.post_extract_proj, feats)
        x = self.encoder(feats, padding_mask, main_context, right_context,
                         ctx)
        return x, padding_mask
