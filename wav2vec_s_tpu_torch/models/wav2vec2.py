"""wav2vec-S models: configuration, parameters, the one-shot feature
forward and the pre-training forward (torch).

Port of ``wav2vec_s_tpu/models/wav2vec2.py``: ``Wav2Vec2Config`` (every
field of the JAX one, same defaults), ``wav2vec2_base_config`` (wav2vec 2.0
Base: the group-norm front-end), a ``Wav2Vec2Model`` holding the
fairseq-named parameters of the conv front-end, the feature
norm/projection, ``mask_emb`` and the encoder, on one of the two encoders
of the JAX package (``encoder_type``):

- ``"blockwise"``: the wav2vec-S ``BlockwiseTransformerEncoder``
  (sinusoidal positions, the block attention mask with right-context
  copies, dense or the flash kernels);
- ``"full"``: the wav2vec 2.0 full-context ``TransformerEncoder`` (conv
  positions, a key-padding mask, dense attention as in JAX), so that a
  stock wav2vec 2.0 checkpoint runs as it was trained.

As in the JAX package the encoder type decides the positions and
``pos_type`` is read by nobody.  Two forwards:

- ``extract_features``: the full-utterance downstream path, no masking;
  the CAAT model's encoder;
- ``forward``: wav2vec-S pre-training (``Wav2Vec2Model.__call__``, the
  reference's Wav2Vec2Model.forward, wav2vec2.py:557-698): the conv
  features and their L2 penalty, ``dropout_input`` / ``dropout_features``,
  the ``mask_emb`` blend at the host-sampled ``mask_positions``, the
  encoder at the given (mc, rc), the Gumbel quantizer on the unmasked rows,
  ``project_q`` / ``final_proj`` and the InfoNCE logits against
  ``n_negatives`` same-utterance distractors.  Only a model built with
  ``pretraining=True`` carries the quantizer and the two projections; the
  CAAT encoder has none (nor does its checkpoint).

The contrastive head is a plain gather of N scalars per row out of the
``[B, M, M]`` cosine table (the JAX package selects them by one-hot
matmuls, a TPU workaround); a distractor equal to the positive is masked to
``-inf`` by comparing the quantizer's code indices (PARITY.md, "Known
semantic deviations"), or the vectors themselves without a quantizer.
Every draw of a training forward (dropout seed, layerdrop, negatives,
Gumbel noise) comes from its ``DropoutContext``'s host generator; in eval
mode (``ctx=None``) the negatives come from a generator of fixed seed.

The conv positions' weight: fairseq holds it weight-normed
(``weight_g`` [1, 1, k], ``weight_v``); the JAX package folds the two into
one plain kernel at import and trains that, and so does the port
(``encoder.pos_conv.0.weight`` [D, D / groups, k] and ``.bias``):
``checkpoint/torch_import.py`` folds, ``checkpoint/torch_export.py``
splits (ROADMAP Queue 3, departures).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from wav2vec_s_tpu_torch.models.feature_extractor import (
    ConvFeatureExtractor, DEFAULT_CONV_LAYERS)
from wav2vec_s_tpu_torch.models.modules import (
    Dropouts, FlashSpec, GradMultiply, TransformerEncoderLayer, dense, gelu,
    ln)
from wav2vec_s_tpu_torch.models.quantizer import (
    GumbelVectorQuantizer, gumbel_temperature)
from wav2vec_s_tpu_torch.ops.block_mask import (
    MASK_VALUE, append_right_context, block_attn_bias, block_layout,
    extend_padding_mask, strip_right_context)
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext, drop
from wav2vec_s_tpu_torch.parallel.functional import batch_mean
from wav2vec_s_tpu_torch.parallel.mesh import Shard
from wav2vec_s_tpu_torch.utils.positional import (
    sinusoidal_positions_from_padding)


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    # conv front-end
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS
    extractor_mode: str = "layer_norm"     # "default" | "layer_norm"
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
    # positions: the blockwise encoder adds sinusoidal ones, the full one
    # conv ones; as in the JAX package pos_type is read nowhere
    pos_type: str = "sin"
    conv_pos: int = 128
    conv_pos_groups: int = 16
    # streaming context (wav2vec-S)
    main_context: int = 16
    right_context: int = 8
    context_type: str = "constant"         # the CLI reads context.context_type
    # quantizer / contrastive head: the pre-training forward only (the
    # fine-tuning and decoding paths build and read none of it); as in the
    # JAX package, cross_sample_negatives is read nowhere and the batcher
    # masks with its own mask_prob / mask_length (0.65, 10)
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
    remat_extractor: bool = False          # recompute the conv front-end
                                           # in the backward
    seq_axis: Optional[str] = None         # the mesh dim of context
                                           # parallelism (parallel/
                                           # context.py)
    dtype: str = "float32"

    @property
    def layer_norm_num(self) -> int:
        # fork quirk (wav2vec2.py:317): LN only in conv block 0 for 12-layer
        # models, in all 7 blocks for 24-layer models.
        return 1 if self.encoder_layers == 12 else 7

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def wav2vec2_base_config(**kw) -> Wav2Vec2Config:
    """wav2vec 2.0 Base (the JAX ``wav2vec2_base_config``): the group-norm
    front-end; build it with ``encoder_type="full"`` for conv positions."""
    return Wav2Vec2Config(pos_type="conv", extractor_mode="default", **kw)


def wav2vec_s_base_config(**kw) -> Wav2Vec2Config:
    """wav2vec-S Base (examples/wav2vec/config/pretraining/
    wav2vec-S_base_librispeech.yaml)."""
    return Wav2Vec2Config(**kw)


class ConvPositionalEmbedding(nn.Module):
    """wav2vec 2.0 conv positions (wav2vec2.py:791-804, JAX
    ``ConvPositionalEmbedding``): a grouped conv of ``kernel`` taps padded
    by ``kernel // 2`` on each side, the last frame dropped for an even
    kernel (SamePad), exact GELU.  ``weight`` [D, D / groups, kernel] is
    the folded weight-norm parametrisation (module docstring)."""

    def __init__(self, dim: int, kernel: int = 128, groups: int = 16):
        super().__init__()
        self.kernel, self.groups = kernel, groups
        self.weight = nn.Parameter(torch.zeros(dim, dim // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(dim))

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> None:
        """The JAX ``nn.Conv`` initialiser: lecun-normal, zero bias."""
        fan_in = self.weight[0].numel()
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator,
                                      device=generator.device)
                          * fan_in ** -0.5)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, D] -> [B, T, D] in ``x.dtype``."""
        h = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype),
                     self.bias.to(x.dtype), padding=self.kernel // 2,
                     groups=self.groups)
        if self.kernel % 2 == 0:
            h = h[:, :, :-1]
        return gelu(h).transpose(1, 2)


class TransformerEncoder(nn.Module):
    """The wav2vec 2.0 full-context encoder (wav2vec2.py:784-871, JAX
    ``TransformerEncoder``): every frame attends every unpadded frame.
    Attention is dense whatever ``attention_impl`` says, and the encoder
    neither pads to ``required_seq_len_multiple`` nor appends rc copies,
    as in JAX."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.pos_conv = nn.Sequential(ConvPositionalEmbedding(
            cfg.encoder_embed_dim, cfg.conv_pos, cfg.conv_pos_groups))
        self.layer_norm = nn.LayerNorm(cfg.encoder_embed_dim)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(cfg.encoder_embed_dim,
                                    cfg.encoder_ffn_embed_dim,
                                    cfg.encoder_attention_heads)
            for _ in range(cfg.encoder_layers))

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """x: [B, T, D] features, padding_mask: [B, T] bool (True = pad) ->
        [B, T, D]: zero the pad frames, add the conv positions, post-LN
        norm, dropout, the layers under a key-padding bias (each skipped on
        a host layerdrop draw), pre-LN norm."""
        c = self.cfg
        bias = None
        if padding_mask is not None:
            x = x * (~padding_mask)[:, :, None].to(x.dtype)
            bias = torch.where(padding_mask, MASK_VALUE,
                               0.0)[:, None, None, :]
        x = x + self.pos_conv[0](x)
        if not c.layer_norm_first:
            x = ln(self.layer_norm, x)
        x = drop(ctx, x, c.dropout)
        x = encoder_layers(self.layers, c, x, bias, ctx)
        if c.layer_norm_first:
            x = ln(self.layer_norm, x)
        return x


class BlockwiseTransformerEncoder(nn.Module):
    """The wav2vec-S blockwise encoder (wav2vec_S.py:355-440).

    ``seq_group``: the process group of context parallelism, set by
    ``parallel.context.enable`` (a config with ``seq_axis`` needs it): the
    layer stack then runs on this rank's rows of the sequence
    (``parallel/context.py``), on the dense attention."""

    seq_group = None

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
        seq = None
        if c.seq_axis is not None:
            if self.seq_group is None:
                raise RuntimeError(
                    f"seq_axis={c.seq_axis!r} splits the encoder over a "
                    f"process group, and none is set: launch with python "
                    f"-m torch.distributed.run and run.seq > 1 (or call "
                    f"parallel.context.enable)")
            from wav2vec_s_tpu_torch.parallel.context import SeqShard
            seq = SeqShard.of(self.seq_group, layout.total_len)
        # the flash kernel takes the exact length: no tile padding
        if c.attention_impl == "flash" and seq is None:
            bias = FlashSpec(extend_padding_mask(pm, layout), T + pad_len,
                             mc, rc)
        else:
            bias = block_attn_bias(layout, pm, dtype=torch.float32)
        if seq is not None:
            # this rank's query rows of the bias, and of the sequence
            bias = seq.split(bias, dim=2)
            x = seq.split(x)
        x = encoder_layers(self.layers, c, x, bias, ctx, seq)
        if seq is not None:
            x = seq.gather(x)
        x = strip_right_context(x, layout)
        if c.layer_norm_first:
            # the one `layer_norm` runs after the stack in pre-LN models,
            # before it in post-LN models (wav2vec2.py:846-871)
            x = ln(self.layer_norm, x)
        return x[:, :T]


def encoder_layers(layers: nn.ModuleList, cfg: Wav2Vec2Config,
                   x: torch.Tensor, bias, ctx: Optional[DropoutContext] = None,
                   seq=None) -> torch.Tensor:
    """The layer stack of the JAX ``EncoderLayers``
    (``wav2vec_s_tpu/models/wav2vec2.py:156-182``): each layer under
    ``bias`` (a dense bias or a ``FlashSpec``), skipped on a host layerdrop
    draw of ``ctx``; ``seq``: ``x`` is a ``SeqShard``'s rows."""
    rates = Dropouts(cfg.dropout, cfg.attention_dropout,
                     cfg.activation_dropout)
    for layer in layers:
        if ctx is not None and ctx.layer_dropped(cfg.encoder_layerdrop):
            continue
        x = layer(x, bias, cfg.layer_norm_first, gelu, rates, ctx, seq)
    return x


def downsample_padding_mask(padding_mask: torch.Tensor,
                            t_out: int) -> torch.Tensor:
    """[B, T_samples] -> [B, T_frames]; a frame is pad iff *all* its samples
    are pad (reference wav2vec2.py:572-577)."""
    B, T = padding_mask.shape
    extra = T % t_out
    if extra:
        padding_mask = padding_mask[:, :-extra]
    return padding_mask.reshape(B, t_out, -1).all(dim=-1)


#: seed of the eval-mode negatives (validation has no step generator)
EVAL_NEGATIVES_SEED = 0


def _unit_rows(t: torch.Tensor) -> torch.Tensor:
    """Rows over their norm clamped at 1e-8 (torch cosine_similarity)."""
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                           min=1e-8)


def contrastive_logits(x: torch.Tensor, y_q: torch.Tensor,
                       codes: torch.Tensor, idxs: torch.Tensor,
                       logit_temp: float) -> torch.Tensor:
    """InfoNCE cosine logits against quantized targets (JAX
    ``_contrastive_logits_matmul``).  x (the predictions), y_q: [B, M, D];
    codes: [B, M, G] the quantizer's selected codes; idxs: [B, M, N] the
    distractors' rows -> [B, M, 1 + N] float32, positive first.  The
    pairwise table [B, M, M] is one batched product of the unit rows; each
    row's N distractors are gathered from it.  A distractor whose codes all
    equal the positive's (so its quantized vector is the positive) is
    ``-inf``."""
    xn, yn = _unit_rows(x.float()), _unit_rows(y_q.float())
    cos_all = torch.einsum("bmd,bnd->bmn", xn, yn)                # [B, M, M]
    pos = (xn * yn).sum(dim=-1)                                   # diagonal
    neg = torch.gather(cos_all, 2, idxs)
    rows = torch.arange(idxs.shape[0], device=idxs.device)[:, None, None]
    neg_is_pos = (codes[rows, idxs] == codes[:, :, None, :]).all(dim=-1)
    neg = torch.where(neg_is_pos, float("-inf"), neg / logit_temp)
    return torch.cat([pos[:, :, None] / logit_temp, neg], dim=-1)


def vector_logits(x: torch.Tensor, y: torch.Tensor, idxs: torch.Tensor,
                  logit_temp: float) -> torch.Tensor:
    """InfoNCE cosine logits against unquantized targets (JAX
    ``_sample_negatives`` + ``_compute_logits``, wav2vec2.py:529-542):
    the distractor vectors are gathered, compared with the positive and
    ``-inf`` where equal to it.  x, y: [B, M, D] -> [B, M, 1 + N]."""
    rows = torch.arange(idxs.shape[0], device=idxs.device)[:, None, None]
    negs = y[rows, idxs]                                      # [B, M, N, D]
    targets = torch.cat([y[:, :, None, :], negs], dim=2).float()
    x32 = x.float()[:, :, None, :]
    cos = (x32 * targets).sum(dim=-1) / (
        torch.linalg.vector_norm(x32, dim=-1)
        * torch.linalg.vector_norm(targets, dim=-1) + 1e-8)
    logits = cos / logit_temp
    neg_is_pos = (negs == y[:, :, None, :]).all(dim=-1)
    return torch.cat([logits[:, :, :1], torch.where(
        neg_is_pos, float("-inf"), logits[:, :, 1:])], dim=-1)


ENCODER_TYPES = ("blockwise", "full")


class Wav2Vec2Model(nn.Module):
    """The wav2vec-S model on the blockwise encoder, or wav2vec 2.0 on the
    full-context one (``encoder_type="full"``); ``pretraining=True`` adds
    the quantizer (``quantize_targets``), ``project_q`` and ``final_proj``
    that the pre-training ``forward`` needs."""

    #: the transformer encoder, which the freeze schedules reach in
    #: pre-training (``CaatModelBase``)
    encoder_prefix = "encoder."

    def __init__(self, cfg: Wav2Vec2Config, pretraining: bool = False,
                 encoder_type: str = "blockwise"):
        super().__init__()
        if encoder_type not in ENCODER_TYPES:
            raise ValueError(f"encoder_type={encoder_type!r} is not one of "
                             f"{ENCODER_TYPES}")
        self.cfg = cfg
        self.encoder_type = encoder_type
        self.feature_extractor = ConvFeatureExtractor(
            cfg.conv_feature_layers, cfg.layer_norm_num, cfg.conv_bias,
            cfg.extractor_mode)
        embed = cfg.conv_feature_layers[-1][0]
        self.layer_norm = nn.LayerNorm(embed)
        self.post_extract_proj = (nn.Linear(embed, cfg.encoder_embed_dim)
                                  if embed != cfg.encoder_embed_dim else None)
        self.mask_emb = nn.Parameter(torch.zeros(cfg.encoder_embed_dim))
        self.encoder = (TransformerEncoder(cfg) if encoder_type == "full"
                        else BlockwiseTransformerEncoder(cfg))
        self.pretraining = pretraining
        self.quantizer = self.project_q = self.final_proj = None
        if pretraining:
            if cfg.quantize_targets:
                self.quantizer = GumbelVectorQuantizer(
                    embed, cfg.latent_vars, cfg.latent_groups, cfg.final_dim)
            self.project_q = nn.Linear(
                cfg.final_dim if cfg.quantize_targets else embed,
                cfg.final_dim)
            self.final_proj = nn.Linear(cfg.encoder_embed_dim, cfg.final_dim)

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> None:
        """The pre-training model's mask embedding: uniform in [0, 1) (the
        JAX initialiser).  The CAAT encoder's stays 0 and draws nothing, so
        its seeded weights do not move."""
        if self.pretraining:
            self.mask_emb.uniform_(0.0, 1.0, generator=generator)

    def forward_features(self, source: torch.Tensor) -> torch.Tensor:
        """[B, S] samples -> [B, T, C] conv features in the compute dtype,
        their gradient scaled by ``feature_grad_mult`` (cut at 0).  Under
        ``remat_extractor`` a forward that records gradients keeps only
        the samples and recomputes the convolutions in the backward (JAX
        ``nn.remat(ConvFeatureExtractor)``; the front-end draws nothing)."""
        if self.cfg.remat_extractor and torch.is_grad_enabled():
            feats = checkpoint(self.feature_extractor, source,
                               self.cfg.compute_dtype, use_reentrant=False)
        else:
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
        x = self._encode(feats, padding_mask, main_context, right_context,
                         ctx)
        return x, padding_mask

    def _encode(self, x, padding_mask, main_context, right_context, ctx):
        """The encoder of ``encoder_type``; the full one has no block
        context (JAX ``_encode``)."""
        if self.encoder_type == "full":
            return self.encoder(x, padding_mask, ctx)
        return self.encoder(x, padding_mask, main_context, right_context,
                            ctx)

    def _negative_indices(self, B: int, M: int,
                          ctx: Optional[DropoutContext],
                          shard: Optional[Shard] = None) -> torch.Tensor:
        """[B, M, n_negatives] uniform same-utterance distractor rows, never
        the row's own (JAX ``_negative_indices``: ``randint(0, M - 1)``
        shifted past the own position), drawn on the host: from the step's
        generator in training, from a fixed seed in eval mode (the whole
        batch's draw, and ``shard``'s rows of it)."""
        shape = (B, M, self.cfg.n_negatives)
        if ctx is not None:
            idxs = ctx.randint(M - 1, shape)
        else:
            whole, rows = shape, slice(None)
            if shard is not None:
                whole = (shard.total,) + shape[1:]
                rows = slice(shard.start, shard.stop)
            idxs = torch.randint(0, M - 1, whole, generator=torch.Generator(
            ).manual_seed(EVAL_NEGATIVES_SEED))[rows]
        own = torch.arange(M)[None, :, None]
        return idxs + (idxs >= own)

    def forward(self, source: torch.Tensor, mask_positions: torch.Tensor,
                num_updates: int, padding_mask: Optional[torch.Tensor] = None,
                main_context: Optional[int] = None,
                right_context: Optional[int] = None,
                ctx: Optional[DropoutContext] = None,
                shard: Optional[Shard] = None) -> Dict[str, object]:
        """Pre-training forward.  source: [B, S] waveform; mask_positions:
        [B, M] masked frame indices (equal count per row); num_updates: the
        update count that anneals the Gumbel temperature; ``ctx`` None is
        eval mode (no dropout, hard codes); ``shard``: the rows of the
        whole batch that ``source`` holds (data parallelism): the feature
        penalty's and the perplexities' means are summed over its group,
        and eval mode takes its rows of the whole batch's negatives.  Returns the JAX dict: InfoNCE
        ``logits [B, M, 1 + N]`` (positive first), ``features_pen``,
        ``prob_perplexity``, ``code_perplexity``, ``num_vars``, ``temp``,
        ``mask_positions``, ``padding_mask``."""
        if not self.pretraining:
            raise RuntimeError("this Wav2Vec2Model was built without the "
                               "pre-training heads (pretraining=False)")
        c = self.cfg
        feats = self.forward_features(source)
        features_pen = batch_mean(feats.float().square(), shard=shard)
        feats = ln(self.layer_norm, feats)
        unmasked = feats
        if padding_mask is not None:
            padding_mask = downsample_padding_mask(padding_mask,
                                                   feats.shape[1])
        if self.post_extract_proj is not None:
            feats = dense(self.post_extract_proj, feats)
        feats = drop(ctx, feats, c.dropout_input)
        unmasked = drop(ctx, unmasked, c.dropout_features)

        B, T, _ = feats.shape
        pos = mask_positions.to(feats.device, torch.long)
        M = pos.shape[1]
        masked = torch.zeros((B, T), dtype=torch.bool,
                             device=feats.device).scatter_(1, pos, True)
        x = torch.where(masked[:, :, None], self.mask_emb.to(feats.dtype),
                        feats)
        x = self._encode(x, padding_mask, main_context, right_context, ctx)

        rows = torch.arange(B, device=x.device)[:, None]
        y, x_masked = unmasked[rows, pos], x[rows, pos]           # [B, M, .]
        if self.quantizer is not None:
            temp = gumbel_temperature(num_updates, *c.latent_temp)
            q = self.quantizer(y, temp, ctx, shard)
            y_q = dense(self.project_q, q["x"])
        else:
            q = {"prob_perplexity": None, "code_perplexity": None,
                 "num_vars": 0, "temp": torch.tensor(0.0)}
            y_q = dense(self.project_q, y)
        preds = dense(self.final_proj, x_masked)
        idxs = self._negative_indices(B, M, ctx, shard).to(x.device)
        if self.quantizer is not None:
            logits = contrastive_logits(preds, y_q, q["sel_codes"], idxs,
                                        c.logit_temp)
        else:
            logits = vector_logits(preds, y_q, idxs, c.logit_temp)
        return {"logits": logits, "mask_positions": mask_positions,
                "padding_mask": padding_mask, "features_pen": features_pen,
                "prob_perplexity": q["prob_perplexity"],
                "code_perplexity": q["code_perplexity"],
                "num_vars": q["num_vars"], "temp": q["temp"]}
