"""Shared transformer building blocks (torch).

Parameter containers named like fairseq's modules, so the state dicts that
``wav2vec_s_tpu/checkpoint/torch_export.py`` emits load with
``strict=True``, plus the plain functions the encoders run on them: the
full-sequence self-attention layer (``encoder_layer``, dense or block-sparse
flash attention) and the pieces the incremental step shares with it.  As in
the JAX package, parameters stay float32 and every matmul runs in the
activation's dtype (``dense`` casts the weight), while layer norms always
compute in float32 (``fp32_layer_norm``).

Training: the dropout sites of ``wav2vec_s_tpu/models/modules.py`` (the
attention probabilities after the softmax cast, ``drop(h, dropout)`` after
the attention and the FFN, ``activation_dropout`` inside the FFN, in both
layer-norm orders) run through an optional ``DropoutContext``
(``ops/dropout.py``, kernel K4); without one (inference) every site is the
identity.

Context parallelism (``parallel/context.py``): given a ``SeqShard``, a
layer holds its rows of the time axis, gathers the keys and values of the
whole sequence, attends its queries (dense only) and drops each row at its
place in the whole sequence.

Tensor parallelism (``parallel/sharding.py`` ``shard_params``): a linear
layer that carries a ``TensorSplit`` holds its rank's block, and ``dense``
runs it as megatron does (``copy_to_model`` before a column-parallel
layer, ``reduce_from_model`` after a row-parallel one, its bias added
once, after the sum).  The attention takes its head count from the local
width (``q.shape[-1] // head_dim``), and the two dropout sites of a split
tensor, the probabilities of the rank's heads and the FFN's hidden
columns, draw the bits of their place in the whole tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from wav2vec_s_tpu_torch.ops.dropout import DropoutContext, drop
from wav2vec_s_tpu_torch.ops.flash_attention import (
    blockwise_flash_attention_packed)
from wav2vec_s_tpu_torch.parallel.functional import (
    copy_to_model, reduce_from_model)


def fp32_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 whatever ``x.dtype``; the
    result is cast back to ``x.dtype`` (fairseq ``Fp32LayerNorm``)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def fp32_group_norm(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, groups: int,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over [B, T, C] in float32, cast back to ``x.dtype`` (JAX
    ``Fp32GroupNorm``, ``wav2vec_s_tpu/models/modules.py:80-103``): the
    statistics of each group run over (T, C / groups), padded frames
    included; with ``groups == C`` each channel is normalised over time.
    Plain ops with the two-pass variance of ``jnp.var``: their autograd is
    the JAX gradient (``F.group_norm``'s float32 backward on the CPU
    strays from float64 where this one does not)."""
    B, T, C = x.shape
    g = x.float().reshape(B, T, groups, C // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(B, T, C)
    return (y * weight.float() + bias.float()).to(x.dtype)


def ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return fp32_layer_norm(x, norm.weight, norm.bias, norm.eps)


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W.T + b`` in ``x.dtype`` (the weight is cast; a no-op when the
    module already holds compute-dtype weights, see ``compute_copy``).
    A layer split over the model group (its ``tp``, a ``TensorSplit``)
    returns its columns (column-parallel) or the whole sum (row-parallel)."""
    b = None if lin.bias is None else lin.bias.to(x.dtype)
    w = lin.weight.to(x.dtype)
    tp = getattr(lin, "tp", None)
    if tp is None:
        return F.linear(x, w, b)
    if tp.kind == "column":
        return F.linear(copy_to_model(x, tp.group), w, b)
    out = reduce_from_model(F.linear(x, w), tp.group)
    return out if b is None else out + b


def split_site(lin: nn.Linear, x: torch.Tensor, axis: int):
    """The split-axis argument of a dropout site on ``x``, the output of
    ``lin`` (or of heads drawn from it) whose ``axis`` holds this rank's
    block under tensor parallelism; None when ``lin`` is whole."""
    tp = getattr(lin, "tp", None)
    return None if tp is None else tp.site(x, axis)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")      # exact erf GELU


class GradMultiply(torch.autograd.Function):
    """Identity forward, gradient scaled by ``scale`` (fairseq
    ``GradMultiply``, the JAX ``grad_multiply``; ``feature_grad_mult``)."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy * ctx.scale, None


@dataclasses.dataclass(frozen=True)
class Dropouts:
    """A layer's dropout rates: after attention and FFN (``dropout``), on
    the attention probabilities, inside the FFN (``activation``)."""

    dropout: float = 0.0
    attention: float = 0.0
    activation: float = 0.0


class MultiheadAttention(nn.Module):
    """fairseq ``MultiheadAttention`` parameters: q/k/v/out projections;
    keys and values may come from a source of another width ``kdim``."""

    def __init__(self, dim: int, num_heads: int, kdim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(kdim or dim, dim)
        self.v_proj = nn.Linear(kdim or dim, dim)
        self.out_proj = nn.Linear(dim, dim)


class TransformerEncoderLayer(nn.Module):
    """``TransformerSentenceEncoderLayer`` parameters (wav2vec2.py:874-978);
    also the CAAT LM layer (relu FFN)."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, dim)
        self.final_layer_norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, bias, layer_norm_first: bool,
                act: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                rates: Optional["Dropouts"] = None,
                ctx: Optional[DropoutContext] = None,
                seq=None) -> torch.Tensor:
        """``encoder_layer`` on this layer (a module call, so that an FSDP
        unit gathers its parameters)."""
        return encoder_layer(self, x, bias, layer_norm_first,
                             act or gelu, rates or Dropouts(), ctx, seq)


@dataclasses.dataclass(frozen=True)
class FlashSpec:
    """Passed to ``self_attention`` in place of a dense bias: attend through
    the block-sparse flash kernel (``ops/flash_attention.py``)."""

    key_padding_mask: torch.Tensor   # [B, S] bool, True = pad (rc copies in)
    seq_len: int
    main_context: int
    right_context: int


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor],
                          dropout_rate: float = 0.0,
                          ctx: Optional[DropoutContext] = None,
                          site=None) -> torch.Tensor:
    """[B, H, T, Dh] attention as ``wav2vec_s_tpu/models/modules.py:106``:
    f32 logits plus the additive bias (broadcastable to [B, H, Tq, Tk]: a
    block mask, a causal-plus-padding mask, a group mask), softmax,
    probabilities cast to the compute dtype, dropped, then P.V.  ``site``:
    the split axis of the probabilities' dropout site (``ops/dropout.py``:
    a ``SeqShard``'s query rows, or a model rank's heads), None when they
    are whole."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    probs = drop(ctx, probs, dropout_rate, site)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def self_attention(att: MultiheadAttention, x: torch.Tensor,
                   bias: Union[torch.Tensor, FlashSpec, None],
                   dropout_rate: float = 0.0,
                   ctx: Optional[DropoutContext] = None,
                   seq=None, kv: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Full-sequence self-attention of ``MultiheadSelfAttention``
    (``wav2vec_s_tpu/models/modules.py:133-173``), ``out_proj`` applied.
    ``bias`` is an additive mask broadcastable to [B, H, T, T], or a
    ``FlashSpec`` for the block-sparse kernels on the packed projections,
    which drop the probabilities in-kernel at the site the dense branch's
    ``drop(ctx, probs, rate)`` would take: one seed gives both the same
    mask.  ``seq`` (a ``SeqShard``): ``x`` holds its rows; the keys and
    values of the whole sequence are gathered and ``bias`` holds the rows'
    [.., rows, whole] block.  ``kv`` [B, Tk, kdim]: the keys and values
    are projected from it instead of ``x`` (the decoder's encoder
    attention; dense only).  Under tensor parallelism (``att.q_proj.tp``)
    the projections hold this rank's heads: their count is the local
    width over ``att.head_dim``, and the probabilities' dropout draws
    the heads' place among all ``att.num_heads``."""
    B, T, _ = x.shape
    src = x if kv is None else kv
    q = dense(att.q_proj, x)
    k, v = dense(att.k_proj, src), dense(att.v_proj, src)
    Dl, Dh = q.shape[-1], att.head_dim
    H = Dl // Dh
    tp = getattr(att.q_proj, "tp", None)
    if seq is not None:
        if isinstance(bias, FlashSpec):
            raise ValueError("context parallelism runs the dense attention")
        k, v = seq.gather(k), seq.gather(v)
    if isinstance(bias, FlashSpec):
        rate, seed, offset, row0 = 0.0, 0, 0, 0
        h0, heads = (0, H) if tp is None else (tp.rank * H, tp.size * H)
        if ctx is not None and dropout_rate:
            rate, (seed, offset) = dropout_rate, ctx.next_site()
            row0 = ctx.first_row()
        out = blockwise_flash_attention_packed(
            q, k, v, bias.key_padding_mask, H, bias.seq_len,
            bias.main_context, bias.right_context, dropout_rate=rate,
            dropout_seed=seed, dropout_offset=offset, dropout_row0=row0,
            dropout_h0=h0, dropout_heads=heads)
    else:
        def split(t):
            return t.reshape(B, t.shape[1], H, Dh).transpose(1, 2)

        qh = split(q)
        site = (seq.site(2) if seq is not None
                else split_site(att.q_proj, qh, 1))
        out = dot_product_attention(qh, split(k), split(v), bias,
                                    dropout_rate, ctx, site)
        out = out.transpose(1, 2).reshape(B, T, Dl)
    return dense(att.out_proj, out)


def attn_input(layer: TransformerEncoderLayer, x: torch.Tensor,
               layer_norm_first: bool) -> torch.Tensor:
    """What the q/k/v projections read: LN(x) pre-LN, x post-LN."""
    return ln(layer.self_attn_layer_norm, x) if layer_norm_first else x


def layer_tail(layer: TransformerEncoderLayer, x: torch.Tensor,
               h: torch.Tensor, layer_norm_first: bool,
               act: Callable[[torch.Tensor], torch.Tensor],
               rates: Dropouts = Dropouts(),
               ctx: Optional[DropoutContext] = None,
               seq=None) -> torch.Tensor:
    """Residuals, norms and FFN after the attention output ``h``
    (``out_proj`` applied) — the two orderings of
    ``wav2vec_s_tpu/stream/incremental.py:275-285``, with the dropout sites
    of ``wav2vec_s_tpu/models/modules.py:257-268``."""
    site = None if seq is None else seq.site(1)

    def ffn(t):
        t = act(dense(layer.fc1, t))
        t = drop(ctx, t, rates.activation,
                 site if seq is not None else split_site(layer.fc1, t, -1))
        return drop(ctx, dense(layer.fc2, t), rates.dropout, site)

    h = drop(ctx, h, rates.dropout, site)
    if layer_norm_first:
        x = x + h
        return x + ffn(ln(layer.final_layer_norm, x))
    x = ln(layer.self_attn_layer_norm, x + h)
    return ln(layer.final_layer_norm, x + ffn(x))


def encoder_layer(layer: TransformerEncoderLayer, x: torch.Tensor,
                  bias: Union[torch.Tensor, FlashSpec, None],
                  layer_norm_first: bool,
                  act: Callable[[torch.Tensor], torch.Tensor] = gelu,
                  rates: Dropouts = Dropouts(),
                  ctx: Optional[DropoutContext] = None,
                  seq=None) -> torch.Tensor:
    """One transformer layer over the full sequence (or a ``SeqShard``'s
    rows of it): the wav2vec-S encoder layer (GELU FFN) or, with
    ``act=F.relu`` and a causal bias, the CAAT LM layer."""
    h = self_attention(layer.self_attn, attn_input(layer, x, layer_norm_first),
                       bias, rates.attention, ctx, seq)
    return layer_tail(layer, x, h, layer_norm_first, act, rates, ctx, seq)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Refill every parameter from ``generator`` with the JAX package's
    initialisers: linear and 2-D conv weights lecun-normal and zero bias,
    the waveform front-end's 1-D conv weights he-normal, norms one/zero,
    embeddings normal(dim ** -0.5); a module
    with parameters of its own (the quantizer's codebook, the pre-training
    mask embedding) fills them in its ``random_init_(generator)``.
    Returns ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            gain = 2.0 if isinstance(m, nn.Conv1d) else 1.0
            _normal_(m.weight, math.sqrt(gain / fan_in), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            _normal_(m.weight, m.weight.shape[1] ** -0.5, generator)
        elif hasattr(m, "random_init_"):
            m.random_init_(generator)      # a module's own parameters
    return module


def _normal_(p: torch.Tensor, std: float, generator: torch.Generator):
    p.copy_(torch.randn(p.shape, generator=generator,
                        device=generator.device) * std)


def compute_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Copy of ``module`` whose linear, conv and embedding weights are cast
    to the compute ``dtype`` once, so the per-call casts in ``dense`` are
    no-ops (XLA hoists the same casts out of its loops).  Norm parameters
    stay float32: ``fp32_layer_norm`` reads them in float32 anyway."""
    import copy

    out = copy.deepcopy(module)
    for m in out.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Embedding)):
            m.to(dtype)
    return out
