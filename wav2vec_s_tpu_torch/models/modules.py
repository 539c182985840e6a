"""Shared transformer building blocks (torch).

Parameter containers named like fairseq's modules, so the state dicts that
``wav2vec_s_tpu/checkpoint/torch_export.py`` emits load with
``strict=True``, plus the plain functions the incremental steps run on
them.  As in the JAX package, parameters stay float32 and every matmul runs
in the activation's dtype (``dense`` casts the weight), while layer norms
always compute in float32 (``fp32_layer_norm``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def fp32_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 whatever ``x.dtype``; the
    result is cast back to ``x.dtype`` (fairseq ``Fp32LayerNorm``)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return fp32_layer_norm(x, norm.weight, norm.bias, norm.eps)


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W.T + b`` in ``x.dtype`` (the weight is cast; a no-op when the
    module already holds compute-dtype weights, see ``compute_copy``)."""
    b = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), b)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")      # exact erf GELU


class MultiheadAttention(nn.Module):
    """fairseq ``MultiheadAttention`` parameters: q/k/v/out projections."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
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


def attn_input(layer: TransformerEncoderLayer, x: torch.Tensor,
               layer_norm_first: bool) -> torch.Tensor:
    """What the q/k/v projections read: LN(x) pre-LN, x post-LN."""
    return ln(layer.self_attn_layer_norm, x) if layer_norm_first else x


def layer_tail(layer: TransformerEncoderLayer, x: torch.Tensor,
               h: torch.Tensor, layer_norm_first: bool,
               act: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Residuals, norms and FFN after the attention output ``h``
    (``out_proj`` applied) — the two orderings of
    ``wav2vec_s_tpu/stream/incremental.py:275-285``."""
    if layer_norm_first:
        x = x + h
        return x + dense(layer.fc2, act(dense(
            layer.fc1, ln(layer.final_layer_norm, x))))
    x = ln(layer.self_attn_layer_norm, x + h)
    return ln(layer.final_layer_norm,
              x + dense(layer.fc2, act(dense(layer.fc1, x))))


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Refill every parameter from ``generator`` with the JAX package's
    initialisers: linear weights lecun-normal and zero bias, conv weights
    he-normal, norms one/zero, embeddings normal(dim ** -0.5).  Returns
    ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            gain = 2.0 if isinstance(m, nn.Conv1d) else 1.0
            _normal_(m.weight, math.sqrt(gain / fan_in), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            _normal_(m.weight, m.weight.shape[1] ** -0.5, generator)
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
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Embedding)):
            m.to(dtype)
    return out
