"""Gumbel-softmax vector quantizer: the contrastive targets (port of
``wav2vec_s_tpu/models/quantizer.py``).

Behavioral twin of fairseq ``GumbelVectorQuantizer``
(fairseq/fairseq/modules/gumbel_vector_quantizer.py:11-202): G groups of V
codes, straight-through Gumbel-softmax selection under an exponentially
decayed temperature, code and probability perplexities.  Parameters carry
the fairseq names: ``vars [1, G*V, vq_dim / G]`` and ``weight_proj``.

The JAX package combines the codebooks as one matmul against a
block-diagonal codebook (an MXU lowering); here each group's selection
meets its own codebook in one grouped einsum.  The hard choice is the first
maximum (``torch.argmax``, as ``jnp.argmax``); the perplexities are
float32.  The Gumbel uniforms come from the forward's ``DropoutContext``
(a host generator), so one seed gives one draw on any device.  Under
tensor parallelism ``weight_proj`` is column-parallel (the JAX rule): its
logits are gathered over the model group before the group reshape, and
the rest runs whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from wav2vec_s_tpu_torch.models.modules import dense
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext
from wav2vec_s_tpu_torch.parallel.functional import (
    batch_mean, gather_from_model)
from wav2vec_s_tpu_torch.parallel.mesh import Shard


def gumbel_temperature(num_updates: int, max_temp: float, min_temp: float,
                       decay: float) -> torch.Tensor:
    """``max(max_temp * decay ** n, min_temp)`` in float32, as the JAX
    package computes it (float64 drifts: 0.999995 ** n differs by 7e-4
    relative at n 100000)."""
    f32 = torch.float32
    t = (torch.tensor(max_temp, dtype=f32)
         * torch.tensor(decay, dtype=f32) ** torch.tensor(float(num_updates),
                                                          dtype=f32))
    return torch.clamp(t, min=torch.tensor(min_temp, dtype=f32))


def _perplexity(probs: torch.Tensor) -> torch.Tensor:
    """[G, V] average probabilities -> sum over groups of exp(entropy)."""
    return torch.exp(-(probs * torch.log(probs + 1e-7)).sum(-1)).sum()


class GumbelVectorQuantizer(nn.Module):
    def __init__(self, input_dim: int, num_vars: int = 320, groups: int = 2,
                 vq_dim: int = 256):
        super().__init__()
        if vq_dim % groups:
            raise ValueError(f"vq_dim {vq_dim} does not split into {groups} "
                             f"groups")
        self.num_vars, self.groups, self.vq_dim = num_vars, groups, vq_dim
        self.vars = nn.Parameter(torch.zeros(1, groups * num_vars,
                                             vq_dim // groups))
        self.weight_proj = nn.Linear(input_dim, groups * num_vars)

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> None:
        """The codebook's initialiser (uniform in [0, 1), the JAX one's);
        ``models.modules.random_init_`` fills ``weight_proj``."""
        self.vars.uniform_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor, temperature: torch.Tensor,
                ctx: Optional[DropoutContext] = None,
                shard: Optional[Shard] = None) -> Dict[str, torch.Tensor]:
        """x: [B, T, C] -> {x [B, T, vq_dim] in x.dtype, code_perplexity,
        prob_perplexity, num_vars, temp, targets [B, T, G] (hard codes),
        sel_codes [B, T, G] (the codes the output was built from)}.
        ``ctx`` None is eval mode: the hard codes, no noise.  ``shard``:
        the rows of the whole batch that ``x`` holds, whose group the
        perplexities' means are summed over (None: one process)."""
        B, T, _ = x.shape
        G, V = self.groups, self.num_vars
        logits = dense(self.weight_proj, x)
        tp = getattr(self.weight_proj, "tp", None)
        if tp is not None:      # column-parallel: every rank's codes
            logits = gather_from_model(logits, tp.group)
        logits = logits.reshape(B * T, G, V).float()
        hard_idx = logits.argmax(dim=-1)                          # [BT, G]
        hard_onehot = F.one_hot(hard_idx, V).float()
        code_ppl = _perplexity(batch_mean(hard_onehot, 0, shard))
        prob_ppl = _perplexity(batch_mean(torch.softmax(logits, dim=-1), 0,
                                          shard))

        temperature = temperature.to(logits.device)
        if ctx is not None:
            u = ctx.uniform(logits.shape).to(logits.device)
            g = -torch.log(-torch.log(u + 1e-10))
            y_soft = torch.softmax((logits + g) / temperature, dim=-1)
            sel_idx = y_soft.argmax(dim=-1)
            y_hard = F.one_hot(sel_idx, V).float()
            sel = y_hard + y_soft - y_soft.detach()               # ST
        else:
            sel, sel_idx = hard_onehot, hard_idx
        codebook = self.vars[0].reshape(G, V, -1)
        out = torch.einsum("ngv,gvd->ngd", sel, codebook)
        return {
            "x": out.reshape(B, T, self.vq_dim).to(x.dtype),
            "code_perplexity": code_ppl,
            "prob_perplexity": prob_ppl,
            "num_vars": G * V,
            "temp": temperature,
            "targets": hard_idx.reshape(B, T, G),
            "sel_codes": sel_idx.reshape(B, T, G),
        }
