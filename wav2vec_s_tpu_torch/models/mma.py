"""Monotonic multihead attention (MMA) simultaneous baseline (torch port of
``wav2vec_s_tpu/models/mma.py``).

Twin of rain's MMA baseline (rain/models/mma_model.py:57 + mma_agent.py),
after "Monotonic Multihead Attention" (Ma et al., 2020, MILk-style
infinite lookback):

- every cross-attention head carries a monotonic energy; in training the
  expected alignment ``alpha`` is computed in closed form from the
  stepwise selection probabilities ``p = sigmoid(energy + noise)`` and the
  soft attention ``beta`` looks back over frames up to the aligned one;
- at inference each head advances its read pointer while ``p < 0.5``
  (hard monotonic decisions): the READ/WRITE policy.

The JAX ``lax.scan`` over the target steps is a loop over U here, with its
clip sequence kept: the recursion divides by products that underflow.
The training noise (``noise_std * N(0, 1)`` on the energies) is drawn on
the host from the update's ``DropoutContext`` generator, where the JAX
package draws it from a ``mono_noise`` key (ROADMAP Queue 3, departures);
without a context (inference) there is none.  The decoder has no dropout,
as in JAX.

Parameter names: those of the port's ``Wav2Vec2Seq2Seq`` for what the
models share (``encoder.w2v2_model.*``, ``decoder.embed_tokens``,
``decoder.layers.{i}.{self_attn, encoder_attn, self_attn_layer_norm,
encoder_attn_layer_norm, fc1, fc2, final_layer_norm}``), the JAX leaf names
under them for the monotonic heads (``encoder_attn.mono_q_proj``,
``encoder_attn.mono_k_proj``, ``encoder_attn.energy_bias``), and
``decoder.layer_norm`` for the final norm: rain's names of this model are
not at hand, and the JAX tree maps onto these one to one
(``checkpoint/convert.mma_state_dict_from_jax``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wav2vec_s_tpu_torch.models.asr import _S2SEncoder, embed_prev
from wav2vec_s_tpu_torch.models.caat.config import CaatConfig
from wav2vec_s_tpu_torch.models.modules import (
    MultiheadAttention, dense, ln, self_attention)
from wav2vec_s_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from wav2vec_s_tpu_torch.ops.block_mask import MASK_VALUE
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext


def expected_alignment(p: torch.Tensor, src_pad: torch.Tensor
                       ) -> torch.Tensor:
    """Closed-form expected monotonic alignment (JAX
    ``expected_alignment``).  p: [B, H, U, S] stepwise selection
    probabilities; src_pad [B, S] -> alpha [B, H, U, S] with
    alpha_u(s) = p(s) sum_{k<=s} alpha_{u-1}(k) prod_{j=k..s-1}(1 - p(j)),
    by the cumprod/cumsum form per target step: p clipped to [eps, 1-eps]
    (eps on padded frames), the cumulative product of 1 - p clipped to
    [eps, 1], the exclusive one it divides by clipped at eps."""
    B, H, U, S = p.shape
    eps = 1e-6
    p = p.clamp(eps, 1 - eps)
    p = torch.where(src_pad[:, None, None, :], eps, p)
    cumprod = torch.cumprod(1.0 - p, dim=-1).clamp(eps, 1.0)
    alpha = torch.zeros((B, H, S), dtype=p.dtype, device=p.device)
    alpha[:, :, 0] = 1.0                        # alpha_{-1} = onehot(0)
    alphas = []
    for u in range(U):
        cp_u = cumprod[:, :, u]
        excl = torch.cat([torch.ones_like(cp_u[..., :1]), cp_u[..., :-1]],
                         dim=-1)
        inner = torch.cumsum(alpha / excl.clamp(min=eps), dim=-1)
        alpha = p[:, :, u] * excl * inner
        alphas.append(alpha)
    return torch.stack(alphas, dim=2)


def hard_pointers(p_sel: torch.Tensor, visible: torch.Tensor,
                  is_end: torch.Tensor):
    """Hard monotonic READ/WRITE pointer walk (inference; JAX
    ``hard_pointers``): per target step each head stops at the first frame
    at or past its previous pointer, inside the ``visible`` ones, with
    p >= 0.5; a head that finds none falls back to the last visible frame
    and is *stuck* (READ) unless the stream has ended.  The first True is
    taken as JAX's ``argmax`` takes it: ``torch.argmax`` of an int cast
    (the first maximum), never a top-k.

    p_sel [B, H, U, S], visible [B], is_end [B] -> (ptrs [B, H, U] int32,
    stuck [B, H, U] bool)."""
    B, H, U, S = p_sel.shape
    dev = p_sel.device
    iota = torch.arange(S, device=dev)[None, None, :]
    vis = visible[:, None, None]
    fallback = (visible[:, None] - 1).clamp(min=0).to(torch.int32)
    ptr = torch.zeros((B, H), dtype=torch.int32, device=dev)
    ptrs, stucks = [], []
    for u in range(U):
        can = (p_sel[:, :, u] >= 0.5) & (iota >= ptr[..., None]) & (
            iota < vis)
        has = can.any(-1)
        first = torch.argmax(can.to(torch.int32), dim=-1).to(torch.int32)
        ptr = torch.where(has, first, fallback)
        ptrs.append(ptr)
        stucks.append(~has & ~is_end[:, None])
    return torch.stack(ptrs, dim=2), torch.stack(stucks, dim=2)


#: the monotonic energies' initial bias (JAX ``energy_bias_init``)
ENERGY_BIAS_INIT = -2.0


class MonotonicCrossAttention(MultiheadAttention):
    """Encoder attention with monotonic heads and infinite lookback (JAX
    ``MonotonicCrossAttention``): the q/k/v/out projections, the monotonic
    energy's own ``mono_q_proj`` / ``mono_k_proj`` and a learned scalar
    ``energy_bias``.  ``noise_std``: the training noise's scale (1 as in
    JAX; the parity checks set 0 to train without it)."""

    def __init__(self, dim: int, num_heads: int, kdim: int):
        super().__init__(dim, num_heads, kdim)
        self.mono_q_proj = nn.Linear(dim, dim)
        self.mono_k_proj = nn.Linear(kdim, dim)
        self.energy_bias = nn.Parameter(torch.tensor(ENERGY_BIAS_INIT))
        self.noise_std = 1.0

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> None:
        self.energy_bias.fill_(ENERGY_BIAS_INIT)

    def forward(self, x, enc, src_pad, ctx: Optional[DropoutContext] = None,
                hard: bool = False, visible=None, is_end=None):
        """x [B, U, D], enc [B, S, kdim], src_pad [B, S] -> (output
        [B, U, D], alpha [B, H, U, S]); ``hard``: the pointer walk at
        ``visible`` / ``is_end`` [B] and soft lookback over the frames up
        to each pointer, -> (output, (ptrs, stuck))."""
        B, U, D = x.shape
        S = enc.shape[1]
        H = self.num_heads
        Dh = D // H

        def split(t, L):
            return t.reshape(B, L, H, Dh).transpose(1, 2)

        q = split(dense(self.q_proj, x), U)
        k = split(dense(self.k_proj, enc), S)
        v = split(dense(self.v_proj, enc), S)
        mq = split(dense(self.mono_q_proj, x), U)
        mk = split(dense(self.mono_k_proj, enc), S)
        energy = (torch.einsum("bhud,bhsd->bhus", mq.float(), mk.float())
                  * Dh ** -0.5 + self.energy_bias)
        if ctx is not None and self.noise_std:
            energy = energy + self.noise_std * ctx.normal(
                energy.shape).to(energy.device)
        p_sel = torch.sigmoid(energy)
        soft = torch.einsum("bhud,bhsd->bhus", q.float(), k.float()) * (
            Dh ** -0.5)
        soft = torch.where(src_pad[:, None, None, :], MASK_VALUE, soft)

        if hard:
            ptrs, stuck = hard_pointers(p_sel, visible, is_end)
            iota = torch.arange(S, device=x.device)
            allowed = ((iota <= ptrs[..., None])
                       & (iota < visible[:, None, None, None]))
            # keep frame 0 attendable so that the softmax stays defined
            first = allowed[..., :1] | ~allowed.any(-1, keepdim=True)
            allowed = torch.cat([first, allowed[..., 1:]], dim=-1)
            beta = torch.softmax(torch.where(allowed, soft, MASK_VALUE),
                                 dim=-1)
            second = (ptrs, stuck)
        else:
            alpha = expected_alignment(p_sel, src_pad)
            # beta(s) = sum_{t >= s} alpha(t) softmax_{<=t}(soft)(s)
            exp_soft = torch.exp(soft - soft.amax(-1, keepdim=True))
            cum = torch.cumsum(exp_soft, dim=-1)
            ratio = alpha / cum.clamp(min=1e-10)
            rev = torch.flip(torch.cumsum(torch.flip(ratio, [-1]), -1), [-1])
            beta = exp_soft * rev
            beta = beta / beta.sum(-1, keepdim=True).clamp(min=1e-10)
            second = alpha
        out = torch.einsum("bhus,bhsd->bhud", beta.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(B, U, D)
        return dense(self.out_proj, out), second


class MMADecoderLayer(nn.Module):
    """Pre-LN decoder layer: self-attention, monotonic encoder attention,
    ReLU FFN (JAX ``MMADecoderLayer``, no dropout)."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int, kdim: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(dim)
        self.encoder_attn = MonotonicCrossAttention(dim, num_heads, kdim)
        self.encoder_attn_layer_norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, dim)
        self.final_layer_norm = nn.LayerNorm(dim)

    def forward(self, x, enc, src_pad, self_bias, ctx=None, hard=False,
                visible=None, is_end=None):
        x = x + self_attention(self.self_attn,
                               ln(self.self_attn_layer_norm, x), self_bias)
        h, second = self.encoder_attn(ln(self.encoder_attn_layer_norm, x),
                                      enc, src_pad, ctx, hard, visible,
                                      is_end)
        x = x + h
        h = dense(self.fc2, F.relu(dense(self.fc1, ln(self.final_layer_norm,
                                                      x))))
        return x + h, second


class MMADecoder(nn.Module):
    def __init__(self, cfg: CaatConfig, enc_dim: int):
        super().__init__()
        D = cfg.decoder_embed_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, D)
        self.layers = nn.ModuleList(
            MMADecoderLayer(D, cfg.decoder_ffn_embed_dim,
                            cfg.decoder_attention_heads, enc_dim)
            for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(D)


class MMAModel(nn.Module):
    """wav2vec encoder + monotonic-attention decoder (the simultaneous
    baseline; JAX ``MMAModel``)."""

    #: the encoder that the freeze schedules reach (``CaatModelBase``)
    encoder_prefix = "encoder.w2v2_model."

    def __init__(self, w2v_cfg: Wav2Vec2Config, cfg: CaatConfig):
        super().__init__()
        self.w2v_cfg, self.cfg = w2v_cfg, cfg
        self.encoder = _S2SEncoder(w2v_cfg, "blockwise")
        self.decoder = MMADecoder(cfg, w2v_cfg.encoder_embed_dim)

    def encode(self, source: torch.Tensor,
               padding_mask: Optional[torch.Tensor] = None,
               main_context: Optional[int] = None,
               right_context: Optional[int] = None,
               ctx: Optional[DropoutContext] = None):
        """-> (encoder states [B, T, D], frame padding mask or None)."""
        return self.encoder.w2v2_model.extract_features(
            source, padding_mask, main_context, right_context, ctx)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        W = self.decoder.embed_tokens.weight
        return F.linear(ln(self.decoder.layer_norm, x).float(), W.float())

    def forward(self, source: torch.Tensor, prev_tokens: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                ctx: Optional[DropoutContext] = None):
        """Training forward (soft monotonic attention, the energy noise
        drawn from ``ctx``) -> (float32 logits [B, U, V], alphas
        [L, B, H, U, S])."""
        enc, enc_pad = self.encode(source, padding_mask, ctx=ctx)
        if enc_pad is None:
            enc_pad = torch.zeros(enc.shape[:2], dtype=torch.bool,
                                  device=enc.device)
        x, self_bias = embed_prev(self.decoder.embed_tokens.weight, self.cfg,
                                  prev_tokens)
        alphas = []
        for layer in self.decoder.layers:
            x, a = layer(x, enc, enc_pad, self_bias, ctx)
            alphas.append(a)
        return self._logits(x), torch.stack(alphas)

    def hard_decode_step(self, prev_tokens, token_lens, enc, enc_pad,
                         visible, is_end):
        """Streaming scoring with hard monotonic attention (JAX
        ``hard_decode_step``): the decoder recomputed over the padded
        prefixes.  prev_tokens [B, U_pad] (eos first), token_lens [B], enc
        [B, S, D], enc_pad [B, S], visible [B], is_end [B] -> (float32
        logits [B, V] at each row's last position, need_more [B]: a head
        of some layer is stuck there)."""
        x, self_bias = embed_prev(self.decoder.embed_tokens.weight, self.cfg,
                                  prev_tokens)
        B = prev_tokens.shape[0]
        rows = torch.arange(B, device=prev_tokens.device)
        last = (token_lens - 1).long()
        need_more = torch.zeros(B, dtype=torch.bool,
                                device=prev_tokens.device)
        for layer in self.decoder.layers:
            x, (_, stuck) = layer(x, enc, enc_pad, self_bias, hard=True,
                                  visible=visible, is_end=is_end)
            need_more |= stuck[rows, :, last].any(-1)
        return self._logits(x[rows, last]), need_more


def latency_loss(alphas: torch.Tensor, src_lens: torch.Tensor,
                 tgt_pad: torch.Tensor) -> torch.Tensor:
    """Differentiable average-lagging regulariser over the expected
    alignment positions (JAX ``latency_loss``): alphas [L, B, H, U, S],
    src_lens [B], tgt_pad [B, U] -> scalar."""
    L, B, H, U, S = alphas.shape
    pos = torch.arange(S, dtype=torch.float32, device=alphas.device)
    g = torch.einsum("lbhus,s->lbhu", alphas, pos).mean(dim=(0, 2))
    tgt_lens = (~tgt_pad).sum(1)
    gamma = tgt_lens / src_lens.clamp(min=1)
    oracle = (torch.arange(U, device=alphas.device)[None, :]
              / gamma.clamp(min=1e-6)[:, None])
    lag = torch.where(tgt_pad, 0.0, (g - oracle).clamp(min=0.0))
    return lag.sum() / tgt_lens.sum().clamp(min=1)
