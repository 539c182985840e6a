"""CTC and seq2seq fine-tuning heads on the wav2vec encoder, blockwise
(the default) or full-context (``encoder_type="full"``) (torch port of
``wav2vec_s_tpu/models/asr.py``).

Twins of the reference's fork-shipped fine-tune models
(fairseq/fairseq/models/wav2vec/wav2vec2_asr.py): ``Wav2VecCtc`` (:154,
encoder + final dropout + vocabulary projection, CTC with blank = bos) and
``Wav2Vec2Seq2Seq`` (:247, encoder + cross-attention transformer decoder).
Parameter names follow the fairseq state dicts:

- CTC: ``w2v_encoder.w2v_model.*`` (the encoder) and ``w2v_encoder.proj``;
- seq2seq: ``encoder.w2v2_model.*`` (so a seq2seq run directory warm-starts
  a CAAT encoder through the ``encoder.`` prefix), ``decoder.embed_tokens``,
  ``decoder.layers.{i}.{self_attn, encoder_attn, self_attn_layer_norm,
  encoder_attn_layer_norm, fc1, fc2, final_layer_norm}``, and
  ``decoder.layer_norm`` when pre-LN.

Training draws go through a ``DropoutContext`` (``ops/dropout.py``, K4 at
every site; the encoder's attention dropout in-kernel under flash); without
one every site is the identity.  As in the JAX twin the decoder has no
dropout on its embeddings, and its FFN drops the ReLU output at
``dropout`` (not ``activation_dropout``).

``ctc_loss`` gives ``optax.ctc_loss``'s value, summed, on every row:
``F.ctc_loss`` on the rows whose labels fit their frames, and optax's
recursion with its finite ``log_epsilon`` floor on the rows that cannot
(where ``F.ctc_loss`` is infinite).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from wav2vec_s_tpu_torch.models.caat.config import CaatConfig
from wav2vec_s_tpu_torch.models.modules import (
    MultiheadAttention, dense, ln, self_attention)
from wav2vec_s_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from wav2vec_s_tpu_torch.ops.block_mask import MASK_VALUE
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext, drop
from wav2vec_s_tpu_torch.utils.positional import PADDING_IDX, sinusoidal_table

#: optax.ctc_loss's log of "impossible" (its ``log_epsilon``)
CTC_LOG_EPSILON = -1e5


class _CtcEncoder(nn.Module):
    def __init__(self, w2v_cfg: Wav2Vec2Config, vocab_size: int,
                 encoder_type: str):
        super().__init__()
        self.w2v_model = Wav2Vec2Model(w2v_cfg, encoder_type=encoder_type)
        self.proj = nn.Linear(w2v_cfg.encoder_embed_dim, vocab_size)


class Wav2VecCtc(nn.Module):
    #: the encoder that the freeze schedules reach (``CaatModelBase``)
    encoder_prefix = "w2v_encoder.w2v_model."

    def __init__(self, w2v_cfg: Wav2Vec2Config, vocab_size: int,
                 final_dropout: float = 0.0, encoder_type: str = "blockwise"):
        super().__init__()
        self.w2v_cfg = w2v_cfg
        self.final_dropout = final_dropout
        self.w2v_encoder = _CtcEncoder(w2v_cfg, vocab_size, encoder_type)

    def forward(self, source: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                main_context: Optional[int] = None,
                right_context: Optional[int] = None,
                ctx: Optional[DropoutContext] = None):
        """source [B, S] samples -> (float32 logits [B, T, V], frame
        padding mask [B, T])."""
        x, pad = self.w2v_encoder.w2v_model.extract_features(
            source, padding_mask, main_context, right_context, ctx)
        x = drop(ctx, x, self.final_dropout)
        logits = dense(self.w2v_encoder.proj, x).float()
        if pad is None:
            pad = torch.zeros(logits.shape[:2], dtype=torch.bool,
                              device=logits.device)
        return logits, pad


def ctc_feasible(logit_pad: torch.Tensor, targets: torch.Tensor,
                 target_pad: torch.Tensor) -> torch.Tensor:
    """[B] bool: the row's labels fit its frames (one frame per label and
    one blank between each pair of equal neighbours), so that some CTC
    path exists."""
    lab = ~target_pad
    repeats = ((targets[:, 1:] == targets[:, :-1]) & lab[:, 1:]).sum(1)
    return (~logit_pad).sum(1) >= lab.sum(1) + repeats


def ctc_floor_loss(logprobs: torch.Tensor, logit_pad: torch.Tensor,
                   labels: torch.Tensor, label_pad: torch.Tensor,
                   blank: int = 0) -> torch.Tensor:
    """Per-row CTC loss by optax's recursion (``ctc_loss_with_forward_probs``)
    on float32 log-probs [B, T, V]: every impossible transition costs
    ``CTC_LOG_EPSILON`` instead of -inf, so a row whose labels do not fit
    its frames has a finite loss (~1e5) and a finite gradient.  A loop over
    T of small ops: for the rare infeasible rows only."""
    B, T, _ = logprobs.shape
    N = labels.shape[1]
    eps = CTC_LOG_EPSILON
    labels = labels.long()
    lens = N - label_pad.long().sum(1)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    lp_phi = logprobs[:, :, blank]                                 # [B, T]
    lp_emit = torch.gather(logprobs, 2,
                           labels[:, None, :].expand(B, T, N))     # [B, T, N]
    pads = logit_pad.float()

    def add_phi(phi, score):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)], -1)

    phi = torch.full((B, N + 1), eps, device=logprobs.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), eps, device=logprobs.device)
    for t in range(T):
        pad = pads[:, t, None]
        prev_phi = add_phi(phi, emit + eps * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[:, t],
                                    emit + lp_emit[:, t])
        next_phi = add_phi(prev_phi + lp_phi[:, t, None],
                           emit + lp_phi[:, t, None] + eps * (1.0 - repeat))
        emit, phi = (pad * emit + (1.0 - pad) * next_emit,
                     pad * phi + (1.0 - pad) * next_phi)
    last = add_phi(phi, emit)
    return -torch.gather(last, 1, lens[:, None])[:, 0]


def ctc_loss(logits: torch.Tensor, logit_pad: torch.Tensor,
             targets: torch.Tensor, target_pad: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Summed CTC loss (fairseq criterions/ctc.py semantics, blank = bos)
    with ``optax.ctc_loss``'s value on every row.  logits [B, T, V] float32,
    logit_pad [B, T], targets [B, N] with ``target_pad`` trailing.

    ``F.ctc_loss`` computes the rows whose labels fit their frames; its
    backward is not deterministic on the card (atomics).  A row that
    cannot fit has no path: ``F.ctc_loss`` would give inf (or 0 with
    ``zero_infinity``) where optax gives its finite floor, so those rows
    (found with one read of a [B] mask) run ``ctc_floor_loss``."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    ok = ctc_feasible(logit_pad, targets, target_pad)
    per = F.ctc_loss(lp.double().transpose(0, 1), targets.long(),
                     (~logit_pad).sum(1), (~target_pad).sum(1), blank=blank,
                     reduction="none", zero_infinity=True)
    if bool(ok.all()):
        return per.sum().float()
    rows = (~ok).nonzero()[:, 0]
    floor = ctc_floor_loss(lp[rows], logit_pad[rows], targets[rows],
                           target_pad[rows], blank)
    return per.sum().float() + floor.sum()   # ``per`` is 0 on those rows


def ctc_greedy_decode(logits: torch.Tensor, logit_pad: torch.Tensor,
                      blank: int = 0) -> List[List[int]]:
    """Best-path decode on the host: argmax (lowest index among equals),
    collapse repeats, drop blanks -> one list of ids per row."""
    ids = logits.argmax(-1).cpu().numpy()
    pad = logit_pad.cpu().numpy()
    out = []
    for b in range(ids.shape[0]):
        prev, seq = -1, []
        for t in range(ids.shape[1]):
            if pad[b, t]:
                break
            i = int(ids[b, t])
            if i != blank and i != prev:
                seq.append(i)
            prev = i
        out.append(seq)
    return out


class TransformerDecoderLayer(nn.Module):
    """fairseq ``TransformerDecoderLayer`` parameters: self-attention,
    encoder attention (keys and values from the ``kdim``-wide encoder
    output), FFN, a norm for each."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int, kdim: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(dim)
        self.encoder_attn = MultiheadAttention(dim, num_heads, kdim=kdim)
        self.encoder_attn_layer_norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, dim)
        self.final_layer_norm = nn.LayerNorm(dim)

    def forward(self, x, enc, self_bias, cross_bias, normalize_before: bool,
                dropout: float, attention_dropout: float,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """The pre- or post-LN layer of the JAX ``TransformerDecoderLayer``:
        each block's output dropped at ``dropout``, the attention
        probabilities at ``attention_dropout``."""
        def block(norm, h_fn, x):
            h = ln(norm, x) if normalize_before else x
            x = x + drop(ctx, h_fn(h), dropout)
            return x if normalize_before else ln(norm, x)

        x = block(self.self_attn_layer_norm, lambda h: self_attention(
            self.self_attn, h, self_bias, attention_dropout, ctx), x)
        x = block(self.encoder_attn_layer_norm, lambda h: self_attention(
            self.encoder_attn, h, cross_bias, attention_dropout, ctx,
            kv=enc), x)
        return block(self.final_layer_norm, lambda h: dense(self.fc2, drop(
            ctx, F.relu(dense(self.fc1, h)), dropout)), x)


class Seq2SeqDecoder(nn.Module):
    """The cross-attention decoder over the CAAT config's decoder block
    (JAX ``Seq2SeqDecoder``): embedding x sqrt(D), fairseq sinusoidal
    positions, additive causal and padding masks at ``MASK_VALUE``, the
    layers, a final norm when pre-LN, float32 logits against the embedding
    (tied)."""

    def __init__(self, cfg: CaatConfig, enc_dim: int):
        super().__init__()
        self.cfg = cfg
        D = cfg.decoder_embed_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, D)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(D, cfg.decoder_ffn_embed_dim,
                                    cfg.decoder_attention_heads, enc_dim)
            for _ in range(cfg.decoder_layers))
        self.layer_norm = (nn.LayerNorm(D) if cfg.decoder_normalize_before
                           else None)

    def forward(self, prev_tokens: torch.Tensor, enc: torch.Tensor,
                enc_pad: torch.Tensor,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """prev_tokens [B, U] (eos first), enc [B, T, enc_dim], enc_pad
        [B, T] -> float32 logits [B, U, V]."""
        c = self.cfg
        x, self_bias = embed_prev(self.embed_tokens.weight, c, prev_tokens)
        cross_bias = self.cross_bias(prev_tokens.shape[1], enc_pad)
        for layer in self.layers:
            x = layer(x, enc, self_bias, cross_bias,
                      c.decoder_normalize_before, c.dropout,
                      c.attention_dropout, ctx)
        if self.layer_norm is not None:
            x = ln(self.layer_norm, x)
        W = self.embed_tokens.weight
        return F.linear(x.float(), W.float())

    def cross_bias(self, U: int, enc_pad: torch.Tensor) -> torch.Tensor:
        """The encoder attention's additive mask: the padded frames."""
        return torch.where(enc_pad, MASK_VALUE, 0.0)[:, None, None, :]


def embed_prev(W: torch.Tensor, cfg: CaatConfig, prev_tokens: torch.Tensor):
    """The decoder input of the JAX seq2seq, wait-k and MMA decoders:
    (the embedding ``W`` in the compute dtype at ``prev_tokens`` x sqrt(D)
    plus fairseq sinusoidal positions, [B, U, D]; the additive causal and
    padding self-attention mask at ``MASK_VALUE``, [B, 1, U, U])."""
    D = cfg.decoder_embed_dim
    U = prev_tokens.shape[1]
    dev = prev_tokens.device
    x = W.to(cfg.compute_dtype)[prev_tokens] * (D ** 0.5)
    pad_mask = prev_tokens == cfg.pad
    nonpad = (~pad_mask).long()
    positions = torch.cumsum(nonpad, dim=1) * nonpad + PADDING_IDX
    table = sinusoidal_table(U + PADDING_IDX + 2, D, dev)
    x = x + table[positions].to(x.dtype)
    causal = torch.triu(torch.full((U, U), MASK_VALUE, device=dev),
                        diagonal=1)
    pad_bias = torch.where(pad_mask, MASK_VALUE, 0.0)[:, None, None, :]
    return x, causal[None, None] + pad_bias


class _S2SEncoder(nn.Module):
    def __init__(self, w2v_cfg: Wav2Vec2Config, encoder_type: str):
        super().__init__()
        self.w2v2_model = Wav2Vec2Model(w2v_cfg, encoder_type=encoder_type)


class Wav2Vec2Seq2Seq(nn.Module):
    """Encoder-decoder fine-tune head (wav2vec2_asr.py:247)."""

    #: the encoder that the freeze schedules reach (``CaatModelBase``)
    encoder_prefix = "encoder.w2v2_model."

    def __init__(self, w2v_cfg: Wav2Vec2Config, cfg: CaatConfig,
                 encoder_type: str = "blockwise"):
        super().__init__()
        self.w2v_cfg = w2v_cfg
        self.cfg = cfg
        self.encoder = _S2SEncoder(w2v_cfg, encoder_type)
        self.decoder = Seq2SeqDecoder(cfg, w2v_cfg.encoder_embed_dim)

    def encode(self, source: torch.Tensor,
               padding_mask: Optional[torch.Tensor] = None,
               main_context: Optional[int] = None,
               right_context: Optional[int] = None,
               ctx: Optional[DropoutContext] = None):
        """source [B, S] -> (encoder states [B, T, D], frame padding mask
        [B, T])."""
        enc, pad = self.encoder.w2v2_model.extract_features(
            source, padding_mask, main_context, right_context, ctx)
        if pad is None:
            pad = torch.zeros(enc.shape[:2], dtype=torch.bool,
                              device=enc.device)
        return enc, pad

    def forward(self, source: torch.Tensor, prev_tokens: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                main_context: Optional[int] = None,
                right_context: Optional[int] = None,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """Teacher-forcing forward: float32 logits [B, U, V]."""
        enc, enc_pad = self.encode(source, padding_mask, main_context,
                                   right_context, ctx)
        return self.decoder(prev_tokens, enc, enc_pad, ctx)

    def decode_logits(self, prev_tokens: torch.Tensor, enc: torch.Tensor,
                      enc_pad: torch.Tensor) -> torch.Tensor:
        """Inference decoder (no dropout): float32 logits [B, U, V]."""
        return self.decoder(prev_tokens, enc, enc_pad)

