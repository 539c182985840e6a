"""W2V2-CAAT parameter container (torch port of
``wav2vec_s_tpu/models/caat/transducer_model.py``).

Module tree and names follow rain's ``w2v2_caat`` state dict
(rain/models/w2v2_transducer.py:101-313), the naming
``wav2vec_s_tpu/checkpoint/torch_export.export_caat_params`` emits:

- ``encoder.w2v2_model.*``        the wav2vec-S encoder;
- ``encoder.encoder_proj``        optional ``--use-linear-layer`` projection;
- ``decoder.lm.*``                the IsolatedDecoder LM;
- ``decoder.jointer.layers.{i}``  the jointer;
- ``decoder.transducer_out.output_proj``  the vocabulary projection, the
  same tensor as ``decoder.lm.embed_tokens.weight`` when
  ``share_input_output_embed``.

``encode`` is the one-shot encoder forward the decoders run (no grad),
``decode_step`` the recompute-over-cache next-symbol scorer of the host
beam searcher; ``forward`` is the fine-tuning forward to the joint lattice
states, and ``caat_loss`` the delay-transducer + label-smoothed CE loss over them
(rain ``TransducerOut``, attention_transducer.py:289-454).  As in the JAX
package, the loss walks the batch in chunks whose [b, G, U+1, V] float32
logits are recomputed in the backward (``torch.utils.checkpoint``, the twin
of ``jax.checkpoint``) instead of being kept.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from wav2vec_s_tpu_torch.models.caat.config import CaatConfig
from wav2vec_s_tpu_torch.models.caat.decoder import IsolatedDecoder
from wav2vec_s_tpu_torch.models.caat.jointer import MHAJointNet, group_lengths
from wav2vec_s_tpu_torch.models.modules import dense
from wav2vec_s_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext
from wav2vec_s_tpu_torch.ops.transducer import (
    DELAY_FUNCS, delay_transducer_loss)


class _Encoder(nn.Module):
    def __init__(self, w2v_cfg: Wav2Vec2Config, cfg: CaatConfig):
        super().__init__()
        self.w2v2_model = Wav2Vec2Model(w2v_cfg)
        self.encoder_proj = (nn.Linear(w2v_cfg.encoder_embed_dim,
                                       cfg.decoder_embed_dim)
                             if cfg.encoder_proj else None)


class _TransducerOut(nn.Module):
    def __init__(self, cfg: CaatConfig, embed: nn.Embedding):
        super().__init__()
        self.output_proj = nn.Linear(cfg.decoder_embed_dim, cfg.vocab_size,
                                     bias=False)
        if cfg.share_input_output_embed:
            self.output_proj.weight = embed.weight


class _Decoder(nn.Module):
    def __init__(self, cfg: CaatConfig, enc_dim: int):
        super().__init__()
        self.lm = IsolatedDecoder(cfg)
        self.jointer = MHAJointNet(cfg, enc_dim)
        self.transducer_out = _TransducerOut(cfg, self.lm.embed_tokens)


class CaatModelBase(nn.Module):
    """The CAAT models' shared contract over a subclass's ``encoder``,
    ``decoder.lm`` and ``decoder.jointer``: the fine-tuning ``forward``,
    ``encode``, ``decode_step``, ``token_embedding`` and ``output_logits``
    (the LM's embedding; ``W2V2CaatModel`` overrides it for an untied
    projection).  A subclass defines ``_encode(source, padding_mask,
    main_context, right_context, ctx)`` -> (enc [B, S, D], enc_pad [B, S]
    or None) and ``encoder_prefix``, the names under which it keeps the
    encoder that the freeze schedules reach (``recipes.make_freeze_mask``:
    the JAX models' ``encoder`` subtree)."""

    encoder_prefix = "encoder."

    def forward(self, source: torch.Tensor, prev_tokens: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                main_context: Optional[int] = None,
                right_context: Optional[int] = None,
                downsample: Optional[int] = None,
                ctx: Optional[DropoutContext] = None):
        """Fine-tuning forward (JAX ``W2V2CaatModel.__call__``): source
        [B, S] samples (or the family's features / tokens), prev_tokens
        [B, U+1] = [bos; targets] -> (joint_h [B, G, U+1, D], group_lens
        [B] int32).  ``ctx`` carries the step's dropout, layerdrop and
        position-offset draws."""
        enc, enc_pad = self._encode(source, padding_mask, main_context,
                                    right_context, ctx)
        if enc_pad is None:
            enc_pad = torch.zeros(enc.shape[:2], dtype=torch.bool,
                                  device=enc.device)
        h_lm = self.decoder.lm(prev_tokens, ctx)
        joint_h = self.decoder.jointer(h_lm, enc, enc_pad, downsample, ctx)
        ds = (self.cfg.transducer_downsample if downsample is None
              else downsample)
        if ds > 0:
            glens = group_lengths(enc_pad, ds)
        else:
            glens = torch.ones(enc.shape[0], dtype=torch.int32,
                               device=enc.device)
        return joint_h, glens

    @torch.no_grad()
    def encode(self, source: torch.Tensor,
               padding_mask: Optional[torch.Tensor] = None,
               main_context: Optional[int] = None,
               right_context: Optional[int] = None):
        """One-shot blockwise encode (JAX ``W2V2CaatModel.encode``):
        source -> ([B, T, D_out] features, frame padding mask or None)."""
        return self._encode(source, padding_mask, main_context,
                            right_context)

    def token_embedding(self) -> torch.Tensor:
        """The [V, D] matrix ``caat_loss`` projects joint states with: the
        LM's embedding, tied or not (as the JAX recipe)."""
        return self.decoder.lm.embed_tokens.weight

    def output_logits(self, h: torch.Tensor) -> torch.Tensor:
        """Joint states -> float32 vocabulary logits."""
        return F.linear(h.float(), self.token_embedding().float())

    @torch.no_grad()
    def decode_step(self, prev_tokens: torch.Tensor,
                    token_lens: torch.Tensor, enc: torch.Tensor,
                    enc_pad: torch.Tensor) -> torch.Tensor:
        """Streaming decode scoring (JAX ``W2V2CaatModel.decode_step``):
        float32 log-probs [K, V] of the next symbol, the prefix LM
        recomputed over the padded prefixes (recompute-over-cache; the
        scorer of the host searcher's engine).

        prev_tokens [K, U_pad] right-padded prefixes (bos first);
        token_lens [K] true lengths; enc [K, S, D] encoder states revealed
        so far; enc_pad [K, S] True where a frame is not yet visible."""
        h_lm = self.decoder.lm(prev_tokens)
        rows = torch.arange(h_lm.shape[0], device=h_lm.device)
        h_last = h_lm[rows, token_lens.long() - 1][:, None]     # [K, 1, D]
        joint = self.decoder.jointer(h_last, enc, enc_pad, downsample=-1)
        return torch.log_softmax(self.output_logits(joint)[:, 0, 0], dim=-1)


class W2V2CaatModel(CaatModelBase):
    encoder_prefix = "encoder.w2v2_model."

    def __init__(self, w2v_cfg: Wav2Vec2Config, cfg: CaatConfig):
        super().__init__()
        self.w2v_cfg = w2v_cfg
        self.cfg = cfg
        self.encoder = _Encoder(w2v_cfg, cfg)
        # the jointer's keys/values read the encoder output: projected to
        # the decoder width with --use-linear-layer, else the encoder width
        enc_dim = (cfg.decoder_embed_dim if cfg.encoder_proj
                   else w2v_cfg.encoder_embed_dim)
        self.decoder = _Decoder(cfg, enc_dim)

    def _encode(self, source, padding_mask, main_context, right_context,
                ctx: Optional[DropoutContext] = None):
        enc, enc_pad = self.encoder.w2v2_model.extract_features(
            source, padding_mask, main_context, right_context, ctx)
        if self.encoder.encoder_proj is not None:
            enc = dense(self.encoder.encoder_proj, enc)
        return enc, enc_pad

    def output_logits(self, h: torch.Tensor) -> torch.Tensor:
        """Joint states -> float32 vocabulary logits (the shared embedding
        by default)."""
        proj = self.decoder.transducer_out.output_proj
        if self.cfg.share_input_output_embed:
            return F.linear(h.float(), proj.weight.float())
        return dense(proj, h).float()

    @torch.no_grad()
    def lm_log_probs(self, prev_tokens: torch.Tensor) -> torch.Tensor:
        """Language-model view of the decoupled decoder (JAX
        ``W2V2CaatModel.lm_log_probs``): float32 next-token log-probs
        [B, U, V] of the IsolatedDecoder in eval mode under the (shared)
        output embedding, the teacher-forcing LM of the training forward.
        The measurement behind ``eval.cli eval-lm``."""
        h_lm = self.decoder.lm(prev_tokens)
        return torch.log_softmax(self.output_logits(h_lm), dim=-1)


def label_smoothed_ce(lprobs: torch.Tensor, targets: torch.Tensor,
                      epsilon: float, ignore_index: int):
    """Summed label-smoothed NLL (fairseq label_smoothed_cross_entropy.py):
    lprobs [..., V], targets [...] -> (loss, nll_loss)."""
    V = lprobs.shape[-1]
    nll = -torch.gather(lprobs, -1, targets.long()[..., None])[..., 0]
    smooth = -lprobs.sum(dim=-1)
    keep = (targets != ignore_index).to(lprobs.dtype)
    eps_i = epsilon / (V - 1)
    loss = (1.0 - epsilon - eps_i) * nll + eps_i * smooth
    return (loss * keep).sum(), (nll * keep).sum()


def caat_loss(joint_h: torch.Tensor, embed_or_proj: torch.Tensor,
              targets: torch.Tensor, group_lens: torch.Tensor,
              tgt_lens: torch.Tensor, cfg: CaatConfig):
    """Transducer + CE loss over the joint lattice (JAX
    ``transducer_model.caat_loss``).

    joint_h [B, G, U+1, D]; embed_or_proj [V, D] (logits = h @ W.T);
    targets [B, U] padded labels; group_lens, tgt_lens [B].  Returns
    (loss, logs), summed over the batch like the reference.  The batch runs
    in chunks of ``max(1, min(B, tokens_per_step // (G * (U+1))))`` rows,
    each under ``torch.utils.checkpoint``.  The JAX scan pads the batch to
    whole chunks with rows that add zero; here the last chunk is shorter
    instead, with the same chunk boundaries and sums."""
    B, G, U1, D = joint_h.shape
    W = embed_or_proj.float()
    delay_fn = DELAY_FUNCS[cfg.delay_func]
    chunk_b = max(1, min(B, cfg.tokens_per_step // (G * U1)))
    gl = group_lens.clamp(min=1)

    def chunk_losses(hc, tgc, glc, tlc):
        logits = torch.matmul(hc.float(), W.t())              # [b, G, U1, V]
        dv = delay_fn(logits.shape[:3], glc, tlc)
        total, lp, ld = delay_transducer_loss(
            logits, tgc, glc, tlc, dv, cfg.delay_scale, cfg.bos,
            cfg.transducer_temperature)
        # label-smoothed CE on the last valid source group (full context)
        bi = torch.arange(hc.shape[0], device=hc.device)
        last_h = hc[bi, glc.long() - 1][:, :-1]              # [b, U, D]
        lprobs = torch.log_softmax(torch.matmul(last_h.float(), W.t()), -1)
        ce, nll = label_smoothed_ce(lprobs, tgc,
                                    cfg.transducer_label_smoothing, cfg.pad)
        return (total.sum() + cfg.transducer_ce_scale * ce, lp.sum(),
                ld.sum(), nll)

    sums = None
    for i in range(math.ceil(B / chunk_b)):
        rows = slice(i * chunk_b, (i + 1) * chunk_b)
        out = checkpoint(chunk_losses, joint_h[rows], targets[rows],
                         gl[rows], tgt_lens[rows], use_reentrant=False,
                         preserve_rng_state=False)
        sums = out if sums is None else tuple(a + b for a, b in zip(sums,
                                                                    out))
    loss, loss_prob, loss_delay, nll = sums
    logs = {"loss": loss, "loss_prob": loss_prob, "loss_delay": loss_delay,
            "nll_loss": nll, "sample_size": (targets != cfg.pad).sum()}
    return loss, logs
