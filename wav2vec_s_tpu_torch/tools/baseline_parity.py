"""The simultaneous baselines (wait-k, MMA) and the full-context wav2vec
2.0 model on a device against the same on the CPU, at tiny widths: the
training loss and every gradient (dense or flash encoder; MMA with its
energy noise drawn from the step generator, or none), the full-context
``extract_features`` and pre-training loss, the group-norm blockwise
encoder, ``MMAModel.hard_decode_step``, and the words and delays of
``WaitkAgent`` and ``MMAStreamingAgent`` through ``SimulEvaluator``.
``chip_smoke.py`` (phase 19a) and the card tests
(``tests/test_torch_port_gpu.py``) run them on ``cuda``; the caller turns
TF32 off.

The baselines' training loss is the one the JAX package's MMA test
trains with (``tests/test_mma.py``): the mean token NLL over the unpadded
targets, plus ``0.1 * latency_loss`` for MMA (every row's source length is
the frame count, as there).  float32, the same seeded weights, inputs and
step generator on both devices, so the two compute one function: the
baselines train with their dropouts on (K4 draws the same masks on both
devices), the full-context model with them off.  Tolerances:
``asr_parity``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from wav2vec_s_tpu_torch.models.mma import MMAModel, latency_loss
from wav2vec_s_tpu_torch.models.modules import random_init_
from wav2vec_s_tpu_torch.models.waitk import WaitkModel
from wav2vec_s_tpu_torch.models.wav2vec2 import Wav2Vec2Model
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext
from wav2vec_s_tpu_torch.tools.asr_parity import (
    CAAT, GRAD_TOL, LOSS_RTOL, W2V, batch, gap, vocab)
from wav2vec_s_tpu_torch.tools.dropout_sites import recording_context

__all__ = ["GRAD_TOL", "LOSS_RTOL", "WAITK", "agents", "full_context",
           "gap", "hard_step", "loss_and_grads", "sequence_loss"]

#: wait-k's k and stride at the tiny widths (119 frames of 2400 samples)
WAITK = (2, 3)
#: the baselines' training dropouts (encoder and wait-k decoder; the MMA
#: decoder has none)
ENC = dataclasses.replace(W2V, dropout=0.1, attention_dropout=0.1,
                          activation_dropout=0.1)
DEC = dataclasses.replace(CAAT, dropout=0.1, attention_dropout=0.1)
#: the full-context model: conv positions of 16 taps in 4 groups
FULL = dataclasses.replace(W2V, extractor_mode="default", conv_pos=16,
                           conv_pos_groups=4, final_dim=16, latent_vars=4,
                           n_negatives=5, dropout_input=0.0,
                           dropout_features=0.0)


def model(kind: str, impl: str, dev) -> torch.nn.Module:
    """The tiny wait-k (``"waitk"``) or MMA (``"mma"``) model, weights from
    seed 0, on ``dev``."""
    w2v = dataclasses.replace(ENC, attention_impl=impl)
    made = (WaitkModel(w2v, DEC, *WAITK) if kind == "waitk"
            else MMAModel(w2v, DEC))
    return random_init_(made, torch.Generator().manual_seed(0)).to(dev)


def sequence_loss(kind: str, m: torch.nn.Module, b: Dict[str, torch.Tensor],
                  ctx: Optional[DropoutContext] = None,
                  latency_weight: float = 0.1) -> torch.Tensor:
    """The baselines' training loss on a batch {source, targets,
    padding_mask}: teacher forcing from [eos; targets[:-1]], the mean NLL
    of the unpadded targets, plus ``latency_weight * latency_loss`` of the
    MMA model's expected alignments."""
    tgt = b["targets"]
    pad_id = m.cfg.pad
    prev = torch.cat([torch.full_like(tgt[:, :1], m.cfg.eos), tgt[:, :-1]],
                     dim=1)
    prev = torch.where(tgt == pad_id, pad_id, prev)
    out = m(b["source"], prev, b.get("padding_mask"), ctx=ctx)
    logits, alphas = out if kind == "mma" else (out, None)
    lp = torch.log_softmax(logits, dim=-1)
    nll = -lp.gather(-1, tgt[..., None])[..., 0]
    keep = tgt != pad_id
    loss = (nll * keep).sum() / keep.sum()
    if alphas is not None:
        src_lens = torch.full((tgt.shape[0],), float(alphas.shape[-1]),
                              device=tgt.device)
        loss = loss + latency_weight * latency_loss(alphas, src_lens, ~keep)
    return loss


def loss_and_grads(kind: str, impl: str, dev, noise: bool = False,
                   context: type = DropoutContext
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, {parameter: gradient on the host}) of ``sequence_loss`` in
    training mode (a ``context`` over the step generator of seed 0; MMA's
    energy noise drawn from it when ``noise``, else none)."""
    m = model(kind, impl, dev)
    if kind == "mma" and not noise:
        for layer in m.decoder.layers:
            layer.encoder_attn.noise_std = 0.0
    b = {k: v.to(dev) for k, v in batch().items()}
    loss = sequence_loss(kind, m, b, context(
        torch.Generator().manual_seed(0)))
    loss.backward()
    return loss.item(), {k: p.grad.cpu() for k, p in m.named_parameters()
                         if p.grad is not None}


def dropout_sites(kind: str, impl: str = "dense") -> set:
    """{(shape, rate)} of the dropout sites of one ``loss_and_grads``
    forward, recorded on the CPU (K4's shapes on this path)."""
    sites = set()
    loss_and_grads(kind, impl, "cpu", context=recording_context(sites))
    return {(shape, rate) for shape, _, rate in sites}


def full_context(dev, encoder_type: str = "full"
                 ) -> Tuple[float, Dict[str, torch.Tensor], torch.Tensor]:
    """The group-norm model on ``encoder_type``: (pre-training loss,
    {parameter: gradient}, ``extract_features`` of the batch) on ``dev``,
    the negatives and Gumbel noise from the step generator of seed 0."""
    from wav2vec_s_tpu_torch.train.criterion import wav2vec_loss

    m = random_init_(Wav2Vec2Model(FULL, pretraining=True,
                                   encoder_type=encoder_type),
                     torch.Generator().manual_seed(0)).to(dev)
    b = batch()
    src, pad = b["source"].to(dev), b["padding_mask"].to(dev)
    with torch.no_grad():
        feats, _ = m.extract_features(src, pad)
    g = torch.Generator().manual_seed(1)
    pos = torch.stack([torch.randperm(119, generator=g)[:20].sort().values
                       for _ in range(3)])
    out = m(src, pos, 3, ctx=DropoutContext(torch.Generator().manual_seed(0)))
    loss, _, _ = wav2vec_loss(out)
    loss.backward()
    return loss.item(), {k: p.grad.cpu() for k, p in m.named_parameters()
                         if p.grad is not None}, feats.cpu()


def hard_step(dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits [3, V], need_more [3]) of ``MMAModel.hard_decode_step`` over
    the tiny batch's encoder states, three prefixes of lengths 1, 3 and 5,
    4, 11 and 7 visible frames, the middle stream ended."""
    m = model("mma", "dense", dev).eval()
    b = {k: v.to(dev) for k, v in batch().items()}
    with torch.no_grad():
        enc, pad = m.encode(b["source"], b["padding_mask"])
        prev = torch.full((3, 8), CAAT.pad, device=dev)
        prev[:, 0] = CAAT.eos
        prev[:, 1:5] = b["targets"][:, :4]
        lens = torch.tensor([1, 3, 5], device=dev)
        prev[0, 1:], prev[1, 3:] = CAAT.pad, CAAT.pad
        logits, need = m.hard_decode_step(
            prev, lens, enc, pad, torch.tensor([4, 11, 7], device=dev),
            torch.tensor([False, True, False], device=dev))
    return logits.cpu(), need.cpu()


def agents(dev) -> List[Tuple[str, str, List[float]]]:
    """(agent, text, delays in ms) per clip of ``WaitkAgent`` and
    ``MMAStreamingAgent`` under ``SimulEvaluator`` on two seeded-noise
    clips of 0.15 and 0.2 s (the tiny model's 20-sample hop: 119 and 159
    frames)."""
    from wav2vec_s_tpu_torch.models.waitk import WaitkAgent
    from wav2vec_s_tpu_torch.stream.agent import SimulEvaluator
    from wav2vec_s_tpu_torch.stream.mma_agent import MMAStreamingAgent

    v = vocab()
    waitk = model("waitk", "dense", dev).eval()
    mma = model("mma", "dense", dev).eval()
    with torch.no_grad():
        # the random MMA model's heads stop (energy bias 0, not -2) and it
        # writes words before eos (its eos row scaled down)
        mma.decoder.embed_tokens.weight[CAAT.eos] *= 0.1
        for layer in mma.decoder.layers:
            layer.encoder_attn.energy_bias.fill_(0.0)
    factories = {
        "waitk": lambda: WaitkAgent(waitk, v, *WAITK,
                                    frames_per_sample=1 / 20.0, max_len=8),
        "mma": lambda: MMAStreamingAgent(
            mma, v, main_context=W2V.main_context,
            right_context=W2V.right_context, eager=True, max_len=8,
            audio_buckets=[1600, 3200, 4800], token_buckets=[8, 16]),
    }
    rng = np.random.default_rng(0)
    wavs = [(rng.standard_normal(n) * 0.3).astype(np.float32)
            for n in (2400, 3200)]
    out = []
    for name, factory in factories.items():
        ev = SimulEvaluator(factory, segment_size_ms=25)
        for w in wavs:
            r = ev.run_instance(w, "w1 w2")
            out.append((name, r.hypo, list(r.delays_ms)))
    return out
