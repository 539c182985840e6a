"""The training recipes bound to the generic train step (port of
``wav2vec_s_tpu/train/recipes.py``).

- ``make_pretrain_loss_fn``: wav2vec-S streaming pre-training, InfoNCE +
  diversity + features_pen at one (mc, rc) context bucket;
- ``make_caat_loss_fn``: delay-transducer + label-smoothed CE through the
  joint lattice, prev tokens ``[bos; targets]`` built per call;
- ``make_s2s_loss_fn`` / ``make_ctc_loss_fn``: the offline-ASR heads
  (``models/asr.py``), label-smoothed CE with accuracy, and summed CTC;
- ``sample_context_bucket`` / ``DEFAULT_CONTEXT_BUCKETS``: the host-side
  (mc, rc) draw of the sampled-context schedule;
- ``make_freeze_mask``: the reference's encoder freeze schedules, by
  parameter name.
"""

from __future__ import annotations

import random
import re
from typing import Dict, Optional, Sequence, Tuple

import torch

from wav2vec_s_tpu_torch.models.asr import ctc_loss
from wav2vec_s_tpu_torch.models.caat.transducer_model import (
    caat_loss, label_smoothed_ce)
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext
from wav2vec_s_tpu_torch.train.criterion import wav2vec_loss


def make_pretrain_loss_fn(model, main_context: Optional[int] = None,
                          right_context: Optional[int] = None,
                          train: bool = True, plan=None):
    """loss_fn for ``make_train_step`` over ``model`` (a ``Wav2Vec2Model``
    built with ``pretraining=True``): batch {source, mask_positions,
    [padding_mask]}.  Every draw of the update (dropout seed, layerdrop,
    negatives, Gumbel uniforms) comes from the host ``generator`` through
    one ``DropoutContext``, so an update is a function of the generator's
    seed on any device.  ``train=False`` is the validation loss: no
    dropout, hard codes, negatives of a fixed seed; the generator is not
    read.  The step number anneals the Gumbel temperature.  ``plan`` (a
    ``parallel.sharding.ParallelPlan``): the batch is this rank's rows of
    the global batch (``_context``); the model is told its ``Shard``, in
    training and in validation, so the feature penalty and the
    perplexities are means over the global batch and the eval negatives
    the global batch's."""

    def loss_fn(batch, generator: torch.Generator, step: int):
        shard = _shard(batch["source"], plan)
        ctx = DropoutContext(generator, shard) if train else None
        out = model(batch["source"], batch["mask_positions"], step,
                    padding_mask=batch.get("padding_mask"),
                    main_context=main_context, right_context=right_context,
                    ctx=ctx, shard=shard)
        loss, n, logs = wav2vec_loss(out)
        return loss, n, {k: torch.as_tensor(v).float()
                         for k, v in logs.items()
                         if v is not None and k != "sample_size"}

    return loss_fn


def make_caat_loss_fn(model, caat_cfg, main_context: Optional[int] = None,
                      right_context: Optional[int] = None,
                      downsample: Optional[int] = None, train: bool = True,
                      plan=None):
    """loss_fn for ``make_train_step`` over ``model`` (a CAAT model:
    ``W2V2CaatModel``, ``FbankCaatModel`` or ``TextCaatModel``, whose
    ``token_embedding()`` the loss projects with): batch {source, targets,
    [padding_mask]}; each call
    draws the step's dropout seed, layerdrop and position offsets from the
    host ``generator``.  ``train=False`` is the validation loss: no
    ``DropoutContext`` (every dropout site is the identity, no layer is
    dropped, no position offset), the generator is not read.  ``plan``: as
    in ``make_pretrain_loss_fn``."""

    def loss_fn(batch, generator: torch.Generator, step: int):
        tgt = batch["targets"]
        B = tgt.shape[0]
        prev = torch.cat([tgt.new_full((B, 1), caat_cfg.bos), tgt], dim=1)
        ctx = _context(generator, tgt, plan) if train else None
        joint_h, glens = model(batch["source"], prev,
                               padding_mask=batch.get("padding_mask"),
                               main_context=main_context,
                               right_context=right_context,
                               downsample=downsample, ctx=ctx)
        tgt_lens = (tgt != caat_cfg.pad).sum(dim=1).to(torch.int32)
        loss, logs = caat_loss(joint_h, model.token_embedding(),
                               tgt, glens, tgt_lens, caat_cfg)
        n = logs.pop("sample_size")
        return loss, n, {k: v.float() for k, v in logs.items()}

    return loss_fn


def make_s2s_loss_fn(model, caat_cfg, main_context: Optional[int] = None,
                     right_context: Optional[int] = None,
                     label_smoothing: float = 0.1, train: bool = True,
                     plan=None):
    """Label-smoothed CE + accuracy for ``Wav2Vec2Seq2Seq`` (JAX
    ``make_s2s_loss_fn``): the reference's offline ASR/ST stage, fairseq
    ``label_smoothed_cross_entropy --label-smoothing 0.1
    --report-accuracy`` (``eps_i = ls / (V - 1)``); prev tokens are the
    targets shifted right behind eos.  The sample count is the target
    tokens; logs ``nll_loss``, ``n_correct`` (argmax == target on target
    tokens) and ``accuracy``.  ``train`` and ``plan``: as in
    ``make_caat_loss_fn``."""
    pad, eos = caat_cfg.pad, caat_cfg.eos

    def loss_fn(batch, generator: torch.Generator, step: int):
        tgt = batch["targets"]              # [B, U] ends with eos, padded
        prev = torch.cat([tgt.new_full((tgt.shape[0], 1), eos), tgt[:, :-1]],
                         dim=1)
        ctx = _context(generator, tgt, plan) if train else None
        logits = model(batch["source"], prev,
                       padding_mask=batch.get("padding_mask"),
                       main_context=main_context,
                       right_context=right_context, ctx=ctx)
        lprobs = torch.log_softmax(logits.float(), dim=-1)
        loss, nll = label_smoothed_ce(lprobs, tgt, label_smoothing, pad)
        mask = tgt != pad
        ntokens = mask.sum().float()
        n_correct = ((lprobs.argmax(-1) == tgt) & mask).sum().float()
        return loss, ntokens, {
            "nll_loss": nll, "n_correct": n_correct,
            "accuracy": n_correct / torch.clamp(ntokens, min=1.0)}

    return loss_fn


def make_ctc_loss_fn(model, pad: int, eos: int,
                     main_context: Optional[int] = None,
                     right_context: Optional[int] = None, blank: int = 0,
                     train: bool = True, plan=None):
    """Summed CTC for ``Wav2VecCtc`` (JAX ``make_ctc_loss_fn``, fairseq
    criterions/ctc.py, blank = bos): the targets arrive eos-terminated from
    ``CaatBatcher`` and the trailing eos is folded into the label padding
    (fairseq CTC targets carry no eos).  The sample count is the labels;
    logs ``nll_loss`` (the loss) and ``n_frames``."""

    def loss_fn(batch, generator: torch.Generator, step: int):
        tgt = batch["targets"]
        ctx = _context(generator, tgt, plan) if train else None
        logits, lpad = model(batch["source"],
                             padding_mask=batch.get("padding_mask"),
                             main_context=main_context,
                             right_context=right_context, ctx=ctx)
        tpad = (tgt == pad) | (tgt == eos)
        loss = ctc_loss(logits, lpad, tgt, tpad, blank=blank)
        return loss, (~tpad).sum().float(), {
            "nll_loss": loss, "n_frames": (~lpad).sum().float()}

    return loss_fn


def _shard(batch_rows: torch.Tensor, plan):
    """This rank's ``Shard`` of the global batch under a parallel plan,
    else None."""
    return None if plan is None else plan.shard(batch_rows.shape[0])


def _context(generator: torch.Generator, batch_rows: torch.Tensor, plan):
    """The step's ``DropoutContext``; under a parallel plan it holds this
    rank's ``Shard`` of the global batch, so its masks and draws are the
    rows' part of the global batch's."""
    return DropoutContext(generator, _shard(batch_rows, plan))


def sample_context_bucket(rng: random.Random,
                          buckets: Sequence[Tuple[int, int]]):
    """Host-side (mc, rc) draw with the reference distribution
    (wav2vec_S.py:392-395: ``mc = randint(4,16)*2``,
    ``rc = min(randint(2,8)*2, mc // 2)``), snapped to the nearest bucket."""
    mc = rng.randint(4, 16) * 2
    rc = min(rng.randint(2, 8) * 2, mc // 2)
    return min(buckets, key=lambda b: abs(b[0] - mc) + abs(b[1] - rc))


# default bucket set covering the sampled range
DEFAULT_CONTEXT_BUCKETS = (
    (8, 4), (12, 6), (16, 8), (20, 8), (24, 12), (28, 12), (32, 16),
)


def make_freeze_mask(model, freeze_w2v2_enc: int = 0,
                     freeze_finetune_updates: int = 0):
    """Gradient mask for ``make_train_step`` implementing the reference's
    freeze schedules over the encoder's parameters (the names under
    ``model.encoder_prefix``: the JAX models' ``encoder`` subtree):

    - ``freeze_w2v2_enc`` (rain/models/w2v2_transducer.py:163-174): every
      one of them is frozen for good except encoder layers >= N;
    - ``freeze_finetune_updates`` (unidirect_w2v2_encoder.py:585-588): all
      of them get no gradient before step N.

    Frozen gradients are multiplied by 0 in place, as the JAX mask does (a
    non-finite frozen gradient still skips the step)."""
    prefix = model.encoder_prefix
    layer = re.compile(re.escape(prefix) + r"(?:encoder\.)?layers\.(\d+)\.")

    def grad_mask(grads: Dict[str, torch.Tensor], step: int) -> None:
        for name, g in grads.items():
            if not name.startswith(prefix):
                continue
            frozen = 0 < freeze_finetune_updates and step < (
                freeze_finetune_updates)
            if freeze_w2v2_enc > 0:
                m = layer.match(name)
                frozen |= not (m and int(m.group(1)) >= freeze_w2v2_enc)
            if frozen:
                g.mul_(0.0)

    return grad_mask
