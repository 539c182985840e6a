"""The train step: forward/backward, gradient accumulation, clip, update.

Port of ``wav2vec_s_tpu/train/step.py`` (``TrainState``,
``make_train_step``), the reference Trainer's hot loop
(fairseq/fairseq/trainer.py:632-811): ``update_freq`` accumulation sums
the microbatch gradients, they are normalised by the total sample count
(``multiply_grads(world / sample_size)``), clipped and applied, and a step
whose gradient norm is not finite is skipped (the bf16 replacement for the
fp16 loss scaler's skip).

Eager torch: the gradients accumulate in ``.grad`` across microbatches and
the optimizer updates the parameters in place.  Under a
``parallel.sharding.ParallelPlan`` (data parallelism, ZeRO-1, FSDP) the
summed gradients and the sample count are all-reduced before the
normalisation, so the step divides by the global count as fairseq does;
the optimizer updates the row blocks this rank owns, and the norm is the
global one, read once.  The step reads the
gradient norm on the host once (to decide the skip before anything is
touched); nothing else waits for the device.  The JAX step's
``remat_policy`` and ``flat_optimizer`` options were TPU experiments and
are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from wav2vec_s_tpu_torch.parallel.sharding import local
from wav2vec_s_tpu_torch.train.optim import (
    Adafactor, AdafactorState, Adam, AdamState)

Optimizer = Union[Adam, Adafactor]

#: (batch, generator, step) -> (summed loss, sample count, summed logs)
LossFn = Callable[..., tuple]
#: (named gradients, step) -> None, zeroes frozen gradients in place
GradMask = Callable[[Dict[str, torch.Tensor], int], None]


@dataclasses.dataclass
class TrainState:
    step: int                        # advances on every call, skips too
    model: nn.Module
    opt_state: Union[AdamState, AdafactorState]
    plan: Optional[object] = None    # parallel.sharding.ParallelPlan
    shards: Optional[list] = None    # each parameter's RowShard or None
    optimizer: Optional[Optimizer] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer,
               plan=None) -> "TrainState":
        """A fresh state; with a ``plan`` the model must already be
        prepared (``plan.prepare``) and the moments cover this rank's row
        blocks."""
        params = list(model.parameters())
        if plan is None:
            return cls(0, model, optimizer.init(params),
                       optimizer=optimizer)
        if plan.n_model > 1 and isinstance(optimizer, Adafactor):
            raise ValueError("Adafactor under tensor parallelism: its "
                             "factored moments of a split weight are not "
                             "summed over the model group")
        shards = plan.row_shards(params)
        return cls(0, model, optimizer.init(plan.blocks(params, shards),
                                            shards),
                   plan, shards, optimizer)


def make_train_step(loss_fn: LossFn, optimizer: Optimizer,
                    accum_steps: int = 1,
                    skip_nonfinite: bool = True,
                    grad_mask: Optional[GradMask] = None):
    """Build ``train_step(state, batch, generator) -> (state, logs)``.

    ``loss_fn(batch, generator, step)`` returns a *summed* loss, its sample
    count and a dict of summed metric scalars (the fairseq criterion
    contract) for the model held in ``state``.  With ``accum_steps > 1``
    every tensor of ``batch`` carries a leading microbatch axis.  The logs
    hold the loss_fn's logs summed over microbatches plus ``loss_total``,
    ``sample_size``, ``grad_norm`` (before clipping) and ``skipped``.
    ``grad_mask(named_grads, step)`` zeroes frozen gradients in place
    (``recipes.make_freeze_mask``)."""

    def train_step(state: TrainState, batch, generator: torch.Generator):
        model = state.model
        named = list(dict(model.named_parameters()).items())
        for _, p in named:
            p.grad = None
        loss_total = n_total = None
        logs: Dict[str, torch.Tensor] = {}
        for i in range(accum_steps):
            mb = batch if accum_steps == 1 else {k: v[i]
                                                  for k, v in batch.items()}
            loss, n, mlogs = loss_fn(mb, generator, state.step)
            loss.backward()
            loss = loss.detach()
            n = torch.as_tensor(n, dtype=torch.float32, device=loss.device)
            loss_total = loss if loss_total is None else loss_total + loss
            n_total = n if n_total is None else n_total + n
            for k, v in mlogs.items():
                v = v.detach().float()
                logs[k] = logs[k] + v if k in logs else v

        grads = {name: (p.grad if p.grad is not None
                        else torch.zeros_like(p)) for name, p in named}
        if grad_mask is not None:
            grad_mask(grads, state.step)
        g = list(grads.values())
        plan = state.plan
        n_norm = n_total
        if plan is not None:
            n_norm = plan.reduce(g, n_total)
            g = [local(t) for t in g]        # FSDP2: this rank's rows
            logs.update(loss_total=loss_total, sample_size=n_total)
            plan.reduce_logs(logs)
            loss_total, n_total = logs["loss_total"], logs["sample_size"]
        torch._foreach_div_(g, torch.clamp(n_norm, min=1.0))
        if plan is None:
            gnorm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(g)))
        else:
            gnorm = plan.grad_norm(g)
        ok = not skip_nonfinite or math.isfinite(gnorm.item())
        if ok:
            params = [p for _, p in named]
            if plan is None:
                optimizer.update(params, g, state.opt_state, gnorm)
            else:
                optimizer.update(plan.blocks(params, state.shards),
                                 plan.blocks(g, state.shards),
                                 state.opt_state, gnorm, state.shards)
                plan.after_update(params, state.shards)
        for _, p in named:
            p.grad = None
        state.step += 1
        logs.update(loss_total=loss_total, sample_size=n_total,
                    grad_norm=gnorm)
        if skip_nonfinite:
            logs["skipped"] = torch.tensor(0.0 if ok else 1.0)
        return state, logs

    return train_step
