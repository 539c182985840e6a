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
touched); nothing else waits for the device.

The JAX step's two memory and launch switches:

- ``remat_policy`` (``run.remat``): the loss forward rematerialized under
  one of ``train.remat.REMAT_POLICIES`` (``dots``, ``nothing``,
  ``offload_dots``), the update's draws replayed in the recompute;
- ``TrainState.create(flat_optimizer=True)`` (``run.flat_optimizer``):
  the optimizer runs over ONE float32 vector padded to a multiple of 64 (JAX ``ravel_padded``).  In
  torch's idiom nothing is raveled per step: ``FlatParams`` makes every
  parameter a view into one contiguous vector and every gradient a view
  into another, so autograd accumulates into the flat gradient and the
  update is a handful of large kernels over the vector.  Adam is
  elementwise and the norm is summed over the per-parameter views, so its
  update equals the tree path's; Adafactor on a 1-D vector is unfactored
  and clips by the whole vector's RMS, as optax is on the JAX flat path.
  Under ZeRO-1 each data rank owns an equal slice of the padded vector;
  FSDP and tensor parallelism hold no whole vector and refuse it.

Under a profiler each micro-batch's ``w2vs/train.forward`` and
``w2vs/train.backward`` and the update's ``w2vs/train.optimizer`` (the
gradient reduction, normalisation, norm, skip test and update) are spans
of the trace (``utils/debug.span``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Union

import torch
from torch import nn

from wav2vec_s_tpu_torch.parallel.sharding import local
from wav2vec_s_tpu_torch.train.optim import (
    Adafactor, AdafactorState, Adam, AdamState)
from wav2vec_s_tpu_torch.train.remat import remat
from wav2vec_s_tpu_torch.utils.debug import span

Optimizer = Union[Adam, Adafactor]
#: the flat vector's length is a multiple of this (JAX ``ravel_padded``)
FLAT_MULTIPLE = 64

#: (batch, generator, step) -> (summed loss, sample count, summed logs)
LossFn = Callable[..., tuple]
#: (named gradients, step) -> None, zeroes frozen gradients in place
GradMask = Callable[[Dict[str, torch.Tensor], int], None]


class FlatParams:
    """The parameters as views into one float32 vector padded with zeros
    to a multiple of ``FLAT_MULTIPLE``, their gradients as views into
    another (the padded tail carries zero gradients: the update is a no-op
    there)."""

    def __init__(self, params: List[nn.Parameter]):
        kinds = {(p.dtype, p.device) for p in params}
        if len(kinds) != 1 or next(iter(kinds))[0] != torch.float32:
            raise ValueError(f"the flat optimizer takes float32 parameters "
                             f"on one device, not {sorted(map(str, kinds))}")
        n = sum(p.numel() for p in params)
        self.size = n
        self.param = params[0].new_zeros(n + (-n) % FLAT_MULTIPLE)
        self.grad = torch.zeros_like(self.param)
        self._grads = []
        off = 0
        with torch.no_grad():
            for p in params:
                k = p.numel()
                self.param[off:off + k].copy_(p.reshape(-1))
                p.data = self.param[off:off + k].view_as(p)
                self._grads.append((p, self.grad[off:off + k].view_as(p)))
                off += k

    def zero_grad(self) -> None:
        """Zero the flat gradient and point every ``.grad`` back into it
        (a caller that set ``.grad`` to None, as the trainer does after an
        out-of-memory batch, loses nothing)."""
        self.grad.zero_()
        for p, g in self._grads:
            p.grad = g


@dataclasses.dataclass
class TrainState:
    step: int                        # advances on every call, skips too
    model: nn.Module
    opt_state: Union[AdamState, AdafactorState]
    plan: Optional[object] = None    # parallel.sharding.ParallelPlan
    shards: Optional[list] = None    # each parameter's RowShard or None
    optimizer: Optional[Optimizer] = None
    flat: Optional[FlatParams] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer,
               plan=None, flat_optimizer: bool = False) -> "TrainState":
        """A fresh state; with a ``plan`` the model must already be
        prepared (``plan.prepare``) and the moments cover this rank's row
        blocks.  ``flat_optimizer``: the moments cover one flat vector
        (``FlatParams``), created after the model is on its device; the
        step follows the state."""
        flat = None
        if flat_optimizer:
            if plan is not None and plan.mode == "fsdp":
                raise ValueError("the flat optimizer under FSDP: a rank "
                                 "holds no whole parameter to ravel")
            if plan is not None and plan.n_model > 1:
                raise ValueError("the flat optimizer under tensor "
                                 "parallelism: a TP shard does not hold "
                                 "the whole flat vector")
            flat = FlatParams(list(model.parameters()))
        state = cls(0, model, None, plan, None, optimizer, flat)
        params = state.opt_params()
        if plan is None:
            state.opt_state = optimizer.init(params)
            return state
        if plan.n_model > 1 and isinstance(optimizer, Adafactor):
            raise ValueError("Adafactor under tensor parallelism: its "
                             "factored moments of a split weight are not "
                             "summed over the model group")
        if flat is not None and flat.param.numel() % plan.n_data:
            raise ValueError(f"the flat vector of {flat.param.numel()} "
                             f"does not split evenly over {plan.n_data} "
                             f"data ranks")
        state.shards = plan.row_shards(params)
        state.opt_state = optimizer.init(plan.blocks(params, state.shards),
                                         state.shards)
        return state

    def opt_params(self) -> List[torch.Tensor]:
        """What the optimizer updates: the flat vector, or every
        parameter."""
        if self.flat is not None:
            return [self.flat.param]
        return list(self.model.parameters())


def make_train_step(loss_fn: LossFn, optimizer: Optimizer,
                    accum_steps: int = 1,
                    skip_nonfinite: bool = True,
                    grad_mask: Optional[GradMask] = None,
                    remat_policy: str = "none"):
    """Build ``train_step(state, batch, generator) -> (state, logs)``.

    ``loss_fn(batch, generator, step)`` returns a *summed* loss, its sample
    count and a dict of summed metric scalars (the fairseq criterion
    contract) for the model held in ``state``.  With ``accum_steps > 1``
    every tensor of ``batch`` carries a leading microbatch axis.  The logs
    hold the loss_fn's logs summed over microbatches plus ``loss_total``,
    ``sample_size``, ``grad_norm`` (before clipping) and ``skipped``.
    ``grad_mask(named_grads, step)`` zeroes frozen gradients in place
    (``recipes.make_freeze_mask``).  ``remat_policy``, and the flat
    optimizer of a state created with one: module docstring."""
    loss_fn = remat(loss_fn, remat_policy)

    def train_step(state: TrainState, batch, generator: torch.Generator):
        model = state.model
        named = list(dict(model.named_parameters()).items())
        flat = state.flat
        if flat is not None:
            flat.zero_grad()
        else:
            for _, p in named:
                p.grad = None
        loss_total = n_total = None
        logs: Dict[str, torch.Tensor] = {}
        for i in range(accum_steps):
            mb = batch if accum_steps == 1 else {k: v[i]
                                                  for k, v in batch.items()}
            with span("train.forward"):
                loss, n, mlogs = loss_fn(mb, generator, state.step)
            with span("train.backward"):
                loss.backward()
            loss = loss.detach()
            n = torch.as_tensor(n, dtype=torch.float32, device=loss.device)
            loss_total = loss if loss_total is None else loss_total + loss
            n_total = n if n_total is None else n_total + n
            for k, v in mlogs.items():
                v = v.detach().float()
                logs[k] = logs[k] + v if k in logs else v

        with span("train.optimizer"):
            grads = {name: (p.grad if p.grad is not None
                            else torch.zeros_like(p)) for name, p in named}
            if grad_mask is not None:
                grad_mask(grads, state.step)
            g = [flat.grad] if flat is not None else list(grads.values())
            plan = state.plan
            n_norm = n_total
            if plan is not None:
                n_norm = plan.reduce(g, n_total)
                g = [local(t) for t in g]        # FSDP2: this rank's rows
                logs.update(loss_total=loss_total, sample_size=n_total)
                plan.reduce_logs(logs)
                loss_total, n_total = logs["loss_total"], logs["sample_size"]
            torch._foreach_div_(g, torch.clamp(n_norm, min=1.0))
            # the flat gradient's norm is summed over its per-parameter views,
            # in the tree's order: the flat update is the tree's, bit for bit
            parts = list(grads.values()) if flat is not None else g
            if plan is None:
                gnorm = torch.linalg.vector_norm(torch.stack(
                    torch._foreach_norm(parts)))
            else:
                gnorm = plan.grad_norm(parts)
            ok = not skip_nonfinite or math.isfinite(gnorm.item())
            if ok:
                params = state.opt_params()
                if plan is None:
                    optimizer.update(params, g, state.opt_state, gnorm)
                else:
                    optimizer.update(plan.blocks(params, state.shards),
                                     plan.blocks(g, state.shards),
                                     state.opt_state, gnorm, state.shards)
                    plan.after_update(params, state.shards)
            if flat is None:
                for _, p in named:
                    p.grad = None
            state.step += 1
            logs.update(loss_total=loss_total, sample_size=n_total,
                        grad_norm=gnorm)
            if skip_nonfinite:
                logs["skipped"] = torch.tensor(0.0 if ok else 1.0)
            return state, logs

    return train_step
