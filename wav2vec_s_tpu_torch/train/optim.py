"""Optimizers with fairseq-equivalent semantics (port of
``wav2vec_s_tpu/train/optim.py``).

``optimizer="adam"``: the JAX package chains optax transforms:
``clip_by_global_norm`` (when ``clip_norm > 0``), ``scale_by_adam`` (eps
outside the square root), ``add_decayed_weights`` on EVERY parameter, then
the learning-rate schedule.  ``Adam.update`` reproduces that chain by hand,
in place:

    g      <- g * min(1, clip / |g|)
    m      <- b1 m + (1 - b1) g ;   v <- b2 v + (1 - b2) g^2
    update <- (m / (1 - b1^n)) / (sqrt(v / (1 - b2^n)) + eps) + wd * p
    p      <- p - sched(n - 1) * update

with ``n`` the optimizer's own update count after the increment.  optax
evaluates the schedule at ITS count, which starts at 0, so the first update
uses ``sched(0)`` (0 under ``polynomial_decay`` warmup).

``optimizer="adafactor"``: ``optax.adafactor(learning_rate=sched)`` with
optax's defaults (0.2.6), ``Adafactor.update``: factored second moments
for parameters with two dims of at least 128, decay ``1 - (n + 1) ** -0.8``,
each update clipped by its block RMS at 1, times the schedule, times the
parameter's RMS (at least 1e-3), eps 1e-30.  The JAX builder returns the
adafactor chain early, so ``clip_norm`` and ``weight_decay`` do not apply
to it; the port ignores them the same way.

A step skipped for a non-finite gradient never reaches ``update``: the
count, the moments and the parameters stay as they were
(``train/step.py``).

Sharded updates (ZeRO-1 and FSDP, ``parallel/sharding.py``): ``init`` and
``update`` take the row block of each parameter that this rank updates and
its ``RowShard`` (the whole parameter's leading dim and the data group),
or None for a whole parameter.  Adam is elementwise.  Adafactor decides
its factoring on the whole parameter's shape and all-reduces every mean
that runs over the parameter's leading dim or over the whole parameter
(the factored moment of the other dim, the RMS of the update and of the
parameter); ``sharded_moments`` says which of a parameter's moments are
row blocks (the checkpoint gathers them).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: per parameter: its RowShard (parallel/sharding.py) or None
Shards = Optional[Sequence[Optional[object]]]


def _full_shape(p: torch.Tensor, shard) -> Tuple[int, ...]:
    return tuple(p.shape) if shard is None else (shard.rows,) + tuple(
        p.shape[1:])


def _mean(x: torch.Tensor, dim: Optional[int], shard,
          over_rows: bool) -> torch.Tensor:
    """``x.mean()`` (``dim`` None) or ``x.mean(dim=dim)``; when the mean
    runs over the parameter's sharded leading dim (``over_rows``), the sum
    is all-reduced over the shard's group and divided by the whole
    count."""
    if shard is None or not over_rows:
        return x.mean() if dim is None else x.mean(dim=dim)
    import torch.distributed as dist

    total = x.sum() if dim is None else x.sum(dim=dim)
    dist.all_reduce(total, group=shard.group)
    count = shard.rows * (int(np.prod(x.shape[1:])) if dim is None else 1)
    return total / count


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"
    lr: float = 5e-4
    adam_betas: tuple = (0.9, 0.98)
    adam_eps: float = 1e-6
    weight_decay: float = 0.01
    clip_norm: float = 0.0           # 0 disables (pretrain); fine-tune uses 2.0
    # schedule
    lr_scheduler: str = "polynomial_decay"
    warmup_updates: int = 5000
    total_updates: int = 400000
    warmup_init_lr: float = 1e-7
    # tri_stage: fractions of total_updates spent in warmup / hold / decay
    phase_ratio: tuple = (0.1, 0.3, 0.6)
    init_lr_scale: float = 0.01
    final_lr_scale: float = 0.05


def build_schedule(cfg: OptimConfig) -> Callable[[float], float]:
    from wav2vec_s_tpu_torch.train.lr_schedules import SCHEDULES
    if cfg.lr_scheduler == "polynomial_decay":
        return SCHEDULES["polynomial_decay"](
            cfg.lr, cfg.warmup_updates, cfg.total_updates)
    if cfg.lr_scheduler == "inverse_sqrt":
        return SCHEDULES["inverse_sqrt"](
            cfg.lr, cfg.warmup_updates, cfg.warmup_init_lr)
    if cfg.lr_scheduler == "cosine":
        return SCHEDULES["cosine"](cfg.lr, cfg.warmup_updates,
                                   cfg.total_updates)
    if cfg.lr_scheduler == "tri_stage":
        w, h, d = (int(r * cfg.total_updates) for r in cfg.phase_ratio)
        return SCHEDULES["tri_stage"](
            cfg.lr, w, h, d, init_lr_scale=cfg.init_lr_scale,
            final_lr_scale=cfg.final_lr_scale)
    raise ValueError(cfg.lr_scheduler)


@dataclasses.dataclass
class AdamState:
    count: int                       # updates applied (skips excluded)
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class Adam:
    """The clip / adam / decoupled decay / schedule chain of the JAX
    ``build_optimizer``, over a list of parameters (float32 master
    weights)."""

    def __init__(self, cfg: OptimConfig):
        self.cfg = cfg
        self.schedule = build_schedule(cfg)

    def init(self, params: List[torch.Tensor],
             shards: Shards = None) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @staticmethod
    def sharded_moments(full_shape) -> Dict[str, bool]:
        return {"mu": True, "nu": True}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState, grad_norm: torch.Tensor,
               shards: Shards = None) -> None:
        """One update of ``params`` and ``state`` in place; ``grads`` are
        the normalised gradients (consumed) and ``grad_norm`` their global
        norm.  Elementwise: a row block updates as its whole parameter
        would."""
        c = self.cfg
        b1, b2 = c.adam_betas
        if c.clip_norm and c.clip_norm > 0:
            scale = torch.where(grad_norm < c.clip_norm, 1.0,
                                c.clip_norm / grad_norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(state.count)
        state.count += 1
        n = state.count
        torch._foreach_lerp_(state.mu, grads, 1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** n)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, c.adam_eps)
        upd = torch._foreach_div(state.mu, 1.0 - b1 ** n)
        torch._foreach_div_(upd, denom)
        if c.weight_decay:
            torch._foreach_add_(upd, params, alpha=c.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)


@dataclasses.dataclass
class AdafactorState:
    count: int                       # updates applied (skips excluded)
    v_row: List[torch.Tensor]        # factored: row means; else [1] zeros
    v_col: List[torch.Tensor]        # factored: column means; else [1]
    v: List[torch.Tensor]            # unfactored: the full moment; else [1]


def factored_dims(shape, min_dim_size_to_factor: int = 128
                  ) -> Optional[Tuple[int, int]]:
    """(second largest, largest) axis of ``shape`` when the second largest
    is at least ``min_dim_size_to_factor``, else None (optax
    ``_factored_dims``: ``np.argsort`` of the shape, ties in its order)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """``optax.adafactor(learning_rate=sched)`` with its defaults, over a
    list of parameters, in place.  The factored moments are symmetric in
    rows and columns, so a torch ``[out, in]`` weight and the JAX
    ``[in, out]`` kernel take the same update."""

    decay_rate = 0.8
    min_dim_size_to_factor = 128
    clipping_threshold = 1.0
    min_param_scale = 1e-3
    eps = 1e-30

    def __init__(self, cfg: OptimConfig):
        self.cfg = cfg
        self.schedule = build_schedule(cfg)

    def sharded_moments(self, full_shape) -> Dict[str, bool]:
        """Which moments of a row-sharded parameter are row blocks: the
        whole moment v, or the factored moment that keeps the leading
        dim."""
        dims = factored_dims(tuple(full_shape), self.min_dim_size_to_factor)
        if dims is None:
            return {"v_row": False, "v_col": False, "v": True}
        d1, d0 = dims
        return {"v_row": d0 != 0, "v_col": d1 != 0, "v": False}

    def init(self, params: List[torch.Tensor],
             shards: Shards = None) -> AdafactorState:
        state = AdafactorState(0, [], [], [])
        for i, p in enumerate(params):
            sh = None if shards is None else shards[i]
            dims = factored_dims(_full_shape(p, sh),
                                 self.min_dim_size_to_factor)
            one = p.new_zeros((1,))
            if dims is None:
                state.v_row.append(one)
                state.v_col.append(one.clone())
                state.v.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                shape = list(p.shape)
                state.v_row.append(p.new_zeros(shape[:d0] + shape[d0 + 1:]))
                state.v_col.append(p.new_zeros(shape[:d1] + shape[d1 + 1:]))
                state.v.append(one.clone())
        return state

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdafactorState, grad_norm: torch.Tensor,
               shards: Shards = None) -> None:
        """One update of ``params`` and ``state`` in place; ``grad_norm``
        is not read (adafactor clips per block)."""
        del grad_norm
        f32 = np.float32
        decay = float(f32(1.0) - f32(state.count + 1) ** f32(-self.decay_rate))
        lr = self.schedule(state.count)
        state.count += 1
        for i, (p, g) in enumerate(zip(params, grads)):
            sh = None if shards is None else shards[i]
            sq = g * g + self.eps
            dims = factored_dims(_full_shape(p, sh),
                                 self.min_dim_size_to_factor)
            if dims is None:
                v = state.v[i].mul_(decay).add_(sq, alpha=1.0 - decay)
                u = g * v.rsqrt()
            else:
                d1, d0 = dims
                vr = state.v_row[i].mul_(decay).add_(
                    _mean(sq, d0, sh, d0 == 0), alpha=1.0 - decay)
                vc = state.v_col[i].mul_(decay).add_(
                    _mean(sq, d1, sh, d1 == 0), alpha=1.0 - decay)
                r1 = d1 - 1 if d1 > d0 else d1
                # vr keeps the leading dim when d0 != 0, at its dim 0
                row = (vr / _mean(vr, r1, sh, d0 != 0 and r1 == 0)
                       .unsqueeze(r1)).rsqrt()
                u = g * row.unsqueeze(d0) * vc.rsqrt().unsqueeze(d1)
            rms = _mean(u.square(), None, sh, True).sqrt()
            u = u / torch.clamp(rms / self.clipping_threshold, min=1.0)
            p_rms = _mean(p.square(), None, sh, True).sqrt()
            scale = torch.where(p_rms <= self.min_param_scale,
                                self.min_param_scale, p_rms)
            p.sub_(u * lr * scale)


def build_optimizer(cfg: OptimConfig):
    if cfg.optimizer == "adam":
        return Adam(cfg)
    if cfg.optimizer == "adafactor":
        return Adafactor(cfg)
    raise ValueError(cfg.optimizer)
