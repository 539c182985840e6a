"""Optimizer with fairseq-equivalent semantics (port of
``wav2vec_s_tpu/train/optim.py``).

The JAX package chains optax transforms: ``clip_by_global_norm`` (when
``clip_norm > 0``), ``scale_by_adam`` (eps outside the square root),
``add_decayed_weights`` on EVERY parameter, then the learning-rate
schedule.  ``Adam.update`` reproduces that chain by hand, in place:

    g      <- g * min(1, clip / |g|)
    m      <- b1 m + (1 - b1) g ;   v <- b2 v + (1 - b2) g^2
    update <- (m / (1 - b1^n)) / (sqrt(v / (1 - b2^n)) + eps) + wd * p
    p      <- p - sched(n - 1) * update

with ``n`` the optimizer's own update count after the increment.  optax
evaluates the schedule at ITS count, which starts at 0, so the first update
uses ``sched(0)`` (0 under ``polynomial_decay`` warmup).  A step skipped for
a non-finite gradient never reaches ``update``: the count, the moments and
the parameters stay as they were (``train/step.py``).  Only adam is ported;
``optimizer="adafactor"`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch


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

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState, grad_norm: torch.Tensor) -> None:
        """One update of ``params`` and ``state`` in place; ``grads`` are
        the normalised gradients (consumed) and ``grad_norm`` their global
        norm."""
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


def build_optimizer(cfg: OptimConfig) -> Adam:
    if cfg.optimizer != "adam":
        raise NotImplementedError(f"optimizer {cfg.optimizer!r}: only adam "
                                  f"is ported")
    return Adam(cfg)
