"""Rematerialization of the train step's loss forward (port of the JAX
``REMAT_POLICIES`` and ``jax.checkpoint`` over the whole loss,
``wav2vec_s_tpu/train/step.py``).

The policies keep the JAX names and meaning:

- ``nothing``: the whole loss forward under non-reentrant
  ``torch.utils.checkpoint``, which saves its inputs only; the backward
  runs the forward again (``nothing_saveable``);
- ``dots``: selective checkpointing that saves the outputs of the matrix
  products with no batch dimension (``aten.mm`` / ``aten.addmm``: the
  dense projections, a ``[B, T, D]`` input folded to two dims) and
  recomputes everything else: attention's batched products, the kernels'
  outputs, norms, activations (``dots_with_no_batch_dims_saveable``);
- ``offload_dots``: ``dots`` with the saved products parked in pinned host
  memory between the forward and the backward
  (``offload_dot_with_no_batch_dims("device", "pinned_host")``).  A CUDA
  product that cannot be pinned raises; a CPU product (the twins' path)
  is kept as a plain copy.

``dots`` is the library's selective checkpointing
(``create_selective_checkpoint_contexts`` over the two products): it
caches those outputs, checks that nothing wrote into them in place, and
recomputes every other operation.  Nothing else is ever cached: the CUDA
kernels, bound with ``ctypes``, write into buffers that ``torch.empty``
allocated outside the dispatcher, so a cached allocation would have the
recompute overwrite the forward's saved tensor.  ``offload_dots`` needs a
pair of dispatch modes of its own: the library's modes keep the cached
tensors on their device (eager selective checkpointing has no
``CPU_OFFLOAD``), so the forward's mode here keeps a host copy of each
product in call order and the recompute's mode hands them back to the
device in the same order.

The recompute sees the same draws as the forward (``ops.dropout.replayed``
over the update's generator): the checkpoint restores only the global
RNGs, and a recompute that took new dropout offsets, layerdrop decisions,
negatives or Gumbel noise would give every gradient silently wrong.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (
    checkpoint, create_selective_checkpoint_contexts, noop_context_fn)

from wav2vec_s_tpu_torch.ops.dropout import replayed

REMAT_POLICIES = ("none", "dots", "nothing", "offload_dots")

#: the matrix products with no batch dimension
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _park(t: torch.Tensor) -> torch.Tensor:
    """A product's copy in host memory: pinned for a device tensor (which
    raises where it cannot be pinned), a plain copy for a CPU one."""
    if t.device.type == "cpu":
        return t.detach().clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


class _OffloadDots(TorchDispatchMode):
    """The forward: each product's host copy, in call order."""

    def __init__(self, store: List):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _DOTS:
            self.store.append((_park(out), out.device))
        return out


class _ReloadDots(TorchDispatchMode):
    """The recompute: the forward's products in call order, back on their
    device; every other operation runs."""

    def __init__(self, store: List):
        super().__init__()
        self.store = store
        self.next = 0

    def __enter__(self):
        self.next = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _DOTS:
            return func(*args, **(kwargs or {}))
        if self.next >= len(self.store):
            raise RuntimeError("the recompute ran more matrix products than "
                               "the forward: its control flow differs")
        host, device = self.store[self.next]
        self.next += 1
        return host.to(device, non_blocking=True)


def _offload_contexts():
    store: List = []
    return _OffloadDots(store), _ReloadDots(store)


def remat(loss_fn: Callable, policy: str) -> Callable:
    """``loss_fn(batch, generator, step)`` with its forward rematerialized
    under ``policy`` (one of ``REMAT_POLICIES``; ``"none"`` returns it as
    it is)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"run.remat={policy!r} is not one of "
                         f"{REMAT_POLICIES}")
    if policy == "none":
        return loss_fn
    context_fn = {"nothing": noop_context_fn,
                  "dots": partial(create_selective_checkpoint_contexts,
                                  list(_DOTS)),
                  "offload_dots": _offload_contexts}[policy]

    def run(batch, generator: torch.Generator, step: int):
        return checkpoint(replayed(loss_fn, generator), batch, generator,
                          step, use_reentrant=False, context_fn=context_fn)

    return run
