"""Differentiable collectives of the parallel paths.

- A sum over a group (``batch_mean``: the whole-batch statistics of
  pre-training under data parallelism) and a gather of every rank's rows
  (context parallelism's keys, values and encoder output).  Each backward
  is the other's adjoint: the sum's gradient is the sum of the ranks'
  gradients; the gather's gradient of a rank's rows is the sum over the
  ranks of the gradient of those rows.
- The megatron pair of tensor parallelism over the ``model`` group
  (``parallel/sharding.py``), for code that every model rank runs alike on
  the same input (so that a replicated result's gradient is the same on
  every rank and is not summed): ``copy_to_model`` (identity forward, sum
  of the ranks' input gradients backward) before a column-parallel
  projection, ``reduce_from_model`` (sum forward, identity backward) after
  a row-parallel one, and ``gather_from_model`` (every rank's columns
  forward, the rank's own columns of the gradient backward) where the
  whole width is needed.  A ``TensorSplit`` on a linear layer says how it
  is split; ``models/modules.dense`` reads it.
- ``ring_shift``: the pipeline's differentiable ``ppermute`` from stage s
  to stage s + 1 (``parallel/pipeline.py``), its backward the shift from
  s + 1 back to s.  Over gloo (which runs no point-to-point on CUDA
  tensors) it is an all-gather that keeps the previous stage's part; over
  NCCL a ``batch_isend_irecv`` pair.  Any other backend raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from wav2vec_s_tpu_torch.parallel.mesh import Shard


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        return _AllReduceSum.apply(dy, ctx.group), None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        dist.all_reduce(dy, group=ctx.group)
        return dy.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def all_gather_cat(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (all of
    the same shape), differentiable."""
    return _AllGatherCat.apply(x, dim, group)


def batch_mean(x: torch.Tensor, dim: Optional[int] = None,
               shard: Optional[Shard] = None) -> torch.Tensor:
    """``x.mean()`` (``dim=None``) or ``x.mean(dim=0)`` over the whole batch:
    where ``shard`` holds a process group, the sum is all-reduced over the
    group (differentiably) and divided by the whole batch's count; ``x`` is
    batch-major over the shard's rows."""
    if shard is None or shard.group is None:
        return x.mean() if dim is None else x.mean(dim=dim)
    if dim not in (None, 0):
        raise ValueError(f"batch_mean reduces over the rows (dim 0), not "
                         f"dim {dim}")
    total = all_reduce_sum(x.sum() if dim is None else x.sum(dim=0),
                           shard.group)
    count = (x.numel() if dim is None else x.shape[0]) * (
        shard.total // shard.rows)
    return total / count


# -- tensor parallelism -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorSplit:
    """How a linear layer's weight is split over the ``model`` group:
    ``kind`` "column" (torch's dim 0, the output features, bias with it)
    or "row" (dim 1, the input features; the bias stays whole and is added
    once, after the sum); this rank is ``rank`` of ``size``."""

    kind: str
    group: object
    rank: int
    size: int

    @property
    def dim(self) -> int:
        return 0 if self.kind == "column" else 1

    def site(self, x: torch.Tensor, axis: int):
        """The split-axis argument of a dropout site (``ops/dropout.py``)
        whose ``axis`` of ``x`` holds this rank's block of the whole."""
        axis %= x.dim()
        n = x.shape[axis]
        return (axis, self.rank * n, self.size * n)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(-1, ctx.rank * ctx.size, ctx.size), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward, the sum over ``group`` of the ranks'
    gradients (the input of a column-parallel projection)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` forward (a row-parallel projection's partial
    products); backward, the identity."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's last-axis block of ``x`` in rank order forward;
    backward, this rank's block of the gradient."""
    return _GatherFromModel.apply(x, group)


# -- the pipeline ring --------------------------------------------------


def shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank ``r`` of ``group`` gets rank ``r - step``'s ``x`` (mod size);
    not differentiable (``ring_shift`` is)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    backend = dist.get_backend(group)
    if backend == "gloo":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return parts[(r - step) % n]
    if backend == "nccl":
        out = torch.empty_like(x)
        ranks = dist.get_process_group_ranks(group)
        ops = [dist.P2POp(dist.isend, x, ranks[(r + step) % n], group),
               dist.P2POp(dist.irecv, out, ranks[(r - step) % n], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    raise ValueError(f"ring_shift runs over gloo or nccl, not {backend}")


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shift(x, group, 1)

    @staticmethod
    def backward(ctx, dy):
        return shift(dy, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Stage ``s`` of ``group`` gets stage ``s - 1``'s ``x`` (stage 0 the
    last stage's), differentiably: the gradient goes from ``s + 1`` back to
    ``s``.  Every rank's ``x`` has one shape and dtype."""
    return _RingShift.apply(x, group)
