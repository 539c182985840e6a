"""Differentiable collectives of the parallel paths: a sum over a group
(``batch_mean``: the whole-batch statistics of pre-training under data
parallelism) and a gather of every rank's rows (context parallelism's
keys, values and encoder output).  Each backward is the other's
adjoint: the sum's gradient is the sum of the ranks' gradients; the
gather's gradient of a rank's rows is the sum over the ranks of the
gradient of those rows."""

from __future__ import annotations

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
