"""Context parallelism: the blockwise encoder's time axis split over the
mesh's ``seq`` group (port of the ``seq_axis`` path of
``wav2vec_s_tpu/models/wav2vec2.py:253-271``, where a GSPMD constraint
shards the time axis and XLA places the collectives).

After ``append_right_context`` the encoder's ``L = layout.total_len`` rows
are cut into ``n_seq`` contiguous blocks of ``ceil(L / n_seq)`` rows (the
last padded; its pad rows are cut off at the end).  Every layer computes
q, k and v on its own rows, all-gathers k and v over the group with a
differentiable gather (its backward sums each rank's key and value
gradients back to their owner), and attends its queries under their rows
of the block bias; the stack's output is gathered before
``strip_right_context``.  As in the JAX package the split always runs the
dense attention (``block_attn_bias``), never the flash kernels.  Dropout
draws each row's mask at its place in the whole sequence (the index map of
``ops/dropout.py``), so a split step drops what one process drops.

Everything before and after the stack runs on every rank of the group on
the whole sequence (the conv front-end, the decoder, the jointer, the
losses): a loss is computed ``n_seq`` times, and the gradient the gather
sends back to each block is the ``n_seq``-fold sum of identical parts, so
every gradient of a rank, summed over the world, is ``n_seq`` times its
true sum, as is the sample count summed over the world
(``parallel/sharding.py`` divides one by the other).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This rank's block ``[start, start + per)`` of a sequence of
    ``total`` rows split over ``size`` ranks of ``group``."""

    group: object
    rank: int
    size: int
    total: int

    @classmethod
    def of(cls, group, total: int) -> "SeqShard":
        return cls(group, dist.get_rank(group), dist.get_world_size(group),
                   total)

    @property
    def per(self) -> int:
        return -(-self.total // self.size)

    @property
    def start(self) -> int:
        return self.rank * self.per

    def split(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's rows of ``x`` along ``dim`` (zero rows past the
        end)."""
        pad = self.per * self.size - x.shape[dim]
        if pad:
            shape = list(x.shape)
            shape[dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim=dim)
        return x.narrow(dim, self.start, self.per)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence from every rank's rows (differentiable), cut
        to ``total`` rows."""
        from wav2vec_s_tpu_torch.parallel.functional import all_gather_cat

        return all_gather_cat(x, dim, self.group).narrow(dim, 0, self.total)

    def site(self, axis: int):
        """The ``seq`` argument of a dropout site whose ``axis`` holds this
        rank's rows."""
        return (axis, self.start, self.total)


def enable(model: torch.nn.Module, group) -> torch.nn.Module:
    """Split every blockwise encoder of ``model`` over ``group`` (its
    config must name a ``seq_axis``)."""
    from wav2vec_s_tpu_torch.models.wav2vec2 import (
        BlockwiseTransformerEncoder)

    found = False
    for m in model.modules():
        if isinstance(m, BlockwiseTransformerEncoder):
            if m.cfg.seq_axis is None:
                raise ValueError("context parallelism needs the encoder's "
                                 "seq_axis set (model.seq_axis=seq)")
            m.seq_group = group
            found = True
    if not found:
        raise ValueError("the model has no blockwise encoder to split")
    return model
