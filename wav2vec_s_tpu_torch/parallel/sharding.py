"""The train step's parallel plan: data parallelism, ZeRO-1 and FSDP over
the ``data`` dim of the mesh, tensor parallelism over its ``model`` dim
(port of ``wav2vec_s_tpu/parallel/sharding.py`` ``param_shardings`` /
``shard_params`` / ``fsdp_shardings`` / ``zero_shardings`` and of the SPMD
gradient reduction the JAX step gets from XLA).

- **Tensor parallelism** (``n_model > 1``): the megatron rule of the JAX
  package on the fairseq names (``tp_kind``): ``q_proj``, ``k_proj``,
  ``v_proj``, ``fc1`` and ``weight_proj`` are column-parallel (torch's
  weight split along dim 0, the bias with it), ``out_proj`` and ``fc2``
  row-parallel (dim 1; the bias stays whole and is added once, after the
  sum); a weight whose split dim does not divide by the model width, or
  an attention whose heads do not, stays whole.  ``shard_params`` keeps
  each rank's block in place, as a plain parameter, and marks the layer
  with a ``functional.TensorSplit`` that ``models/modules.dense`` runs.
  Everything else is replicated, and as every model rank runs it alike
  on the same input, its gradient is the same on every model rank: the
  gradients and the sample count are summed over the data (and seq)
  ranks only, never over the model group, and the norm counts a
  replicated gradient once and sums the squares of the split ones over
  the model group.  (The JAX rule's patterns expect ``q_proj][`` where
  ``jax.tree_util.keystr`` writes ``q_proj'][``, so the JAX package
  replicates every parameter; its TP update is the replicated one, which
  is what the split here computes too.)

- **Data parallelism** (every mode): each rank runs the loss on its rows
  of the global batch; the *summed* gradients and the sample count are
  all-reduced (one flat buffer per bucket of ``BUCKET_BYTES``), and the
  step divides by the global count: the fairseq contract
  (trainer.py:749-799), not DDP's mean of per-rank means, which is wrong
  when ranks hold different token counts.  The reduction runs over the
  data and seq ranks (the world, without TP): under context parallelism
  the seq ranks hold parts of the encoder's gradient (and each counts the
  batch once, so gradient and count are both ``n_seq`` times their true
  sums, and their quotient is exact).  Logs are summed over the ``data``
  group only.
- **ZeRO-1** (``mode="zero"``): parameters and gradients stay whole on
  every rank; each rank owns the dim-0 block ``[r k, (r + 1) k)`` of every
  parameter whose leading dim divides by the data width (JAX
  ``zero_shardings``: the moments' leading dim where it divides, else
  replicated), keeps the optimizer moments of that block only, updates
  that block, and all-gathers the updated blocks.
- **FSDP** (``mode="fsdp"``): FSDP2 ``fully_shard`` over the ``data`` dim,
  one unit per encoder, decoder (LM) and jointer layer plus the root
  module (JAX ``fsdp_shardings``; FSDP2 gathers a unit's parameters at its
  forward and reduce-scatters the mean of its gradients, which the plan
  scales back to their sum).  Every
  parameter is sharded, small ones too: the JAX rule keeps leaves under
  4096 elements replicated to save collective latency, which changes no
  number, and FSDP2 has no such option.  Each rank updates the dim-0 rows
  that FSDP2 gives it (``torch.chunk`` of the leading dim).  Under context
  parallelism FSDP2 shards over the data dim alone, and the local
  gradients it leaves (the mean over data, scaled back) are then summed
  over the seq group, as the data-parallel mode sums them over the world.
- Under TP both sharded modes shard the rank's TP blocks over the data
  dim (JAX ``fsdp_shardings``: the TP dim keeps ``model``, FSDP takes
  another; which dim changes no number).

Both sharded modes hand the optimizers row blocks (``RowShard``):
``train/optim.py`` all-reduces what it reduces over dim 0 or over a whole
parameter (Adafactor's factored moments and RMS clipping).  The gradient
norm for clipping is the global norm, read once by the step.  A
checkpoint gathers parameters and moments into the single-process layout
(``full_state``: the data rows, then the TP blocks) and restores into any
layout (``load_full_state``).

Not composed (nothing in the JAX package reaches them): tensor with
context parallelism, the plan over a ``pipe`` dim (the pipeline is the
combinator of ``parallel/pipeline.py``), and Adafactor under tensor
parallelism (its factored moments of a split weight would need sums over
the model group); each raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from wav2vec_s_tpu_torch.parallel.functional import TensorSplit
from wav2vec_s_tpu_torch.parallel.mesh import AXES, Shard, dim_size

MODES = ("dp", "zero", "fsdp")
#: the megatron rule (JAX ``COL_PARALLEL`` / ``ROW_PARALLEL``) on the
#: linear layers' names
COL_PARALLEL = ("q_proj", "k_proj", "v_proj", "fc1", "weight_proj")
ROW_PARALLEL = ("out_proj", "fc2")
BUCKET_BYTES = 64 << 20          # gradient all-reduce bucket
#: logs that are not per-batch sums: left as they are (the perplexities
#: and the temperature are whole-batch values already,
#: ``functional.batch_mean``)
NOT_SUMMED = ("prob_perplexity", "code_perplexity", "temp")


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A parameter's rows ``[start, start + local rows)`` of ``rows``,
    held by this rank of ``group``."""

    start: int
    rows: int
    group: object


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """The local tensor of an FSDP2 (DTensor) parameter or gradient, else
    ``t`` itself."""
    return t.to_local() if _is_dtensor(t) else t


def all_reduce_sum(tensors: List[torch.Tensor], group=None) -> None:
    """In-place sum over ``group`` of each tensor, through flat buffers of
    at most ``BUCKET_BYTES`` (one collective per bucket and dtype)."""
    from torch._utils import (
        _flatten_dense_tensors, _unflatten_dense_tensors)

    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    buckets = []
    for same in by_dtype.values():
        cur, size = [], 0
        for t in same:
            n = t.numel() * t.element_size()
            if cur and size + n > BUCKET_BYTES:
                buckets.append(cur)
                cur, size = [], 0
            cur.append(t)
            size += n
        if cur:
            buckets.append(cur)
    for bucket in buckets:
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=group)
        for dst, src in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            dst.copy_(src)


def gather_rows(t: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The whole tensor of a row shard: the blocks of every rank of the
    group, in rank order, each padded to the largest for the collective
    and cut back."""
    n = dist.get_world_size(shard.group)
    chunk = -(-shard.rows // n)
    padded = t.new_zeros((chunk,) + tuple(t.shape[1:]))
    padded[:t.shape[0]] = t
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded.contiguous(), group=shard.group)
    sizes = [max(0, min(chunk, shard.rows - r * chunk)) for r in range(n)]
    return torch.cat([p[:s] for p, s in zip(parts, sizes)], dim=0)


def tp_kind(name: str, module: nn.Module, parent: Optional[nn.Module],
            n_model: int) -> Optional[str]:
    """"column", "row" or None (replicated) for the linear layer ``module``
    named ``name`` (its parent module ``parent``) over ``n_model`` ranks."""
    from wav2vec_s_tpu_torch.models.modules import MultiheadAttention

    if n_model <= 1 or not isinstance(module, nn.Linear):
        return None
    leaf = name.rsplit(".", 1)[-1]
    if (isinstance(parent, MultiheadAttention)
            and parent.num_heads % n_model):
        return None
    w = module.weight
    if leaf in COL_PARALLEL and w.shape[0] % n_model == 0:
        return "column"
    if leaf in ROW_PARALLEL and w.shape[1] % n_model == 0:
        return "row"
    return None


def shard_params(model: nn.Module, plan: "ParallelPlan") -> Dict[str, int]:
    """Keep this model rank's block of every tensor-parallel weight (and
    of a column-parallel bias) in place as a plain parameter, and mark its
    layer with a ``TensorSplit``.  Returns {state dict key: split dim}.
    Only the models whose attention reads its local width take it: the
    wav2vec-S encoder with CAAT, and pre-training."""
    from wav2vec_s_tpu_torch.models import Wav2Vec2Model
    from wav2vec_s_tpu_torch.models.caat import W2V2CaatModel

    n = plan.n_model
    if n <= 1:
        return {}
    if type(model) not in (W2V2CaatModel, Wav2Vec2Model):
        raise ValueError(f"tensor parallelism runs the CAAT and the "
                         f"pre-training models, not {type(model).__name__}")
    mods = dict(model.named_modules())
    dims: Dict[str, int] = {}
    for name, m in mods.items():
        parent = mods.get(name.rsplit(".", 1)[0]) if "." in name else model
        kind = tp_kind(name, m, parent, n)
        if kind is None:
            continue
        split = TensorSplit(kind, plan.model_group, plan.model_rank, n)
        with torch.no_grad():
            m.weight = nn.Parameter(
                m.weight.chunk(n, split.dim)[split.rank].clone())
            dims[f"{name}.weight"] = split.dim
            if kind == "column" and m.bias is not None:
                m.bias = nn.Parameter(m.bias.chunk(n)[split.rank].clone())
                dims[f"{name}.bias"] = 0
        m.tp = split
    return dims


def fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The FSDP units below the root: every encoder, LM and jointer
    layer."""
    from wav2vec_s_tpu_torch.models.caat.jointer import (
        TransformerJointerLayer)
    from wav2vec_s_tpu_torch.models.modules import TransformerEncoderLayer

    return [m for m in model.modules()
            if isinstance(m, (TransformerEncoderLayer,
                              TransformerJointerLayer))]


class ParallelPlan:
    """The layout of a parallel run for the train step.

    ``mesh``: the (data, model, pipe, seq) mesh of
    ``parallel.mesh.make_mesh`` (``pipe`` of size 1); ``mode``: ``"dp"``,
    ``"zero"`` or ``"fsdp"`` (module docstring)."""

    def __init__(self, mesh, mode: str = "dp"):
        if mode not in MODES:
            raise ValueError(f"parallel mode {mode!r} is not one of {MODES}")
        self.mesh = mesh
        self.mode = mode
        self.n_data = dim_size(mesh, AXES.data)
        self.n_model = dim_size(mesh, AXES.model)
        self.n_seq = dim_size(mesh, AXES.seq)
        if dim_size(mesh, AXES.pipe) > 1:
            raise ValueError("the train step's plan runs no pipe dim: the "
                             "pipeline is parallel/pipeline.py's "
                             "pipeline_apply")
        if self.n_model > 1 and self.n_seq > 1:
            raise ValueError("tensor parallelism does not compose with "
                             "context parallelism (n_model > 1 with "
                             "n_seq > 1)")
        self.data_group = mesh.get_group(AXES.data)
        self.seq_group = mesh.get_group(AXES.seq) if self.n_seq > 1 else None
        self.model_group = (mesh.get_group(AXES.model) if self.n_model > 1
                            else None)
        self.data_rank = mesh.get_local_rank(AXES.data)
        self.model_rank = mesh.get_local_rank(AXES.model)
        #: the ranks of one model coordinate, which sum gradients and
        #: counts (None: the world); TP runs no seq dim, so under TP they
        #: are the data group
        self.replica_group = self.data_group if self.n_model > 1 else None
        self.writer = dist.get_rank() == 0
        #: {state dict key: split dim} of the TP blocks, and per parameter
        #: (in ``model.parameters()`` order) its split dim or None
        self.tp_keys: Dict[str, int] = {}
        self.tp_dims: List[Optional[int]] = []

    # -- the batch ------------------------------------------------------
    def shard(self, rows: int) -> Shard:
        """This rank's rows of a global batch, ``rows`` per data rank."""
        return Shard(self.data_rank * rows, (self.data_rank + 1) * rows,
                     rows * self.n_data, self.data_group)

    # -- the model ------------------------------------------------------
    def prepare(self, model: nn.Module) -> nn.Module:
        """TP: keep each rank's blocks (``shard_params``).  FSDP: shard the
        model in place (one FSDP2 unit per layer, then the root, whose
        parameters stay gathered from its forward to the end of the
        backward, as the loss reads the shared embedding after the
        forward); gradients are summed over the data group."""
        self.tp_keys = shard_params(model, self)
        self.tp_dims = [self.tp_keys.get(k) for k, _ in
                        model.named_parameters()]
        if self.mode != "fsdp":
            return model
        from torch.distributed.fsdp import fully_shard

        dm = self.mesh[AXES.data]
        for unit in fsdp_units(model):
            fully_shard(unit, mesh=dm)
        fully_shard(model, mesh=dm, reshard_after_forward=False)
        return model

    def row_shards(self, params: List[torch.Tensor]
                   ) -> List[Optional[RowShard]]:
        """The row block of each parameter that this rank updates (None:
        the whole parameter, on every rank)."""
        out: List[Optional[RowShard]] = []
        n = self.n_data
        for p in params:
            if self.mode == "fsdp":
                rows = p.shape[0]
                chunk = -(-rows // n)
                start = min(rows, self.data_rank * chunk)
                want = max(0, min(chunk, rows - start))
                if local(p).shape[0] != want:
                    raise RuntimeError(
                        f"FSDP2 holds {local(p).shape[0]} rows of a "
                        f"{tuple(p.shape)} parameter on data rank "
                        f"{self.data_rank}, not the {want} of torch.chunk")
                out.append(RowShard(start, rows, self.data_group))
            elif (self.mode == "zero" and n > 1 and p.dim() >= 1
                  and p.shape[0] % n == 0):
                k = p.shape[0] // n
                out.append(RowShard(self.data_rank * k, p.shape[0],
                                    self.data_group))
            else:
                out.append(None)
        return out

    def blocks(self, tensors: List[torch.Tensor],
               shards: List[Optional[RowShard]]) -> List[torch.Tensor]:
        """The views of ``tensors`` (parameters or gradients) that this
        rank updates: FSDP2's local rows, ZeRO's row block, else the
        whole tensor."""
        out = []
        for t, sh in zip(tensors, shards):
            t = local(t.detach() if isinstance(t, nn.Parameter) else t)
            if sh is not None and self.mode == "zero":
                n_local = sh.rows // self.n_data
                t = t[sh.start:sh.start + n_local]
            out.append(t)
        return out

    # -- the step -------------------------------------------------------
    def reduce(self, grads: List[torch.Tensor],
               count: torch.Tensor) -> torch.Tensor:
        """Sum the gradients (in place) and the sample count over the data
        and seq ranks (never the model group); FSDP2 has reduce-scattered
        the gradients over the data group already, as their mean (gloo has
        no scaled sum to make it a sum), so they are scaled back by the
        data width and summed over the seq group.  Returns the summed
        count."""
        count = count.clone()
        dist.all_reduce(count, group=self.replica_group)
        if self.mode != "fsdp":
            all_reduce_sum(grads, self.replica_group)
            return count
        shards = [local(g) for g in grads]
        if self.n_data > 1:
            torch._foreach_mul_(shards, float(self.n_data))
        if self.seq_group is not None:
            all_reduce_sum(shards, self.seq_group)
        return count

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of the (reduced) gradients: the whole
        gradients under data parallelism and ZeRO, the root of the
        all-reduced sum of the shards' squares under FSDP; under TP the
        squares of the split gradients are summed over the model group,
        a replicated gradient counted once."""
        if self.mode != "fsdp" and self.n_model == 1:
            return torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
        squares = [local(g).float().square().sum() for g in grads]
        if self.n_model > 1:
            whole, split = squares[0].new_zeros(()), squares[0].new_zeros(())
            for q, d in zip(squares, self.tp_dims):
                if d is None:
                    whole = whole + q
                else:
                    split = split + q
            dist.all_reduce(split, group=self.model_group)
            total = whole + split
        else:
            total = torch.stack(squares).sum()
        if self.mode == "fsdp":
            dist.all_reduce(total, group=self.data_group)
        return total.sqrt()

    def after_update(self, params: List[torch.Tensor],
                     shards: List[Optional[RowShard]]) -> None:
        """ZeRO: every rank's updated row blocks to every rank."""
        if self.mode != "zero":
            return
        with torch.no_grad():
            for p, sh in zip(params, shards):
                if sh is None:
                    continue
                n = self.n_data
                parts = list(p.detach().chunk(n, dim=0))
                mine = parts[self.data_rank].clone()
                dist.all_gather(parts, mine, group=self.data_group)

    def reduce_logs(self, logs: Dict[str, torch.Tensor]) -> None:
        """Sum the per-batch logs over the data group (in place)."""
        keys = [k for k in logs if k not in NOT_SUMMED]
        if not keys:
            return
        flat = torch.stack([logs[k].float().reshape(()) for k in keys])
        dist.all_reduce(flat, group=self.data_group)
        for k, v in zip(keys, flat.unbind()):
            logs[k] = v

    # -- checkpoints ----------------------------------------------------
    def _gather_model(self, t: torch.Tensor, dim: Optional[int]):
        """The whole tensor of a TP block split along ``dim`` (None: ``t``
        itself)."""
        if dim is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.n_model)]
        dist.all_gather(parts, t.contiguous(), group=self.model_group)
        return torch.cat(parts, dim=dim)

    def _model_block(self, t: torch.Tensor, dim: Optional[int]):
        """This model rank's block of a whole tensor split along ``dim``."""
        if dim is None:
            return t
        return t.chunk(self.n_model, dim)[self.model_rank]

    def full_state(self, model: nn.Module, moments: Dict[str, list],
                   sharded: Dict[str, List[bool]],
                   shards: List[Optional[RowShard]]):
        """(model state dict, moments) in the single-process layout on
        every rank: FSDP parameters gathered, each sharded moment's row
        blocks gathered, then the TP blocks of both (a collective: every
        rank calls it)."""
        state = {}
        for k, v in model.state_dict().items():
            if _is_dtensor(v):
                # the process group's all_gather: DTensor.full_tensor's
                # functional collective crashes over gloo on CUDA tensors
                v = gather_rows(v.to_local(), RowShard(0, v.shape[0],
                                                       self.data_group))
            state[k] = self._gather_model(v, self.tp_keys.get(k))
        full = {}
        for name, tensors in moments.items():
            full[name] = [self._gather_model(
                gather_rows(t, sh) if (sh is not None and is_sh) else t,
                d) for t, sh, is_sh, d in
                zip(tensors, shards, sharded[name], self.tp_dims)]
        return state, full

    def load_full_state(self, model: nn.Module,
                        state: Dict[str, torch.Tensor]) -> None:
        """Copy a single-process model state dict into the model: TP
        layers take their blocks, FSDP parameters their rows."""
        state = {k: self._model_block(v, self.tp_keys.get(k))
                 for k, v in state.items()}
        if self.mode != "fsdp":
            model.load_state_dict(state, strict=True)
            return
        own = model.state_dict()
        missing = set(own) ^ set(state)
        if missing:
            raise ValueError(f"state dict keys differ: {sorted(missing)}")
        with torch.no_grad():
            for k, dst in own.items():
                src = state[k]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{k}: {tuple(src.shape)} for "
                                     f"{tuple(dst.shape)}")
                if _is_dtensor(dst):
                    loc = dst.to_local()
                    chunk = -(-dst.shape[0] // self.n_data)
                    start = min(dst.shape[0], self.data_rank * chunk)
                    loc.copy_(src[start:start + loc.shape[0]])
                else:
                    dst.copy_(src)

    def moment_block(self, full: torch.Tensor,
                     shard: Optional[RowShard],
                     sharded: bool, like: torch.Tensor,
                     index: int) -> torch.Tensor:
        """This rank's block of a single-process moment of the
        ``index``-th parameter: its TP block, then its rows."""
        full = self._model_block(full, self.tp_dims[index])
        if shard is None or not sharded:
            return full
        return full[shard.start:shard.start + like.shape[0]]
