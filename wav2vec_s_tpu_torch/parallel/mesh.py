"""Process group and device mesh of a parallel run (port of
``wav2vec_s_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` and lets
XLA place the collectives; here one process drives one device, and the
ranks are laid out as a ``torch.distributed.device_mesh.DeviceMesh`` with
the JAX mesh's named dims in its order: ``data`` (the batch), ``model``
(tensor parallelism, ``parallel/sharding.py``), ``pipe`` (the pipeline
stages, ``parallel/pipeline.py``) and ``seq`` (the encoder's time axis,
context parallelism), row-major: rank ``r`` of a (data, model, pipe, seq)
mesh sits at the coordinates of ``r`` in ``arange(world).reshape(n_data,
n_model, n_pipe, n_seq)``.  Every dim is present, of size 1 where unused
(the JAX mesh leaves ``pipe`` and ``seq`` out then; the rank order is the
same).

A run is launched by ``python -m torch.distributed.run --nproc-per-node N
...``, which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT``; ``init_from_env`` reads them.  The backend is always
explicit: ``nccl`` for CUDA devices, ``gloo`` for the CPU (tests, and
ranks that share one card, pass ``gloo`` for CUDA too).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str = "model"
    pipe: str = "pipe"
    seq: str = "seq"


AXES = MeshAxes()


@dataclasses.dataclass(frozen=True)
class Shard:
    """The rows ``[start, stop)`` of a batch of ``total`` rows that this
    rank holds (its data coordinate), and the process group over which the
    batch's statistics are summed (None: one process).  The dropout context
    reads the rows (``ops/dropout.py``), ``functional.batch_mean`` the
    group."""

    start: int
    stop: int
    total: int
    group: object = None

    @property
    def rows(self) -> int:
        return self.stop - self.start


def default_backend(device_type: str) -> str:
    """``nccl`` on CUDA devices, ``gloo`` on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def launched() -> bool:
    """True when the environment of ``torch.distributed.run`` is set."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_from_env(device_type: str = "cuda",
                  backend: Optional[str] = None) -> torch.device:
    """Start the default process group from the variables that
    ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and return this
    rank's device: ``cuda:{LOCAL_RANK % device_count}`` or the CPU."""
    if not launched():
        raise RuntimeError("no process group to start: RANK and WORLD_SIZE "
                           "are not set (launch with python -m "
                           "torch.distributed.run)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = device_for(device_type, int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or default_backend(device_type),
                                init_method="env://", rank=rank,
                                world_size=world)
    return device


def device_for(device_type: str, local_rank: int) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device(device_type)


def make_mesh(n_data: int, n_model: int = 1, n_pipe: int = 1,
              n_seq: int = 1, device_type: str = "cuda",
              backend: Optional[str] = None):
    """The (data, model, pipe, seq) ``DeviceMesh`` over the started process
    group, ranks laid out row-major in the JAX order (JAX ``make_mesh``;
    ``n_data * n_model * n_pipe * n_seq`` must be the world size).
    ``backend`` must be the group's own (it is checked); None takes it."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    shape = (n_data, n_model, n_pipe, n_seq)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {n_data} x {n_model} x {n_pipe} x {n_seq} "
                         f"!= world size {world}")
    if backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    layout = torch.arange(world).reshape(shape)
    return DeviceMesh(device_type, layout,
                      mesh_dim_names=(AXES.data, AXES.model, AXES.pipe,
                                      AXES.seq))


def dim_size(mesh, name: str) -> int:
    """The size of the mesh's dim ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def process_local_rows(n_rows: int, mesh) -> slice:
    """The contiguous block of a global batch's rows that this rank's data
    coordinate owns (JAX ``process_local_rows``): every rank draws the
    same batch order and collates only its block."""
    n = dim_size(mesh, AXES.data)
    p = mesh.get_local_rank(AXES.data)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not split over {n} data ranks")
    per = n_rows // n
    return slice(p * per, (p + 1) * per)
