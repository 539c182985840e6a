"""Rank side of ``tests/test_torch_port_parallel.py``,
``tests/test_torch_port_parallel_cli.py``,
``tests/test_torch_port_tensor_parallel.py`` and
``tests/test_torch_port_pipeline.py``: torch and the port only (no JAX),
run in processes started by ``spawn`` over a gloo group of the CPU.
``run_rank`` executes every scenario of a job file and rank 0 writes the
results the test process compares; ``run_cli_rank`` runs ``train.cli``
calls, ``run_pipeline_rank`` the pipeline's.  ``run_job`` /
``run_cli_job`` / ``run_pipeline_job`` (in the test process) start the
ranks, the wait bounded, and return the results."""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from wav2vec_s_tpu_torch.checkpoint.io import load_into_state, state_to_host
from wav2vec_s_tpu_torch.models import Wav2Vec2Model
from wav2vec_s_tpu_torch.models.caat import W2V2CaatModel
from wav2vec_s_tpu_torch.parallel.context import enable
from wav2vec_s_tpu_torch.parallel.mesh import make_mesh, process_local_rows
from wav2vec_s_tpu_torch.parallel.sharding import ParallelPlan
from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
from wav2vec_s_tpu_torch.train.recipes import (
    make_caat_loss_fn, make_pretrain_loss_fn)
from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

WAIT_S = 120                     # each rank's wait, so a hang fails a test


def build(sc):
    """A model of the scenario, loaded from its state dict."""
    if sc["task"] == "caat":
        model = W2V2CaatModel(sc["w2v"], sc["caat"])
    else:
        model = Wav2Vec2Model(sc["w2v"], pretraining=True)
    model.load_state_dict(sc["state"], strict=True)
    return model


def train(sc, plan=None, updates=None, payload=None):
    """(logs per update, state) of the scenario's updates on ``plan``
    (None: one process over the whole batches); ``payload``: a checkpoint
    of ``state_to_host`` to resume from first; the scenario's ``remat``
    policy and ``flat`` optimizer, when it names them."""
    model = build(sc)
    if plan is not None:
        plan.prepare(model)
        if plan.seq_group is not None:
            enable(model, plan.seq_group)
    opt = build_optimizer(OptimConfig(**sc["optim"]))
    flat = sc.get("flat", False)
    state = TrainState.create(model, opt, plan, flat_optimizer=flat)
    if payload is not None:
        load_into_state(state, payload)
    if sc["task"] == "caat":
        loss = make_caat_loss_fn(model, sc["caat"], plan=plan)
    else:
        loss = make_pretrain_loss_fn(model, 8, 4, plan=plan)
    step = make_train_step(loss, opt, remat_policy=sc.get("remat", "none"))
    logs_all = []
    batches = sc["batches"] if updates is None else sc["batches"][updates]
    for batch in batches:
        if plan is not None:
            rows = process_local_rows(len(batch["source"]), plan.mesh)
            batch = {k: v[rows] for k, v in batch.items()}
        state, logs = step(state, batch, torch.Generator().manual_seed(0))
        logs_all.append({k: float(v) for k, v in logs.items()})
    return logs_all, state


def validate(sc, plan=None):
    """The pre-training validation loss (no dropout, hard codes) of the
    scenario's first batch: loss and sample size (summed over the data
    group under ``plan``, each rank on its rows) and the logs."""
    model = build(sc)
    loss_fn = make_pretrain_loss_fn(model, 8, 4, train=False, plan=plan)
    batch = sc["batches"][0]
    if plan is not None:
        rows = process_local_rows(len(batch["source"]), plan.mesh)
        batch = {k: v[rows] for k, v in batch.items()}
    with torch.no_grad():
        loss, n, logs = loss_fn(batch, None, 0)
    tot = torch.stack([loss.double(), torch.as_tensor(n).double()])
    if plan is not None:
        dist.all_reduce(tot, group=plan.data_group)
    return {"loss": float(tot[0]), "sample_size": float(tot[1]),
            "logs": {k: float(v) for k, v in logs.items()}}


def features(sc, plan=None):
    """The encoder features of the scenario's first batch (eval mode)."""
    model = build(sc)
    if plan is not None and plan.seq_group is not None:
        enable(model, plan.seq_group)
    with torch.no_grad():
        return model.extract_features(sc["batches"][0]["source"], None, 8,
                                      4)[0]


def adafactor_shards(sc, plan):
    """Two Adafactor updates of the case's parameters on this rank's rows
    (ZeRO's even blocks where the leading dim divides, else whole; FSDP's
    torch.chunk rows), gathered back whole."""
    from wav2vec_s_tpu_torch.parallel.sharding import RowShard, gather_rows
    from wav2vec_s_tpu_torch.train.optim import Adafactor

    params, grads = sc["case"]
    n, r = plan.n_data, plan.data_rank
    shards, spans = [], []
    for p in params:
        rows = p.shape[0]
        if sc["mode"] == "zero":
            if rows % n:
                shards.append(None)
                spans.append(slice(0, rows))
                continue
            start, size = r * (rows // n), rows // n
        else:
            chunk = -(-rows // n)
            start = min(rows, r * chunk)
            size = max(0, min(chunk, rows - start))
        shards.append(RowShard(start, rows, plan.data_group))
        spans.append(slice(start, start + size))
    opt = Adafactor(OptimConfig(optimizer="adafactor", lr=1e-2,
                                lr_scheduler="inverse_sqrt",
                                warmup_updates=1))
    blocks = [p[sp].clone() for p, sp in zip(params, spans)]
    state = opt.init(blocks, shards)
    for g in grads:
        opt.update(blocks, [t[sp].clone() for t, sp in zip(g, spans)],
                   state, torch.tensor(0.0), shards)
    return {"params": [b if sh is None else gather_rows(b, sh)
                       for b, sh in zip(blocks, shards)]}


def moment_bytes(state) -> int:
    import dataclasses
    return sum(t.numel() * t.element_size()
               for f in dataclasses.fields(state.opt_state)
               if f.name != "count"
               for t in getattr(state.opt_state, f.name))


def refusals(world):
    """The errors of what the plan does not compose: Adafactor under TP,
    TP with context parallelism (a 1 x 2 x 1 x 2 mesh), and the flat
    optimizer under TP and under FSDP."""
    from wav2vec_s_tpu_torch.train.optim import Adafactor, Adam

    out = {}
    plan = ParallelPlan(make_mesh(world // 2, n_model=2, device_type="cpu",
                                  backend="gloo"))
    model = torch.nn.Linear(4, 4)
    try:
        TrainState.create(model, Adafactor(OptimConfig(
            optimizer="adafactor")), plan)
    except ValueError as e:
        out["adafactor"] = str(e)
    fsdp = ParallelPlan(make_mesh(world, device_type="cpu", backend="gloo"),
                        "fsdp")
    for name, p in (("flat_tp", plan), ("flat_fsdp", fsdp)):
        try:
            TrainState.create(model, Adam(OptimConfig()), p,
                              flat_optimizer=True)
        except ValueError as e:
            out[name] = str(e)
    try:
        ParallelPlan(make_mesh(world // 4, n_model=2, n_seq=2,
                               device_type="cpu", backend="gloo"))
    except ValueError as e:
        out["seq"] = str(e)
    return out


def run_scenario(sc, world):
    if sc.get("kind") == "refusals":
        return {"errors": refusals(world)}
    seq, model = sc.get("seq", 1), sc.get("model", 1)
    mesh = make_mesh(world // (seq * model), n_model=model, n_seq=seq,
                     device_type="cpu", backend="gloo")
    plan = ParallelPlan(mesh, sc.get("mode", "dp"))
    kind = sc.get("kind", "train")
    if kind == "adafactor":
        return adafactor_shards(sc, plan)
    if kind == "features":
        return {"features": features(sc, plan)}
    if kind == "valid":
        return {"valid": validate(sc, plan)}
    if kind == "resume_from":        # a one-process checkpoint, then 1 update
        logs, state = train(sc, plan, slice(1, 2), sc["payload"])
        return {"logs": logs, "payload": state_to_host(state)}
    if kind == "save":               # 1 update, then the checkpoint
        from unittest import mock

        from torch.distributed.tensor import DTensor

        logs, state = train(sc, plan, slice(0, 1))
        # FSDP: the plan gathers through the process group's own
        # collectives (DTensor.full_tensor's crash over gloo on CUDA)
        with mock.patch.object(DTensor, "full_tensor", side_effect=(
                AssertionError("a functional collective"))):
            payload = state_to_host(state)
        return {"logs": logs, "payload": payload}
    logs, state = train(sc, plan)
    return {"logs": logs, "payload": state_to_host(state),
            "moment_bytes": moment_bytes(state),
            "tp_keys": sorted(plan.tp_keys)}


def run_rank(rank, world, store, job, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        results = {}
        for name, sc in torch.load(job, weights_only=False).items():
            results[name] = run_scenario(sc, world)
            # every rank's moments, for the ZeRO memory check
            bytes_ = torch.tensor([results[name].get("moment_bytes", 0)])
            every = [torch.zeros_like(bytes_) for _ in range(world)]
            dist.all_gather(every, bytes_)
            results[name]["moment_bytes"] = [int(b) for b in every]
        if rank == 0:
            torch.save(results, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, *args):
    """``fn(rank, world, *args)`` on ``world`` spawned ranks, the wait
    bounded by ``WAIT_S``."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + WAIT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world} ranks did not finish in "
                                   f"{WAIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def run_job(scenarios, workdir, world=2):
    """Run ``scenarios`` ({name: scenario}) on ``world`` spawned ranks and
    return rank 0's results."""
    job, out = os.path.join(workdir, "job.pt"), os.path.join(workdir,
                                                           "out.pt")
    torch.save(scenarios, job)
    _spawn(run_rank, world, os.path.join(workdir, "store"), job, out)
    return torch.load(out, weights_only=False)


def run_cli_rank(rank, world, store, job):
    """Each scenario of the job: ``train.cli.main(argv)`` in this rank,
    its standard output kept in ``<stdout>.<rank>``."""
    import contextlib

    from wav2vec_s_tpu_torch.train import cli

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        for sc in torch.load(job, weights_only=False).values():
            with open(f"{sc['stdout']}.{rank}", "w") as f, \
                    contextlib.redirect_stdout(f):
                cli.main(sc["argv"])
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_cli_job(scenarios, workdir, world=2):
    """``train.cli`` scenarios ({name: {argv, stdout}}) on ``world``
    spawned ranks."""
    job = os.path.join(workdir, "cli_job.pt")
    torch.save(scenarios, job)
    _spawn(run_cli_rank, world, os.path.join(workdir, "cli_store"), job)


# -- the pipeline (tests/test_torch_port_pipeline.py) --------------------


def mlp_layer(p, x):
    """``tests/test_pipeline.py`` ``_mlp_layer``."""
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"]


def attn_layer(p, x):
    """``tests/test_pipeline.py`` ``_attn_layer``: pre-LN attention of 2
    heads and a tanh FFN over [B, T, D]."""
    def ln(z):
        m = z.mean(-1, keepdim=True)
        v = ((z - m) ** 2).mean(-1, keepdim=True)
        return (z - m) * torch.rsqrt(v + 1e-5)

    h = ln(x)
    B, T, D = x.shape
    H = 2
    q = (h @ p["wq"]).reshape(B, T, H, D // H)
    k = (h @ p["wk"]).reshape(B, T, H, D // H)
    v = (h @ p["wv"]).reshape(B, T, H, D // H)
    a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                      / (D // H) ** 0.5, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, T, D)
    x = x + o @ p["wo"]
    return x + torch.tanh(ln(x) @ p["w1"]) @ p["w2"]


def encoder_layer_fn(sc):
    """The port's ``TransformerEncoderLayer`` (tiny, pre-LN, GELU) as a
    layer function over its stacked state dict, attending through the
    block-sparse flash path (``FlashSpec``, no padding)."""
    from torch.func import functional_call

    from wav2vec_s_tpu_torch.models.modules import (
        FlashSpec, TransformerEncoderLayer)

    dim, ffn, heads, T, mc, rc = sc["encoder"]
    template = TransformerEncoderLayer(dim, ffn, heads)

    def fn(p, x):
        spec = FlashSpec(torch.zeros(x.shape[:2], dtype=torch.bool,
                                     device=x.device), T, mc, rc)
        return functional_call(template, p, (x, spec, True))
    return fn


def layer_fn_of(sc):
    return {"mlp": lambda sc: mlp_layer, "attn": lambda sc: attn_layer,
            "encoder": encoder_layer_fn}[sc["layer"]](sc)


def pipeline_loss(sc, mesh=None):
    """(loss, gradients of the stacked leaves) of the mean squared error
    against ``sc["target"]``: ``pipeline_apply`` on ``mesh``, or
    ``apply_stacked`` in one process.  Under a mesh the loss and the
    gradients come back summed over the world (each stage holds its
    layers' gradients, each data rank its rows')."""
    from wav2vec_s_tpu_torch.parallel.pipeline import (
        apply_stacked, local_rows, pipeline_apply)

    stacked = {k: v.clone().requires_grad_() for k, v in
               sc["stacked"].items()}
    fn = layer_fn_of(sc)
    x, tgt = sc["x"], sc["target"]
    if mesh is None:
        out = apply_stacked(fn, stacked, x)
    else:
        out = pipeline_apply(fn, stacked, x, mesh, sc["micro"])
        tgt = local_rows(tgt, mesh, sc["micro"])
    loss = ((out - tgt) ** 2).sum() / sc["target"].numel()
    loss.backward()
    grads = {k: v.grad for k, v in stacked.items()}
    loss = loss.detach()
    if mesh is not None:
        from wav2vec_s_tpu_torch.parallel.mesh import AXES
        dist.all_reduce(loss, group=mesh.get_group(AXES.data))
        for g in grads.values():
            dist.all_reduce(g)
    return loss, grads


def ring(mesh):
    """``ring_shift`` over the pipe group: stage s's ``x`` is s + [0, 1,
    2]; the loss is (s + 1) times the sum of what s received.  Returns
    every stage's (received, gradient of x), gathered."""
    from wav2vec_s_tpu_torch.parallel.functional import ring_shift
    from wav2vec_s_tpu_torch.parallel.mesh import AXES

    group = mesh.get_group(AXES.pipe)
    s = mesh.get_local_rank(AXES.pipe)
    x = (torch.arange(3.0) + s).requires_grad_()
    y = ring_shift(x, group)
    ((s + 1) * y).sum().backward()
    both = torch.stack([y.detach(), x.grad])
    parts = [torch.empty_like(both) for _ in range(dist.get_world_size(
        group))]
    dist.all_gather(parts, both, group=group)
    return torch.stack(parts)


def run_pipeline_rank(rank, world, store, job, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        results = {}
        for name, sc in torch.load(job, weights_only=False).items():
            mesh = make_mesh(sc["data"], n_pipe=sc["pipe"],
                             device_type="cpu", backend="gloo")
            results[name] = (ring(mesh) if sc["layer"] == "ring"
                             else pipeline_loss(sc, mesh))
        if rank == 0:
            torch.save(results, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_pipeline_job(scenarios, workdir, world):
    """Pipeline scenarios (each of ``data * pipe == world`` ranks) on
    ``world`` spawned ranks; rank 0's results."""
    job, out = (os.path.join(workdir, f"pipe{world}.pt"),
                os.path.join(workdir, f"pipe{world}_out.pt"))
    torch.save(scenarios, job)
    _spawn(run_pipeline_rank, world, os.path.join(workdir,
                                                  f"pipe{world}_store"),
           job, out)
    return torch.load(out, weights_only=False)
