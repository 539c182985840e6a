"""Rank side of ``tests/test_torch_port_parallel.py`` and
``tests/test_torch_port_parallel_cli.py``: torch and the port only (no
JAX), run in processes started by ``spawn`` over a gloo group of the CPU.
``run_rank`` executes every scenario of a job file and rank 0 writes the
results the test process compares; ``run_cli_rank`` runs ``train.cli``
calls.  ``run_job`` / ``run_cli_job`` (in the test process) start the
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
    of ``state_to_host`` to resume from first."""
    model = build(sc)
    if plan is not None:
        plan.prepare(model)
        if plan.seq_group is not None:
            enable(model, plan.seq_group)
    opt = build_optimizer(OptimConfig(**sc["optim"]))
    state = TrainState.create(model, opt, plan)
    if payload is not None:
        load_into_state(state, payload)
    if sc["task"] == "caat":
        loss = make_caat_loss_fn(model, sc["caat"], plan=plan)
    else:
        loss = make_pretrain_loss_fn(model, 8, 4, plan=plan)
    step = make_train_step(loss, opt)
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


def run_scenario(sc, world):
    mesh = make_mesh(world // sc.get("seq", 1), sc.get("seq", 1), "cpu",
                     "gloo")
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
        logs, state = train(sc, plan, slice(0, 1))
        return {"logs": logs, "payload": state_to_host(state)}
    logs, state = train(sc, plan)
    return {"logs": logs, "payload": state_to_host(state),
            "moment_bytes": moment_bytes(state)}


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
