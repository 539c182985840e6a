"""Checkpoint save/restore with keep-K and keep-best policies (port of
``CheckpointManager`` of ``wav2vec_s_tpu/checkpoint/orbax_io.py`` onto
``torch.save`` / ``torch.load(weights_only=True)``).

fairseq's policies (fairseq/fairseq/checkpoint_utils.py:31-163):
every-N-updates, keep-K pruning, best metric, full resume of optimizer and
iterator state.  On disk: ``<dir>/step_<N>/state.pt`` (model state dict,
the optimizer's moments (Adam or adafactor) and update count, the step)
plus ``meta.json`` (step, metric, iterator state).  The moments of the
flat optimizer (``train/step.py`` ``FlatParams``) are one vector each, and
a checkpoint says which kind it holds: a restore under the other kind
raises.  ``meta.json`` doubles as the commit marker: both files
are written to a temp name and renamed, ``meta.json`` last, so an
interrupted save leaves a step directory that ``all_steps`` / ``restore``
ignore.

``async_save``: ``save`` copies the tensors to host memory (one device
synchronisation), then a background thread writes the file while training
goes on; at most one write is in flight, ``wait`` commits it.

For evaluation: ``load_params`` reads the model state dict of the latest
step, or ``average_last_checkpoints`` averages the last K (fairseq
scripts/average_checkpoints.py, JAX ``orbax_io.py:127-149``).

A parallel run (a ``TrainState`` with a ``parallel.sharding.ParallelPlan``)
writes the single-process layout: every rank joins the gathers of FSDP's
parameters and of the ZeRO / FSDP moment blocks (``state_to_host``), and
the writer (rank 0) alone writes.  Restoring copies the single-process
payload into any layout: each rank takes its rows (as the JAX
``CheckpointManager`` restores to the template's shardings), so a 2-rank
ZeRO-1 or FSDP checkpoint resumes in one process and the other way round.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from wav2vec_s_tpu_torch.train.step import TrainState


def _moment_fields(opt_state) -> List[str]:
    """The tensor-list fields of an optimizer state (Adam: mu, nu;
    adafactor: v_row, v_col, v)."""
    return [f.name for f in dataclasses.fields(opt_state) if f.name != "count"]


def _sharded_moments(state: TrainState) -> Dict[str, List[bool]]:
    """{moment field: per parameter, whether it is a row block}."""
    fields = _moment_fields(state.opt_state)
    out = {name: [] for name in fields}
    for p, sh in zip(state.opt_params(), state.shards):
        which = state.optimizer.sharded_moments(tuple(p.shape))
        for name in fields:
            out[name].append(sh is not None and which[name])
    return out


def state_to_host(state: TrainState) -> Dict[str, Any]:
    """The checkpoint payload of a train state: CPU copies of the model's
    state dict and the optimizer's moments, the update count and the
    step, in the single-process layout (with a parallel plan every rank
    must call it: it gathers)."""
    def cpu(t):
        return t.detach().to("cpu", copy=True)

    moments = {name: getattr(state.opt_state, name)
               for name in _moment_fields(state.opt_state)}
    model = state.model.state_dict()
    if state.plan is not None:
        model, moments = state.plan.full_state(
            state.model, moments, _sharded_moments(state), state.shards)
    opt = {"count": state.opt_state.count}
    if state.flat is not None:
        opt["flat"] = True
    for name, tensors in moments.items():
        opt[name] = [cpu(t) for t in tensors]
    return {"step": state.step,
            "model": {k: cpu(v) for k, v in model.items()},
            "opt": opt}


def load_into_state(state: TrainState, payload: Dict[str, Any]) -> TrainState:
    """Copy a payload of ``state_to_host`` into ``state`` in place (strict:
    every parameter and moment must be present and shape-matched); under a
    parallel plan each rank takes its rows."""
    plan = state.plan
    if plan is None:
        state.model.load_state_dict(payload["model"], strict=True)
    else:
        plan.load_full_state(state.model, payload["model"])
        sharded = _sharded_moments(state)
    opt = payload["opt"]
    if opt is None:
        raise ValueError("the checkpoint holds no optimizer state (a "
                         "converted model: warm-start from it instead)")
    saved_flat, flat = bool(opt.get("flat", False)), state.flat is not None
    if saved_flat != flat:
        raise ValueError(f"the checkpoint's optimizer state was saved "
                         f"under run.flat_optimizer={str(saved_flat).lower()}"
                         f", this run has run.flat_optimizer="
                         f"{str(flat).lower()}: the moments of one flat "
                         f"vector and of every parameter do not convert")
    for name in _moment_fields(state.opt_state):
        if name not in opt:
            raise ValueError(f"the checkpoint holds no optimizer {name!r} "
                             f"(saved by another optimizer?)")
        dst, src = getattr(state.opt_state, name), opt[name]
        if len(dst) != len(src):
            raise ValueError(f"checkpoint holds {len(src)} optimizer {name} "
                             f"tensors, the model has {len(dst)}")
        with torch.no_grad():
            for i, (d, s) in enumerate(zip(dst, src)):
                if plan is not None:
                    s = plan.moment_block(s, state.shards[i],
                                          sharded[name][i], d, i)
                if d.shape != s.shape:
                    raise ValueError(f"optimizer {name} tensor of shape "
                                     f"{tuple(s.shape)} for "
                                     f"{tuple(d.shape)}")
                d.copy_(s)
    state.opt_state.count = int(opt["count"])
    state.step = int(payload["step"])
    return state


class CheckpointManager:
    def __init__(self, directory, keep_last: int = 3, keep_best: int = 0,
                 maximize_metric: bool = False, async_save: bool = False,
                 writer: bool = True):
        """``writer`` False: ``save`` computes the payload (the gathers of
        a parallel run) and writes nothing (the ranks but rank 0)."""
        self.dir = Path(directory)
        self.writer = writer
        if writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.keep_best = keep_best
        self.maximize = maximize_metric
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- paths ----------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:09d}"

    def all_steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1]) for p in
                      self.dir.glob("step_*")
                      if p.is_dir() and (p / "meta.json").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore -------------------------------------------------
    def save(self, step: int, state: TrainState,
             extra: Optional[Dict[str, Any]] = None,
             metric: Optional[float] = None) -> None:
        payload = state_to_host(state)
        if self.writer:
            self.save_payload(step, payload, extra, metric)

    def save_payload(self, step: int, payload: Dict[str, Any],
                     extra: Optional[Dict[str, Any]] = None,
                     metric: Optional[float] = None) -> None:
        """Save a payload of ``state_to_host``'s shape; a converted model
        has ``opt`` None (``convert_cli``)."""
        # at most one write in flight: commit the previous one first
        self.wait()
        meta = {"step": step, "metric": metric, "extra": extra or {}}
        if self.async_save:
            self._writer = threading.Thread(
                target=self._write_guarded, args=(step, payload, meta))
            self._writer.start()
        else:
            self._write(step, payload, meta)

    def _write_guarded(self, step, payload, meta):
        try:
            self._write(step, payload, meta)
        except BaseException as e:       # noqa: BLE001 — re-raised by wait()
            self._error = e

    def _write(self, step: int, payload, meta) -> None:
        path = self._step_dir(step)
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        tmp = path / "state.pt.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path / "state.pt")
        tmp = path / "meta.json.tmp"
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, path / "meta.json")
        self._prune()

    def wait(self) -> None:
        """Block until any in-flight write has committed; re-raise its
        failure."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, step: Optional[int] = None,
                template: Optional[TrainState] = None):
        """``(state, meta)`` of ``step`` (default: the latest), or
        ``(None, None)`` when the directory holds none.  With a
        ``template`` the payload is loaded into it (and it is returned);
        without one the raw payload dict is returned."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = self._step_dir(step)
        payload = torch.load(path / "state.pt", map_location="cpu",
                             weights_only=True)
        meta = json.loads((path / "meta.json").read_text())
        if template is not None:
            payload = load_into_state(template, payload)
        return payload, meta

    # -- policies -------------------------------------------------------
    def _metric_of(self, step: int) -> Optional[float]:
        try:
            return json.loads(
                (self._step_dir(step) / "meta.json").read_text())["metric"]
        except (OSError, ValueError, KeyError):
            return None

    def _scored(self):
        scored = [(s, self._metric_of(s)) for s in self.all_steps()]
        scored = [(s, m) for s, m in scored if m is not None]
        scored.sort(key=lambda sm: sm[1], reverse=self.maximize)
        return scored

    def _prune(self) -> None:
        steps = self.all_steps()
        keep = set(steps[-self.keep_last:]) if self.keep_last else set(steps)
        if self.keep_best:
            keep |= {s for s, _ in self._scored()[:self.keep_best]}
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def best_step(self) -> Optional[int]:
        scored = self._scored()
        return scored[0][0] if scored else None


# -- averaging and reading for evaluation ----------------------------------

def _reader(directory) -> CheckpointManager:
    """A manager over an existing ``directory``: reading never creates it
    (the manager's constructor would)."""
    if not Path(directory).is_dir():
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    return CheckpointManager(directory, keep_last=0)


def average_params(state_dicts: List[Dict[str, torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    """Uniform parameter averaging (fairseq
    scripts/average_checkpoints.py; JAX ``orbax_io.average_params``): each
    tensor summed in float64 over the state dicts, divided by their count
    and cast back to its own dtype."""
    n = len(state_dicts)
    if n == 0:
        raise ValueError("nothing to average")
    out = {}
    for key, first in state_dicts[0].items():
        acc = torch.zeros(first.shape, dtype=torch.float64)
        for sd in state_dicts:
            acc += sd[key].to("cpu", torch.float64)
        out[key] = (acc / n).to(first.dtype)
    return out


def average_last_checkpoints(directory, k: int) -> Dict[str, torch.Tensor]:
    """The average of the model state dicts of the last ``k`` committed
    steps in ``directory`` (JAX ``orbax_io.average_last_checkpoints``)."""
    mgr = _reader(directory)
    steps = mgr.all_steps()[-k:]
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return average_params([mgr.restore(s)[0]["model"] for s in steps])


def load_params(ckpt_dir, average_k: int = 0) -> Dict[str, torch.Tensor]:
    """The model state dict to evaluate (JAX ``eval/cli.py``
    ``_load_params``): the latest step of ``ckpt_dir``, or the average of
    its last ``average_k`` steps when ``average_k > 1``."""
    if average_k > 1:
        return average_last_checkpoints(ckpt_dir, average_k)
    payload, _ = _reader(ckpt_dir).restore()
    if payload is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return payload["model"]
