"""Tensor parallelism of the port (``wav2vec_s_tpu_torch/parallel/
sharding.py`` ``shard_params`` and the ``model`` dim of ``ParallelPlan``)
on 2 and 4 CPU ranks over gloo, against the port in one process and the
JAX package on one device.

Tiny dims (``tests/test_caat.py``), float32, seeded numpy weights carried
across by ``checkpoint/convert.py``, the scenarios and the one-process
references of ``tests/test_torch_port_parallel.py``:

- data 1 x model 2, and data 2 x model 2 with DP, ZeRO-1 and FSDP, CAAT
  and pre-training: two updates equal one process over the same rows,
  and the JAX one-device update (every rate at 0; the JAX package's own TP
  update is the replicated one, ``tests/test_train_step.py``).  The split
  reaches every attention and FFN projection and the quantizer's
  ``weight_proj``; each rank holds half of them and of their moments.
- Every dropout, layerdrop and ``rand_pos_decoder`` on: the head-sharded
  probabilities and the column-sharded FFN activations draw the whole
  batch's bits (``ops/dropout.py`` index maps; the flash encoder's twin
  through its head base), so the update equals one process's.
- A TP checkpoint (gathered into the single-process layout) resumes in
  one process, and one process's resumes under TP.
- Adafactor under TP, TP with context parallelism, and the flat optimizer
  under TP and under FSDP raise.

Tolerances (``tests/test_torch_port_parallel.py``'s): losses and grad
norms rtol 1e-5; parameters atol 1e-5 rtol 1e-4; against JAX, atol
1e-2 * lr.  Not bit-equal: a row-parallel product sums its halves over
the model group, in another order than one matmul does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests import _torch_parallel_worker as worker
from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_parallel import (  # noqa: F401  (fixture)
    OPTIM, TOL, W2V, assert_same_run, caat_scenario, jax_params,
    pretrain_scenario)

torch.set_num_threads(1)

MODES = ("dp", "zero", "fsdp")
DROP_W2V = dataclasses.replace(
    W2V_TINY, dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
    encoder_layerdrop=0.3)
DROP_CAAT = dataclasses.replace(
    CAAT_TINY, dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
    rand_pos_decoder=8)
FLASH_W2V = dataclasses.replace(DROP_W2V, attention_impl="flash")
MAKE = {"caat": caat_scenario, "pretrain": pretrain_scenario}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process references, and every scenario on its ranks."""
    one = {task: worker.train(make()) for task, make in MAKE.items()}
    one["caat_half"] = worker.train(caat_scenario(), updates=slice(0, 1))
    one["dropout"] = worker.train(caat_scenario(DROP_W2V, DROP_CAAT))
    one["flash"] = worker.train(caat_scenario(FLASH_W2V, DROP_CAAT))
    two = {f"{t}_tp": make(model=2) for t, make in MAKE.items()}
    two["dropout_tp"] = caat_scenario(DROP_W2V, DROP_CAAT, model=2)
    two["flash_tp"] = caat_scenario(FLASH_W2V, DROP_CAAT, model=2)
    two["save_tp"] = caat_scenario(model=2, kind="save")
    two["resume_tp"] = caat_scenario(
        model=2, kind="resume_from",
        payload=worker.state_to_host(one["caat_half"][1]))
    four = {f"{t}_{m}": make(model=2, mode=m) for m in MODES
            for t, make in MAKE.items()}
    four["dropout_fsdp"] = caat_scenario(DROP_W2V, DROP_CAAT, model=2,
                                         mode="fsdp")
    four["save_zero"] = caat_scenario(model=2, mode="zero", kind="save")
    four["refusals"] = dict(kind="refusals")
    got = worker.run_job(two, str(tmp_path_factory.mktemp("two")), world=2)
    got.update(worker.run_job(four, str(tmp_path_factory.mktemp("four")),
                              world=4))
    return one, got


@pytest.mark.parametrize("layout", ["tp", "dp", "zero", "fsdp"])
@pytest.mark.parametrize("task", ["caat", "pretrain"])
def test_tensor_parallel_equals_one_process(runs, task, layout):
    one, got = runs
    logs, state = one[task]
    assert_same_run(got[f"{task}_{layout}"], logs, state.model.state_dict())


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("task", ["caat", "pretrain"])
def test_tensor_parallel_equals_jax_on_one_device(runs, jax_params, task,
                                                  layout):
    have = runs[1][f"{task}_{layout}"]["payload"]["model"]
    for k, v in jax_params[task].items():
        torch.testing.assert_close(have[k], v, rtol=0,
                                   atol=1e-2 * OPTIM["lr"], msg=k)


@pytest.mark.parametrize("task", ["caat", "pretrain"])
def test_the_split_reaches_every_projection(runs, task):
    """Which weights the rule splits, and that each rank holds half the
    moments of one process (the tiny model's widths all divide by 2)."""
    one, got = runs
    keys = got[f"{task}_tp"]["tp_keys"]
    names = {k.split(".")[-2] for k in keys}
    want = {"q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"}
    if task == "pretrain":
        want.add("weight_proj")
    assert names == want
    assert not any(k.endswith("out_proj.bias") or k.endswith("fc2.bias")
                   for k in keys)        # row-parallel biases stay whole
    n_layers = sum(1 for k in keys if k.endswith("fc1.weight"))
    assert n_layers == (W2V.encoder_layers + (
        CAAT_TINY.decoder_layers + CAAT_TINY.jointer_layers
        if task == "caat" else 0))
    whole = got[f"{task}_dp"]["moment_bytes"]
    zero = got[f"{task}_zero"]["moment_bytes"]
    assert len(set(whole)) == 1 and all(z < whole[0] for z in zero)


@pytest.mark.parametrize("name", ["dropout_tp", "dropout_fsdp", "flash_tp"])
def test_tensor_parallel_dropout_equals_one_process(runs, name):
    """The flash case drops the probabilities in the kernel's twin, at
    the rank's head base (``dropout_h0`` / ``dropout_heads``)."""
    one, got = runs
    logs, state = one["flash" if name == "flash_tp" else "dropout"]
    assert_same_run(got[name], logs, state.model.state_dict())


@pytest.mark.parametrize("name", ["save_tp", "save_zero"])
def test_tensor_parallel_checkpoint_resumes_in_one_process(runs, name):
    one, got = runs
    payload = got[name]["payload"]
    want_logs, want = one["caat"]
    assert payload["model"].keys() == want.model.state_dict().keys()
    logs, state = worker.train(caat_scenario(), updates=slice(1, 2),
                               payload=payload)
    assert state.step == 2 and state.opt_state.count == 2
    for k in ("loss_total", "grad_norm"):
        np.testing.assert_allclose(logs[0][k], want_logs[1][k], rtol=1e-5)
    for k, v in want.model.state_dict().items():
        torch.testing.assert_close(state.model.state_dict()[k], v, **TOL,
                                   msg=k)


def test_one_process_checkpoint_resumes_under_tensor_parallelism(runs):
    one, got = runs
    want_logs, want = one["caat"]
    res = got["resume_tp"]
    np.testing.assert_allclose(res["logs"][0]["loss_total"],
                               want_logs[1]["loss_total"], rtol=1e-5)
    for k, v in want.model.state_dict().items():
        torch.testing.assert_close(res["payload"]["model"][k], v, **TOL,
                                   msg=k)
    want_opt = worker.state_to_host(want)["opt"]
    for name in ("mu", "nu"):
        for a, b in zip(res["payload"]["opt"][name], want_opt[name]):
            torch.testing.assert_close(a, b, **TOL)


def test_what_does_not_compose_raises(runs):
    errors = runs[1]["refusals"]["errors"]
    assert "Adafactor under tensor parallelism" in errors["adafactor"]
    assert "does not compose with context parallelism" in errors["seq"]


def test_the_flat_optimizer_refuses_tp_and_fsdp(runs):
    """No rank holds the whole flat vector under tensor parallelism or
    FSDP (the trainer turns the flat optimizer off under run.fsdp, as the
    JAX CLI does)."""
    errors = runs[1]["refusals"]["errors"]
    assert "a TP shard does not hold the whole flat vector" in (
        errors["flat_tp"])
    assert "flat optimizer under FSDP" in errors["flat_fsdp"]
