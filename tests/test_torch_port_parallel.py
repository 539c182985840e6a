"""Data, ZeRO-1, FSDP and context parallelism of the port
(``wav2vec_s_tpu_torch/parallel/``) on two CPU ranks over gloo, against
the port in one process and the JAX package on one device.

Tiny dims (``tests/test_caat.py``), float32, seeded numpy weights carried
across by ``checkpoint/convert.py``.  One job of spawned ranks
(``tests/_torch_parallel_worker.py``, torch only) runs every scenario;
the test process runs the one-process references and the JAX steps.

- 2-rank DP, ZeRO-1 and FSDP, CAAT and pre-training: two updates of a
  4-row batch (2 rows a rank) equal one process over the 4 rows, and the
  JAX step (pre-training with the port's draws planted at the JAX draw
  sites, as in ``tests/test_torch_port_pretrain.py``).  ZeRO-1 keeps half
  the moments on each rank.
- DP and context parallelism with every dropout, layerdrop and
  ``rand_pos_decoder`` on equal one process: the masks and draws are the
  rows' (the time block's) part of the whole batch's.
- A checkpoint of a 2-rank ZeRO-1 / FSDP run resumes in one process, and
  one of one process resumes on 2 ranks, equal to an uninterrupted run.
- Adafactor's factored moments under dim-0 shards equal the whole update.
- ``run.remat=dots`` under DP (the randomness on), ZeRO-1 and FSDP, and
  the flat optimizer under ZeRO-1 (each rank owning half of the padded
  vector's moments), equal one process.
- The pre-training validation loss summed over 2 data ranks equals one
  process's.
- 2-rank context parallelism: the encoder's features, and two CAAT and
  pre-training updates, equal one process.
- Context parallelism with sharded state on 4 ranks (data 2 x seq 2, ZeRO-1
  and FSDP; every dropout on in one FSDP case): two updates equal one
  process, i.e. the ``run.seq=1`` update.

Tolerances: losses and grad norms rtol 1e-5; parameters atol 1e-5 rtol
1e-4 (``tests/test_context_parallel.py``), features atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_parallel_worker as worker
from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_import import jax_caat, port_cfg
from tests.test_torch_port_pretrain import Draws, jax_w2v
from wav2vec_s_tpu.models.feature_extractor import conv_output_length
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu.train.optim import OptimConfig as JaxOptimConfig
from wav2vec_s_tpu.train.optim import build_optimizer as jax_build_optimizer
from wav2vec_s_tpu.train.step import TrainState as JaxTrainState
from wav2vec_s_tpu.train.step import make_train_step as jax_make_train_step
from wav2vec_s_tpu_torch.checkpoint.convert import (
    caat_state_dict_from_jax, wav2vec2_state_dict_from_jax)
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.models.caat import CaatConfig
from wav2vec_s_tpu_torch.train.optim import Adafactor, OptimConfig
from wav2vec_s_tpu_torch.utils.masking import (
    compute_span_mask_np, expected_mask_count)

torch.set_num_threads(1)

B, S = 4, 2400                       # the global batch: 2 rows a rank
OPTIM = dict(lr=1e-3, clip_norm=2.0, weight_decay=0.01,
             lr_scheduler="inverse_sqrt", warmup_updates=2, total_updates=10)
NO_DROP = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
               encoder_layerdrop=0.0)
W2V = dataclasses.replace(W2V_TINY, **NO_DROP)
CAAT = dataclasses.replace(CAAT_TINY, rand_pos_decoder=0)
W2V_PRE = dataclasses.replace(W2V_TINY, latent_vars=4, n_negatives=10,
                              feature_grad_mult=0.1, dropout_input=0.0,
                              dropout_features=0.0, **NO_DROP)
MODES = ("dp", "zero", "fsdp")
TOL = dict(rtol=1e-4, atol=1e-5)


def caat_batch(seed):
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((B, S)) * 0.3).astype(np.float32)
    tgt = rng.integers(4, CAAT.vocab_size, (B, 6)).astype(np.int64)
    tgt[:, -1] = CAAT.eos
    tgt[1, 3:] = CAAT.pad
    tgt[1, 2] = CAAT.eos
    pad = np.zeros((B, S), bool)
    pad[2, 1800:] = True
    return {"source": src, "targets": tgt, "padding_mask": pad}


def pretrain_batch(seed):
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((B, S)) * 0.3).astype(np.float32)
    frames = conv_output_length(S, W2V_PRE.conv_feature_layers)
    M = expected_mask_count(frames)
    mask = compute_span_mask_np((B, frames), None, 0.65, 10, rng,
                                exact_count=M)
    pos = np.stack([np.flatnonzero(r)[:M] for r in mask]).astype(np.int64)
    return {"source": src, "mask_positions": pos}


def torch_batches(batches):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]


def caat_scenario(w2v=W2V, caat=CAAT, **kw):
    params = jax_caat(W2V, CAAT)[1]
    return dict(task="caat", w2v=port_cfg(Wav2Vec2Config, w2v),
                caat=port_cfg(CaatConfig, caat),
                state=caat_state_dict_from_jax(params), optim=OPTIM,
                batches=torch_batches([caat_batch(s) for s in (0, 1)]), **kw)


def pretrain_scenario(w2v=W2V_PRE, **kw):
    params = jax_w2v(W2V_PRE)[1]
    return dict(task="pretrain", w2v=port_cfg(Wav2Vec2Config, w2v),
                state=wav2vec2_state_dict_from_jax(params), optim=OPTIM,
                batches=torch_batches([pretrain_batch(s) for s in (0, 1)]),
                **kw)


def _adafactor_case():
    """Parameters whose factored moments keep (d0 != 0) or drop the
    leading dim, one unfactored and one that no rank split evenly, with
    two gradients each."""
    g = torch.Generator().manual_seed(3)
    shapes = [(256, 192), (130, 256), (192, 130), (5, 200), (67,)]
    params = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) * 0.1 for s in shapes]
             for _ in range(2)]
    return params, grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario on 2 ranks, and the one-process references."""
    dropout_w2v = dataclasses.replace(
        W2V_TINY, dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
        encoder_layerdrop=0.3)
    dropout_caat = dataclasses.replace(
        CAAT_TINY, dropout=0.1, attention_dropout=0.1,
        activation_dropout=0.1, rand_pos_decoder=8)
    one = {}
    for task, make in (("caat", caat_scenario),
                       ("pretrain", pretrain_scenario)):
        one[task] = worker.train(make())
        one[task + "_half"] = worker.train(make(), updates=slice(0, 1))
    one["dropout"] = worker.train(caat_scenario(dropout_w2v, dropout_caat))
    one["caat_flat"] = worker.train(caat_scenario(flat=True))
    one["valid"] = worker.validate(pretrain_scenario())
    one["cp_features"] = worker.features(
        pretrain_scenario(dataclasses.replace(W2V_PRE, seq_axis=None)))
    scenarios = {f"{t}_{m}": make(mode=m) for m in MODES
                 for t, make in (("caat", caat_scenario),
                                 ("pretrain", pretrain_scenario))}
    scenarios["dropout"] = caat_scenario(dropout_w2v, dropout_caat)
    scenarios["dropout_dots"] = caat_scenario(dropout_w2v, dropout_caat,
                                              remat="dots")
    scenarios["caat_zero_dots"] = caat_scenario(mode="zero", remat="dots")
    scenarios["caat_fsdp_dots"] = caat_scenario(mode="fsdp", remat="dots")
    scenarios["caat_zero_flat"] = caat_scenario(mode="zero", flat=True)
    for m in ("zero", "fsdp"):
        scenarios[f"save_{m}"] = caat_scenario(mode=m, kind="save")
        scenarios[f"resume_{m}"] = caat_scenario(
            mode=m, kind="resume_from",
            payload=worker.state_to_host(one["caat_half"][1]))
    scenarios["valid"] = pretrain_scenario(kind="valid")
    cp = dataclasses.replace(W2V_PRE, seq_axis="seq")
    scenarios["cp_features"] = pretrain_scenario(cp, seq=2, kind="features")
    scenarios["cp_pretrain"] = pretrain_scenario(cp, seq=2)
    scenarios["cp_caat"] = caat_scenario(
        dataclasses.replace(W2V, seq_axis="seq"), seq=2)
    scenarios["cp_dropout"] = caat_scenario(
        dataclasses.replace(dropout_w2v, seq_axis="seq"), dropout_caat,
        seq=2)
    for m in ("zero", "fsdp"):
        scenarios[f"adafactor_{m}"] = dict(kind="adafactor", mode=m,
                                           case=_adafactor_case())
    got = worker.run_job(scenarios, str(tmp_path_factory.mktemp("ranks")))
    return one, got


def _params(payload):
    return payload["model"]


def assert_same_run(got, want_logs, want_model):
    for a, b in zip(got["logs"], want_logs):
        for k in ("loss_total", "sample_size", "grad_norm", "skipped"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    have = _params(got["payload"])
    assert have.keys() == want_model.keys()
    for k, v in want_model.items():
        torch.testing.assert_close(have[k], v.detach(), **TOL, msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("task", ["caat", "pretrain"])
def test_two_ranks_equal_one_process(runs, task, mode):
    one, got = runs
    logs, state = one[task]
    assert_same_run(got[f"{task}_{mode}"], logs, state.model.state_dict())


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's parameters after the same two updates on one
    device: CAAT, and pre-training with the port's draws planted."""
    out = {}
    jopt = jax_build_optimizer(JaxOptimConfig(**OPTIM))
    model_j, params = jax_caat(W2V, CAAT)
    step = jax.jit(jax_make_train_step(
        jax_recipes.make_caat_loss_fn(model_j, CAAT), jopt))
    state = JaxTrainState.create(params, jopt)
    for s in (0, 1):
        b = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                            else v) for k, v in caat_batch(s).items()}
        state, _ = step(state, b, jax.random.PRNGKey(0))
    out["caat"] = caat_state_dict_from_jax(jax.device_get(state.params))
    with pytest.MonkeyPatch.context() as mp:
        draws = Draws(mp)
        worker.train(pretrain_scenario(), updates=slice(0, 1))
        draws.plant()
        model_j, params = jax_w2v(W2V_PRE)
        step = jax.jit(jax_make_train_step(
            jax_recipes.make_pretrain_loss_fn(model_j, 8, 4), jopt))
        state = JaxTrainState.create(params, jopt)
        for s in (0, 1):
            b = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                                else v)
                 for k, v in pretrain_batch(s).items()}
            state, _ = step(state, b, jax.random.PRNGKey(0))
    out["pretrain"] = wav2vec2_state_dict_from_jax(
        jax.device_get(state.params))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("task", ["caat", "pretrain"])
def test_two_ranks_equal_jax_on_one_device(runs, jax_params, task, mode):
    have = _params(runs[1][f"{task}_{mode}"]["payload"])
    for k, v in jax_params[task].items():
        torch.testing.assert_close(have[k], v, rtol=0,
                                   atol=1e-2 * OPTIM["lr"], msg=k)


@pytest.mark.parametrize("name", ["dropout", "cp_dropout"])
def test_dropout_on_equals_one_process(runs, name):
    """DP (2 data ranks) and context parallelism (2 seq ranks) with every
    dropout, layerdrop and rand_pos_decoder on."""
    one, got = runs
    logs, state = one["dropout"]
    assert_same_run(got[name], logs, state.model.state_dict())


@pytest.mark.parametrize("name,ref", [("dropout_dots", "dropout"),
                                      ("caat_zero_dots", "caat"),
                                      ("caat_fsdp_dots", "caat")])
def test_remat_dots_on_two_ranks_equals_one_process(runs, name, ref):
    """``run.remat=dots`` under data parallelism (every dropout, layerdrop
    and rand_pos_decoder on: each rank's recompute replays its rows' part
    of the whole batch's draws), under ZeRO-1 and under FSDP (its units
    gather their parameters again in the recompute)."""
    one, got = runs
    logs, state = one[ref]
    assert_same_run(got[name], logs, state.model.state_dict())


def test_flat_optimizer_under_zero_equals_one_process(runs):
    """The flat optimizer under ZeRO-1: each rank owns half of the padded
    vector's moments, and the two updates equal the flat optimizer in one
    process (moments compared whole, in the single-process layout)."""
    one, got = runs
    logs, state = one["caat_flat"]
    res = got["caat_zero_flat"]
    assert_same_run(res, logs, state.model.state_dict())
    want_opt = worker.state_to_host(state)["opt"]
    assert res["payload"]["opt"]["flat"] and want_opt["flat"]
    for name in ("mu", "nu"):
        (a,), (b,) = res["payload"]["opt"][name], want_opt[name]
        assert a.numel() % 64 == 0
        torch.testing.assert_close(a, b, **TOL)
    whole, zero = (got[k]["moment_bytes"] for k in ("caat_dp",
                                                     "caat_zero_flat"))
    # two moments of half the vector, padded by under 64 elements
    assert zero[0] == zero[1]
    assert whole[0] // 2 <= zero[0] < whole[0] // 2 + 64 * 4


def test_zero_keeps_half_the_moments_on_each_rank(runs):
    got = runs[1]
    whole = got["caat_dp"]["moment_bytes"]
    zero = got["caat_zero"]["moment_bytes"]
    assert whole[0] == whole[1]
    # every leading dim of the tiny model but a few odd ones is even
    assert all(0.45 * whole[0] <= z <= 0.55 * whole[0] for z in zero), (
        whole, zero)


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_two_rank_checkpoint_resumes_in_one_process(runs, mode):
    one, got = runs
    payload = got[f"save_{mode}"]["payload"]
    logs, state = worker.train(caat_scenario(), updates=slice(1, 2),
                               payload=payload)
    want_logs, want = one["caat"]
    assert state.step == 2 and state.opt_state.count == 2
    for k in ("loss_total", "grad_norm"):
        np.testing.assert_allclose(logs[0][k], want_logs[1][k], rtol=1e-5)
    for k, v in want.model.state_dict().items():
        torch.testing.assert_close(state.model.state_dict()[k], v, **TOL,
                                   msg=k)


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_one_process_checkpoint_resumes_on_two_ranks(runs, mode):
    one, got = runs
    want_logs, want = one["caat"]
    res = got[f"resume_{mode}"]
    np.testing.assert_allclose(res["logs"][0]["loss_total"],
                               want_logs[1]["loss_total"], rtol=1e-5)
    assert res["payload"]["step"] == 2
    for k, v in want.model.state_dict().items():
        torch.testing.assert_close(res["payload"]["model"][k], v, **TOL,
                                   msg=k)
    # the moments came back whole, in the single-process layout
    want_opt = worker.state_to_host(want)["opt"]
    for name in ("mu", "nu"):
        for a, b in zip(res["payload"]["opt"][name], want_opt[name]):
            torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_adafactor_row_shards_equal_the_whole_update(runs, mode):
    params, grads = _adafactor_case()
    opt = Adafactor(OptimConfig(optimizer="adafactor", lr=1e-2,
                                lr_scheduler="inverse_sqrt",
                                warmup_updates=1))
    state = opt.init(params)
    for g in grads:
        opt.update(params, [t.clone() for t in g], state, torch.tensor(0.0))
    for a, b in zip(runs[1][f"adafactor_{mode}"]["params"], params):
        torch.testing.assert_close(a, b, **TOL)


def test_pretrain_validation_equals_one_process(runs):
    """The validation loss summed over 2 data ranks equals one process's:
    the feature penalty and the perplexities are whole-batch means in
    validation too (the recipe's ``_batch_mean``)."""
    one, got = runs
    want, have = one["valid"], got["valid"]["valid"]
    for k in ("loss", "sample_size"):
        np.testing.assert_allclose(have[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("prob_perplexity", "code_perplexity"):
        np.testing.assert_allclose(have["logs"][k], want["logs"][k],
                                   rtol=1e-5, err_msg=k)


def test_context_parallel_features_equal_one_process(runs):
    one, got = runs
    torch.testing.assert_close(got["cp_features"]["features"],
                               one["cp_features"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("task", ["caat", "pretrain"])
def test_context_parallel_updates_equal_one_process(runs, task):
    one, got = runs
    logs, state = one[task]
    assert_same_run(got[f"cp_{task}"], logs, state.model.state_dict())


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    """Context parallelism with ZeRO-1 and FSDP on 4 ranks (data 2 x seq
    2), and the dropout case's one-process reference."""
    dropout_w2v = dataclasses.replace(
        W2V_TINY, dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
        encoder_layerdrop=0.3, seq_axis="seq")
    dropout_caat = dataclasses.replace(
        CAAT_TINY, dropout=0.1, attention_dropout=0.1,
        activation_dropout=0.1, rand_pos_decoder=8)
    scenarios = {}
    for m in ("zero", "fsdp"):
        scenarios[f"cp_caat_{m}"] = caat_scenario(
            dataclasses.replace(W2V, seq_axis="seq"), seq=2, mode=m)
        scenarios[f"cp_pretrain_{m}"] = pretrain_scenario(
            dataclasses.replace(W2V_PRE, seq_axis="seq"), seq=2, mode=m)
    scenarios["cp_dropout_fsdp"] = caat_scenario(dropout_w2v, dropout_caat,
                                                 seq=2, mode="fsdp")
    one = worker.train(caat_scenario(
        dataclasses.replace(dropout_w2v, seq_axis=None), dropout_caat))
    return one, worker.run_job(scenarios,
                               str(tmp_path_factory.mktemp("ranks4")),
                               world=4)


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
@pytest.mark.parametrize("task", ["caat", "pretrain"])
def test_context_parallel_sharded_state_equals_one_process(runs, runs4,
                                                           task, mode):
    one, _ = runs
    logs, state = one[task]
    got = runs4[1][f"cp_{task}_{mode}"]
    assert_same_run(got, logs, state.model.state_dict())
    # the moments are split over the 2 data ranks, not the seq ranks
    b = got["moment_bytes"]
    assert b[0] == b[1] and b[2] == b[3] and b[0] < sum(b) / 2


def test_context_parallel_fsdp_dropout_equals_one_process(runs4):
    logs, state = runs4[0]
    assert_same_run(runs4[1]["cp_dropout_fsdp"], logs,
                    state.model.state_dict())
