"""The flat optimizer of the torch port (``train/step.py`` ``FlatParams``,
``run.flat_optimizer``) against its tree path and the JAX package's
``flat_optimizer=True``.

Tiny CAAT (``tests/test_torch_port_train.py``: float32, dense attention,
dropout off, seeded numpy weights), three updates, clip 2.0, weight decay
0.01:

- the layout: every parameter a view into one vector padded with zeros to
  a multiple of 64, every gradient a view into another;
- Adam: flat equals the tree path (elementwise; the norm is summed in
  another order);
- Adam and Adafactor: flat equals the JAX step with
  ``flat_optimizer=True`` (losses, grad norms, Adam's parameters), and
  each flat update equals the JAX flat optimizer's on the same vector and
  gradient (Adafactor on the 1-D vector is unfactored and clips by the
  whole padded vector's RMS, in both packages); the flat Adafactor equals
  the tree Adafactor over the raveled, padded vector (``torch.cat`` every
  update, the JAX package's ravel);
- a non-finite gradient norm skips the update: parameters, moments and
  count untouched, the gradient views kept;
- through ``train.cli``: a resumed flat run equals an uninterrupted one,
  bit for bit, and a checkpoint of one kind is refused under the other,
  naming the mismatch.

Tolerances: flat against tree, against the raveled tree and against the
JAX flat optimizer on the same gradients, rtol 2e-5 atol 2e-7 (JAX
``tests/test_train_step.py``); against the JAX step, the parameters after
updates atol 1e-2 * lr (``tests/test_torch_port_train.py``), losses and
grad norms rtol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from tests import test_torch_port_train as caat_t
from tests.test_torch_port_cli import _final_params, _overrides, corpus  # noqa: F401
from tests.test_torch_port_import import jax_caat, port_caat
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu.train.optim import OptimConfig as JaxOptimConfig
from wav2vec_s_tpu.train.optim import build_optimizer as jax_build_optimizer
from wav2vec_s_tpu.train.step import TrainState as JaxTrainState
from wav2vec_s_tpu.train.step import make_train_step as jax_make_train_step
from wav2vec_s_tpu_torch.checkpoint.convert import caat_state_dict_from_jax
from wav2vec_s_tpu_torch.train import cli
from wav2vec_s_tpu_torch.train.optim import (
    Adafactor, OptimConfig, build_optimizer)
from wav2vec_s_tpu_torch.train.recipes import make_caat_loss_fn
from wav2vec_s_tpu_torch.train.step import (
    FLAT_MULTIPLE, TrainState, make_train_step)

torch.set_num_threads(1)

OPTIM = {"adam": dict(optimizer="adam", lr=1e-3, clip_norm=2.0,
                      weight_decay=0.01, lr_scheduler="inverse_sqrt",
                      warmup_updates=2, total_updates=10),
         "adafactor": dict(optimizer="adafactor", lr=1e-2,
                           lr_scheduler="inverse_sqrt", warmup_updates=2,
                           total_updates=10)}
UPDATES = 3


def _port(name, flat, loss_wrap=None):
    """(model, state, step) of the tiny CAAT recipe."""
    model = port_caat(jax_caat(caat_t.W2V, caat_t.CAAT)[1], caat_t.W2V,
                      caat_t.CAAT)
    opt = build_optimizer(OptimConfig(**OPTIM[name]))
    loss_fn = make_caat_loss_fn(model, caat_t.CAAT)
    if loss_wrap is not None:
        loss_fn = loss_wrap(loss_fn)
    state = TrainState.create(model, opt, flat_optimizer=flat)
    return model, state, make_train_step(loss_fn, opt)


def _train(name, flat):
    model, state, step = _port(name, flat)
    gen = torch.Generator().manual_seed(0)
    logs = []
    for seed in range(UPDATES):
        state, lg = step(state, caat_t.to_torch(caat_t.make_batch(seed)),
                         gen)
        logs.append({k: float(v) for k, v in lg.items()})
    return model, state, logs


def test_parameters_and_gradients_are_views_of_two_padded_vectors():
    model, state, step = _port("adam", True)
    flat = state.flat
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    assert flat.size == n and flat.param.numel() == flat.grad.numel()
    assert flat.param.numel() % FLAT_MULTIPLE == 0
    assert flat.param.numel() - n < FLAT_MULTIPLE
    assert len(state.opt_state.mu) == 1
    assert state.opt_state.mu[0].shape == flat.param.shape
    state, _ = step(state, caat_t.to_torch(caat_t.make_batch()),
                    torch.Generator().manual_seed(0))
    off = 0
    for p in params:
        k = p.numel()
        assert p.data_ptr() == flat.param[off:].data_ptr()
        assert p.grad.data_ptr() == flat.grad[off:].data_ptr()
        assert torch.equal(p.detach().reshape(-1), flat.param[off:off + k])
        off += k
    assert not flat.param[n:].any() and not flat.grad[n:].any()
    assert float(flat.grad.abs().sum()) > 0


def test_flat_adam_equals_the_tree_update():
    tree, _, tlogs = _train("adam", False)
    flat, _, flogs = _train("adam", True)
    for a, b in zip(flogs, tlogs):
        assert a["skipped"] == b["skipped"] == 0.0
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=1e-5)
    assert flogs[0]["grad_norm"] > OPTIM["adam"]["clip_norm"]
    want = dict(tree.named_parameters())
    for name, p in flat.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), rtol=2e-5,
                                   atol=2e-7, err_msg=name)


@pytest.mark.parametrize("name", sorted(OPTIM))
def test_flat_step_matches_the_jax_flat_step(name):
    """The whole step against JAX ``make_train_step(flat_optimizer=True)``:
    losses and grad norms; Adam's parameters too.  Adafactor scales each
    update to the parameters' RMS whatever the gradient's size, so the
    k-projection biases, whose true gradient is 0, take a step of rounding
    noise that differs between the packages: its parameters are held
    update by update on the same gradients below."""
    model_j, params = jax_caat(caat_t.W2V, caat_t.CAAT)
    jopt = jax_build_optimizer(JaxOptimConfig(**OPTIM[name]))
    jstep = jax.jit(jax_make_train_step(
        jax_recipes.make_caat_loss_fn(model_j, caat_t.CAAT), jopt,
        flat_optimizer=True))
    jstate = JaxTrainState.create(params, jopt, flat_optimizer=True)
    model, state, logs = _train(name, True)
    for seed, lg in enumerate(logs):
        jstate, jlogs = jstep(jstate, caat_t.to_jax(caat_t.make_batch(seed)),
                              caat_t.JAX_RNG)
        for k in ("loss_total", "grad_norm", "skipped"):
            np.testing.assert_allclose(lg[k], float(jlogs[k]), rtol=1e-5,
                                       err_msg=k)
    if name == "adam":
        want = caat_state_dict_from_jax(jax.device_get(jstate.params))
        for pname, p in model.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), want[pname].numpy(), rtol=0,
                atol=1e-2 * OPTIM[name]["lr"], err_msg=pname)
    else:                      # unfactored: one moment of the whole vector
        (v,) = state.opt_state.v
        assert v.shape == state.flat.param.shape
        assert [t.shape for t in state.opt_state.v_row] == [(1,)]
        assert tuple(v.shape) in [tuple(leaf.shape) for leaf in
                                  jax.tree_util.tree_leaves(jstate.opt_state)]


@pytest.mark.parametrize("name", sorted(OPTIM))
def test_flat_update_equals_the_jax_flat_optimizer(name):
    """Each update of the port's flat vector against the JAX package's
    flat path on the same vector and gradient (``optimizer.update(flat_g,
    opt_state, flat_p)``, then ``flat_p + updates``)."""
    import jax.numpy as jnp

    model, state, step = _port(name, True)
    seen = []
    real = state.optimizer.update

    def update(params, grads, ostate, gnorm, shards=None):
        before = (params[0].clone(), grads[0].clone())
        real(params, grads, ostate, gnorm, shards)
        seen.append(before + (params[0].clone(),))

    state.optimizer.update = update
    gen = torch.Generator().manual_seed(0)
    for seed in range(UPDATES):
        state, _ = step(state, caat_t.to_torch(caat_t.make_batch(seed)), gen)
    jopt = jax_build_optimizer(JaxOptimConfig(**OPTIM[name]))
    jst = jopt.init(jnp.asarray(seen[0][0].numpy()))
    assert len(seen) == UPDATES
    for p, g, new in seen:
        upd, jst = jopt.update(jnp.asarray(g.numpy()), jst,
                               jnp.asarray(p.numpy()))
        np.testing.assert_allclose(new.numpy(), np.asarray(
            jnp.asarray(p.numpy()) + upd), rtol=2e-5, atol=2e-7)


def test_flat_adafactor_equals_adafactor_over_the_raveled_vector():
    """The tree optimizer over one parameter, the vector raveled and
    padded each update as the JAX package's ``ravel_padded`` does: the
    same updates as the flat views."""
    model, state, _ = _train("adafactor", True)
    ref = port_caat(jax_caat(caat_t.W2V, caat_t.CAAT)[1], caat_t.W2V,
                    caat_t.CAAT)
    loss_fn = make_caat_loss_fn(ref, caat_t.CAAT)
    opt = Adafactor(OptimConfig(**OPTIM["adafactor"]))
    params = list(ref.parameters())
    n = sum(p.numel() for p in params)
    pad = (-n) % FLAT_MULTIPLE
    ostate = opt.init([torch.zeros(n + pad)])
    gen = torch.Generator().manual_seed(0)
    for seed in range(UPDATES):
        for p in params:
            p.grad = None
        loss, count, _ = loss_fn(caat_t.to_torch(caat_t.make_batch(seed)),
                                 gen, seed)
        loss.backward()
        with torch.no_grad():
            vec = torch.cat([p.reshape(-1) for p in params]
                            + [torch.zeros(pad)])
            g = torch.cat([(p.grad if p.grad is not None
                            else torch.zeros_like(p)).reshape(-1)
                           for p in params] + [torch.zeros(pad)])
            g /= max(float(count), 1.0)
            opt.update([vec], [g], ostate, torch.linalg.vector_norm(g))
            off = 0
            for p in params:
                p.copy_(vec[off:off + p.numel()].view_as(p))
                off += p.numel()
    assert ostate.count == state.opt_state.count == UPDATES
    torch.testing.assert_close(state.opt_state.v[0], ostate.v[0],
                               rtol=2e-5, atol=0)
    want = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), rtol=2e-5,
                                   atol=2e-7, err_msg=name)


def test_flat_skips_a_nonfinite_update():
    poison = [False]

    def wrap(loss_fn):
        def maybe_nan(batch, gen, step):
            loss, n, logs = loss_fn(batch, gen, step)
            return (loss * float("nan") if poison[0] else loss), n, logs
        return maybe_nan

    model, state, step = _port("adam", True, wrap)
    gen = torch.Generator().manual_seed(0)
    batch = caat_t.to_torch(caat_t.make_batch())
    for _ in range(2):
        state, logs = step(state, batch, gen)
        assert logs["skipped"].item() == 0.0
    before = state.flat.param.clone()
    moments = [t.clone() for t in state.opt_state.mu + state.opt_state.nu]
    poison[0] = True
    state, logs = step(state, batch, gen)
    assert logs["skipped"].item() == 1.0
    assert not np.isfinite(logs["grad_norm"].item())
    assert state.step == 3 and state.opt_state.count == 2
    assert torch.equal(state.flat.param, before)
    assert all(torch.equal(a, b) for a, b in zip(
        moments, state.opt_state.mu + state.opt_state.nu))
    poison[0] = False
    state, logs = step(state, batch, gen)
    assert logs["skipped"].item() == 0.0 and state.opt_state.count == 3
    assert not torch.equal(state.flat.param, before)


def test_cli_flat_resume_equals_an_uninterrupted_run(corpus, capsys):  # noqa: F811
    extra = {"run.flat_optimizer": "true", "run.update_freq": 1,
             "model.dropout": 0.1, "caat.dropout": 0.1}
    cli.main(_overrides(corpus, "whole", **extra))
    cli.main(_overrides(corpus, "parts", **dict(extra,
                                                **{"run.max_update": 2})))
    cli.main(_overrides(corpus, "parts", **extra))        # resumes at 2
    capsys.readouterr()
    want, _ = _final_params(corpus, "whole")
    got, _ = _final_params(corpus, "parts")
    assert got["step"] == want["step"] == 4 and got["opt"]["flat"]
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for name in ("mu", "nu"):
        (a,), (b,) = got["opt"][name], want["opt"][name]
        assert torch.equal(a, b)


@pytest.mark.parametrize("saved,resumed", [(False, True), (True, False)],
                         ids=["tree-under-flat", "flat-under-tree"])
def test_cli_refuses_a_checkpoint_of_the_other_kind(corpus, capsys,  # noqa: F811
                                                    saved, resumed):
    def flag(v):
        return {"run.flat_optimizer": str(v).lower(), "run.max_update": 2}

    cli.main(_overrides(corpus, "ck", **flag(saved)))
    capsys.readouterr()
    with pytest.raises(ValueError, match=(
            f"saved under run.flat_optimizer={str(saved).lower()}, this run "
            f"has run.flat_optimizer={str(resumed).lower()}")):
        cli.main(_overrides(corpus, "ck", **dict(flag(resumed), **{
            "run.max_update": 4})))
