"""Adafactor in the torch port against ``optax.adafactor`` (the JAX
package's ``optim.optimizer=adafactor``).

- three updates of ``Adafactor`` equal three of the JAX builder's
  ``optax.adafactor(learning_rate=sched)`` within 1e-6 on factored
  parameters (two dims of at least 128, 2-D either way round, 3-D, square)
  and unfactored ones (a vector, a small matrix, a parameter at zero whose
  RMS is below 1e-3); ``clip_norm`` and ``weight_decay`` are given and
  ignored by both, as the JAX builder returns the adafactor chain early;
- the torch layout of a weight ([out, in]) takes the update of the JAX
  kernel ([in, out]);
- through ``make_train_step``, a skipped non-finite step leaves the
  moments untouched, and the state survives ``checkpoint/io.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec_s_tpu.train.optim import OptimConfig as JaxOptimConfig
from wav2vec_s_tpu.train.optim import build_optimizer as jax_build_optimizer
from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
from wav2vec_s_tpu_torch.train.optim import (
    Adafactor, AdafactorState, OptimConfig, build_optimizer, factored_dims)
from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

SHAPES = {"factored": (130, 200), "factored_t": (200, 130),
          "factored_3d": (3, 128, 129), "square": (128, 128),
          "vector": (64,), "small": (10, 5), "zero": (4, 6)}
KW = dict(optimizer="adafactor", lr=1e-2, lr_scheduler="inverse_sqrt",
          warmup_updates=2, warmup_init_lr=1e-3, clip_norm=0.5,
          weight_decay=0.1)


def test_factored_dims_follow_optax():
    from optax._src.factorized import _factored_dims

    for shape in list(SHAPES.values()) + [(512, 512, 3), (512, 1, 10),
                                          (3, 512, 512), (127, 300)]:
        assert factored_dims(shape) == _factored_dims(shape, True, 128)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_three_updates_match_optax(name):
    shape = SHAPES[name]
    rng = np.random.default_rng(0)
    p0 = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    if name == "zero":
        p0[:] = 0.0
    grads = [rng.standard_normal(shape).astype(np.float32) * s
             for s in (1.0, 0.01, 3.0)]
    tx = jax_build_optimizer(JaxOptimConfig(**KW))
    jp = {"w": jnp.asarray(p0)}
    jstate = tx.init(jp)
    opt = build_optimizer(OptimConfig(**KW))
    assert isinstance(opt, Adafactor)
    p = torch.from_numpy(p0.copy())
    state = opt.init([p])
    for g in grads:
        upd, jstate = tx.update({"w": jnp.asarray(g)}, jstate, jp)
        jp = {"w": jp["w"] + upd["w"]}
        opt.update([p], [torch.from_numpy(g)], state, torch.tensor(1.0))
        np.testing.assert_allclose(p.numpy(), np.asarray(jp["w"]), rtol=1e-6,
                                   atol=1e-6 * np.abs(p0).max() + 1e-9)
    assert state.count == 3
    if factored_dims(shape) is not None:
        assert state.v[0].shape == (1,) and state.v_row[0].numel() > 1
    else:
        assert state.v[0].shape == shape and state.v_row[0].shape == (1,)


def test_torch_layout_takes_the_kernel_update():
    rng = np.random.default_rng(1)
    kernel = (rng.standard_normal((130, 200)) * 0.05).astype(np.float32)
    grads = [rng.standard_normal((130, 200)).astype(np.float32)
             for _ in range(3)]
    opt = build_optimizer(OptimConfig(**KW))
    a, b = torch.from_numpy(kernel.copy()), torch.from_numpy(
        kernel.T.copy())
    sa, sb = opt.init([a]), opt.init([b])
    for g in grads:
        opt.update([a], [torch.from_numpy(g)], sa, None)
        opt.update([b], [torch.from_numpy(g.T.copy())], sb, None)
    np.testing.assert_allclose(b.numpy().T, a.numpy(), rtol=1e-6, atol=1e-9)


def test_adafactor_through_the_step_and_a_checkpoint(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(130, 140),
                                torch.nn.Linear(140, 3))
    opt = build_optimizer(OptimConfig(**KW))
    state = TrainState.create(model, opt)
    assert isinstance(state.opt_state, AdafactorState)
    x = torch.randn(8, 130)
    poison = [False]

    def loss_fn(batch, gen, step):
        loss = model(batch["x"]).square().sum()
        return (loss * float("nan") if poison[0] else loss), 8, {}

    step = make_train_step(loss_fn, opt)
    for _ in range(2):
        state, logs = step(state, {"x": x}, None)
    moments = [t.clone() for t in state.opt_state.v_row + state.opt_state.v]
    poison[0] = True
    state, logs = step(state, {"x": x}, None)
    assert logs["skipped"].item() == 1.0 and state.opt_state.count == 2
    assert all(torch.equal(a, b) for a, b in zip(
        moments, state.opt_state.v_row + state.opt_state.v))
    mgr = CheckpointManager(tmp_path / "ck", keep_last=1)
    mgr.save(3, state)
    fresh = TrainState.create(
        torch.nn.Sequential(torch.nn.Linear(130, 140),
                            torch.nn.Linear(140, 3)), opt)
    mgr.restore(template=fresh)
    assert fresh.step == 3 and fresh.opt_state.count == 2
    for name in ("v_row", "v_col", "v"):
        for a, b in zip(getattr(fresh.opt_state, name),
                        getattr(state.opt_state, name)):
            assert torch.equal(a, b), name
    # an Adam checkpoint does not load into adafactor's state
    adam = TrainState.create(model, build_optimizer(OptimConfig()))
    mgr.save(4, adam)
    with pytest.raises(ValueError, match="v_row"):
        mgr.restore(template=fresh)
