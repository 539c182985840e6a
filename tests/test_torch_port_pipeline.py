"""The GPipe combinator of the port (``wav2vec_s_tpu_torch/parallel/
pipeline.py``) on 2 and 4 CPU ranks over gloo, against ``apply_stacked``
in one process and the JAX package's ``apply_stacked`` and
``pipeline_apply`` (``tests/test_pipeline.py`` gives the layers and the
shapes; the JAX pipeline runs on the 8-device virtual CPU mesh of
``tests/conftest.py``).

``ring_shift`` sends stage s's tensor to stage s + 1 and its gradient
back.  Every scenario's loss and the gradient of every stacked leaf, summed over
the ranks (each stage holds its own layers' gradients, each data rank its
rows'), must equal the one-process ones; the port's encoder layer stack
(``TransformerEncoderLayer`` through the flash path's twin) runs the same
way.  Tolerances: loss rtol 1e-6, gradients atol 1e-5 rtol 1e-4 (the JAX
test's); against JAX, atol 1e-5 rtol 1e-4 on outputs and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_parallel_worker as worker
from wav2vec_s_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wav2vec_s_tpu.parallel.pipeline import apply_stacked as jax_apply
from wav2vec_s_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from wav2vec_s_tpu_torch.parallel.pipeline import (
    apply_stacked, stack_layer_params)

torch.set_num_threads(1)

MLP = {"w1": (16, 32), "b1": (32,), "w2": (32, 16)}
D = 8
ATTN = {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D),
        "w1": (D, 16), "w2": (16, D)}
#: (layer, L, pipe, data, microbatches, x shape)
CASES = {
    "mlp_p2_d1_m2": ("mlp", 4, 2, 1, 2, (16, 16)),
    "mlp_p2_d2_m4": ("mlp", 4, 2, 2, 4, (16, 16)),
    "mlp_p4_d1_m8": ("mlp", 4, 4, 1, 8, (16, 16)),
    "attn_p2_d1_m8": ("attn", 4, 2, 1, 8, (8, 6, D)),
    "attn_p2_d2_m4": ("attn", 4, 2, 2, 4, (8, 6, D)),
    "attn_p4_d1_m4": ("attn", 4, 4, 1, 4, (8, 6, D)),
    "encoder_p2_d1_m4": ("encoder", 4, 2, 1, 4, None),
    "encoder_p2_d2_m2": ("encoder", 4, 2, 2, 2, None),
}
#: the encoder stack: (dim, ffn, heads, frames, mc, rc); S = 24 rows
ENCODER = (32, 64, 4, 16, 8, 4)


def _stacked(seed, L, shapes):
    """``tests/test_pipeline.py`` ``_stacked``: layer i from seed + i."""
    layers = []
    for i in range(L):
        r = np.random.default_rng(seed + i)
        layers.append({k: torch.from_numpy(
            (r.standard_normal(s) * 0.2).astype(np.float32))
            for k, s in shapes.items()})
    return stack_layer_params(layers)


def _encoder_stacked(L):
    from wav2vec_s_tpu_torch.models.modules import (
        TransformerEncoderLayer, random_init_)

    g = torch.Generator().manual_seed(5)
    dim, ffn, heads = ENCODER[:3]
    layers = [random_init_(TransformerEncoderLayer(dim, ffn, heads), g)
              for _ in range(L)]
    for m in layers:          # nonzero biases and norms
        with torch.no_grad():
            for p in m.parameters():
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return stack_layer_params(layers)


def scenario(name):
    layer, L, pipe, data, micro, shape = CASES[name]
    if layer == "encoder":
        from wav2vec_s_tpu_torch.ops.block_mask import block_layout
        S = block_layout(*ENCODER[3:]).total_len
        shape = (8, S, ENCODER[0])
    stacked = (_stacked(0, L, MLP) if layer == "mlp" else
               _stacked(3, L, ATTN) if layer == "attn" else
               _encoder_stacked(L))
    r = np.random.default_rng(9)
    return dict(layer=layer, pipe=pipe, data=data, micro=micro,
                encoder=ENCODER,
                stacked={k: v.detach() for k, v in stacked.items()},
                x=torch.from_numpy(r.standard_normal(shape).astype(
                    np.float32)),
                target=torch.from_numpy(r.standard_normal(shape).astype(
                    np.float32)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on its spawned ranks (one job per world size)."""
    work = str(tmp_path_factory.mktemp("pipe"))
    got = {}
    for world in (2, 4):
        jobs = {n: scenario(n) for n, c in CASES.items()
                if c[2] * c[3] == world}
        jobs[f"ring{world}"] = dict(layer="ring", data=1, pipe=world)
        got.update(worker.run_pipeline_job(jobs, work, world))
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_equals_apply_stacked(runs, name):
    sc = scenario(name)
    want_loss, want = worker.pipeline_loss(sc)
    loss, grads = runs[name]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert grads.keys() == want.keys()
    for k, g in want.items():
        torch.testing.assert_close(grads[k], g, atol=1e-5, rtol=1e-4,
                                   msg=k)


def _jax_layer(layer):
    from tests.test_pipeline import _attn_layer, _mlp_layer
    return _mlp_layer if layer == "mlp" else _attn_layer


@pytest.mark.parametrize("name", ["mlp_p4_d1_m8", "mlp_p2_d2_m4",
                                  "attn_p2_d2_m4", "attn_p4_d1_m4"])
def test_pipeline_equals_jax(runs, name):
    """The port's pipelined loss and gradients equal the JAX package's
    ``apply_stacked`` and ``pipeline_apply`` (8-device mesh: data x model
    x pipe) on the same stacked weights."""
    sc = scenario(name)
    fn = _jax_layer(sc["layer"])
    stacked = {k: jnp.asarray(v.numpy()) for k, v in sc["stacked"].items()}
    x, tgt = jnp.asarray(sc["x"].numpy()), jnp.asarray(sc["target"].numpy())
    mesh = jax_make_mesh(n_data=sc["data"],
                         n_model=8 // (sc["pipe"] * sc["data"]),
                         n_pipe=sc["pipe"], devices=jax.devices()[:8])

    def loss_seq(p):
        return jnp.mean((jax_apply(fn, p, x) - tgt) ** 2)

    def loss_pipe(p):
        return jnp.mean((jax_pipeline(fn, p, x, mesh, sc["micro"])
                         - tgt) ** 2)

    loss, grads = runs[name]
    for f in (loss_seq, jax.jit(loss_pipe)):
        l_j, g_j = jax.value_and_grad(f)(stacked)
        np.testing.assert_allclose(float(loss), float(l_j), rtol=1e-5)
        for k, g in g_j.items():
            np.testing.assert_allclose(grads[k].numpy(), np.asarray(g),
                                       atol=1e-5, rtol=1e-4, err_msg=k)


def test_single_stage_is_apply_stacked():
    """P = 1 in one process: the oracle itself, and the stacked layers
    keep their order."""
    sc = scenario("mlp_p2_d1_m2")
    out = apply_stacked(worker.mlp_layer, sc["stacked"], sc["x"])
    h = sc["x"]
    for i in range(4):
        h = worker.mlp_layer({k: v[i] for k, v in sc["stacked"].items()}, h)
    torch.testing.assert_close(out, h, rtol=0, atol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_shift_forward_and_backward(runs, world):
    got = runs[f"ring{world}"]            # [stage, (received, grad), 3]
    for s in range(world):
        prev = (s - 1) % world
        torch.testing.assert_close(got[s, 0], torch.arange(3.0) + prev)
        # x of stage s feeds stage s + 1's loss, weighted s + 2
        torch.testing.assert_close(got[s, 1],
                                   torch.full((3,), float((s + 1) % world
                                                          + 1)))
