"""The Gumbel vector quantizer of the torch port against the JAX package.

- ``GumbelVectorQuantizer`` alone on [2, 7, 12] inputs, 2 groups of 5
  codes: output, perplexities, hard and selected codes in eval mode, and in
  train mode with the JAX draw site planted with the same uniforms; the
  straight-through gradients of ``sum(out * w)`` against ``jax.grad``
  (rtol 1e-5);
- ``gumbel_temperature`` in float32, as the JAX package computes it, at
  0, 1000, 100000 and 400000 updates (float64 would differ by more than
  the tolerance in between).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_pretrain import JAX_RNG, plant_uniform
from wav2vec_s_tpu.models import quantizer as jax_quantizer
from wav2vec_s_tpu_torch.models import quantizer as port_quantizer


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_quantizer_matches_jax_with_straight_through_gradients(
        train, monkeypatch):
    """The quantizer alone, on [2, 7, 12] inputs, 2 groups of 5 codes: the
    output, perplexities, codes; in train mode with the same uniforms, and
    the straight-through gradients of sum(out * w) against ``jax.grad``."""
    G, V, D = 2, 5, 8
    jq = jax_quantizer.GumbelVectorQuantizer(input_dim=12, num_vars=V,
                                             groups=G, vq_dim=D)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((2, 7, D)).astype(np.float32)
    u = rng.uniform(1e-10, 1.0, (14, G, V)).astype(np.float32)
    params = jq.init({"params": JAX_RNG, "gumbel": JAX_RNG}, jnp.asarray(x),
                     1.5, train=False)["params"]
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)

    plant_uniform(monkeypatch, u)

    def jax_fn(p, xx):
        o = jq.apply({"params": p}, xx, jnp.float32(1.5), train=train,
                     rngs={"gumbel": JAX_RNG})
        return jnp.sum(o["x"] * w), o

    (_, want), (gp, gx) = jax.value_and_grad(jax_fn, argnums=(0, 1),
                                             has_aux=True)(params,
                                                           jnp.asarray(x))
    q = port_quantizer.GumbelVectorQuantizer(12, V, G, D)
    with torch.no_grad():
        q.vars.copy_(torch.from_numpy(np.asarray(params["vars"])))
        q.weight_proj.weight.copy_(torch.from_numpy(
            np.asarray(params["weight_proj"]["kernel"]).T))
        q.weight_proj.bias.copy_(torch.from_numpy(
            np.asarray(params["weight_proj"]["bias"])))

    class Ctx:
        def uniform(self, shape):
            assert tuple(shape) == u.shape
            return torch.from_numpy(u)

    xt = torch.from_numpy(x).requires_grad_(True)
    got = q(xt, torch.tensor(1.5), Ctx() if train else None)
    (got["x"] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got["x"].detach().numpy(),
                               np.asarray(want["x"]), rtol=1e-5, atol=1e-6)
    for k in ("code_perplexity", "prob_perplexity"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    for k in ("targets", "sel_codes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # eval mode: the hard codes carry no gradient to x or weight_proj
    for got_g, want_g in ((xt.grad, gx), (q.vars.grad, gp["vars"]),
                          (q.weight_proj.weight.grad,
                           np.asarray(gp["weight_proj"]["kernel"]).T)):
        want_g = np.asarray(want_g)
        assert (got_g is None) == (not train and not want_g.any())
        got_g = np.zeros_like(want_g) if got_g is None else got_g.numpy()
        np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [0, 1000, 100000, 400000])
def test_gumbel_temperature_is_float32(n):
    want = float(jnp.maximum(2.0 * 0.999995 ** jnp.asarray(n, jnp.float32),
                             0.5))
    got = port_quantizer.gumbel_temperature(n, 2.0, 0.5, 0.999995)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if 0 < n < 250000:       # float64 would be off by more than that
        assert abs(2.0 * 0.999995 ** n - want) > 1e-6 * want
