"""Chunk attention: the port's plain twin against the JAX package.

The JAX ``chunk_cache_attention`` runs its Pallas kernel in interpret mode
off the TPU (ops/chunk_attention.py:76); the JAX einsum two-part softmax of
stream/incremental.py:231-256 is transcribed below.  Same seeded numpy
inputs, float32, atol 1e-5 (the three differ only in summation order).
The CUDA kernel itself is held against the twin in
tests/test_torch_port_gpu.py and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec_s_tpu.ops.chunk_attention import (
    chunk_cache_attention as jax_chunk_attention)
from wav2vec_s_tpu_torch.ops.chunk_attention import (
    chunk_cache_attention, chunk_cache_attention_ref)
from wav2vec_s_tpu_torch.stream.incremental import chunk_layout

B, H, DH, KV_CAP = 2, 4, 4, 20
D = H * DH
# R = 6: mc=2, rc=1, 2 blocks; R = 12: mc=4, rc=2, 2 blocks
LAYOUTS = {6: (2, 1, 2), 12: (4, 2, 2)}


def _inputs(R, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q = n(B, R, D) * DH ** -0.5
    _, bias = chunk_layout(*LAYOUTS[R])
    return q, n(KV_CAP, B, D), n(KV_CAP, B, D), n(B, R, D), n(B, R, D), bias


def _jax_einsum_path(q, kc, vc, kn, vn, bias, t0):
    """stream/incremental.py:231-256 (the non-fused branch), verbatim."""
    Bq, R, _ = q.shape
    T = kc.shape[0]

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], H, DH).transpose(0, 2, 1, 3)

    qh = split(q)
    kc4, vc4 = kc.reshape(T, Bq, H, DH), vc.reshape(T, Bq, H, DH)
    bias_c4 = jnp.where(jnp.arange(T)[None, :] < t0, 0.0, -1e4)[None, None]
    lg_cache = jnp.einsum("bhqd,tbhd->bhqt", qh, kc4,
                          preferred_element_type=jnp.float32) + bias_c4
    lg_intra = jnp.einsum("bhqd,bhkd->bhqk", qh, split(kn),
                          preferred_element_type=jnp.float32) + bias[None,
                                                                     None]
    m = jnp.maximum(lg_cache.max(-1, keepdims=True),
                    lg_intra.max(-1, keepdims=True))
    e1 = jnp.exp(lg_cache - m)
    e2 = jnp.exp(lg_intra - m)
    inv = 1.0 / (e1.sum(-1, keepdims=True) + e2.sum(-1, keepdims=True))
    o = (jnp.einsum("bhqt,tbhd->bhqd", e1 * inv, vc4)
         + jnp.einsum("bhqk,bhkd->bhqd", e2 * inv, split(vn)))
    return o.transpose(0, 2, 1, 3).reshape(Bq, R, D)


@pytest.mark.parametrize("t0", [0, KV_CAP // 2 + 1, KV_CAP])
@pytest.mark.parametrize("R", sorted(LAYOUTS))
def test_twin_matches_jax(R, t0):
    args = _inputs(R, seed=R + t0)
    got = chunk_cache_attention(*map(torch.from_numpy, args), t0, H).numpy()
    pallas = np.asarray(jax_chunk_attention(*map(jnp.asarray, args), t0, H))
    einsum = np.asarray(_jax_einsum_path(*map(jnp.asarray, args), t0))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, einsum, atol=1e-5, rtol=0)


def test_cpu_tensors_run_the_twin():
    args = [torch.from_numpy(a) for a in _inputs(12)]
    chunk_cache_attention.launches = 0
    out = chunk_cache_attention(*args, 7, H)
    assert chunk_cache_attention.launches == 0
    assert torch.equal(out, chunk_cache_attention_ref(*args, 7, H))


def test_cache_rows_past_t0_are_invisible():
    q, kc, vc, kn, vn, bias = [torch.from_numpy(a) for a in _inputs(6)]
    t0 = 9
    want = chunk_cache_attention(q, kc, vc, kn, vn, bias, t0, H)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[t0:] = 1e3                       # uncommitted rows hold anything
    vc2[t0:] = -1e3
    for cap in (t0, t0 + 3, KV_CAP):     # and the cache view may end anywhere
        got = chunk_cache_attention(q, kc2[:cap], vc2[:cap], kn, vn, bias,
                                    t0, H)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def _bad(case):
    q, kc, vc, kn, vn, bias = [torch.from_numpy(a) for a in _inputs(6)]
    t0, heads = 3, H
    if case == "k_new_shape":
        kn = kn[:, :5]
    elif case == "cache_batch":
        kc = kc[:, :1]
    elif case == "v_cache_shape":
        vc = vc[:5]
    elif case == "bias_dtype":
        bias = bias.double()
    elif case == "t0_past_cache":
        t0 = KV_CAP + 1
    elif case == "mixed_dtype":
        kc = kc.bfloat16()
    elif case == "int_dtype":
        q, kc, vc, kn, vn = (t.int() for t in (q, kc, vc, kn, vn))
    elif case == "heads":
        heads = 3
    elif case == "meta_device":
        q, kc, vc, kn, vn, bias = (t.to("meta")
                                   for t in (q, kc, vc, kn, vn, bias))
    return q, kc, vc, kn, vn, bias, t0, heads


@pytest.mark.parametrize("case", [
    "k_new_shape", "cache_batch", "v_cache_shape", "bias_dtype",
    "t0_past_cache", "mixed_dtype", "int_dtype", "heads", "meta_device"])
def test_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        chunk_cache_attention(*_bad(case))
