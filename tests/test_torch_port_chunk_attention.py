"""Chunk attention: the port's plain twin against the JAX package.

The JAX ``chunk_cache_attention`` runs its Pallas kernel in interpret mode
off the TPU (ops/chunk_attention.py:76); the JAX einsum two-part softmax of
stream/incremental.py:231-256 is transcribed below.  Same seeded numpy
inputs, float32, atol 1e-5 (the three differ only in summation order).
The CUDA kernels themselves are held against the twin in
tests/test_torch_port_gpu.py and by chip_smoke.py; here, which of the two a
call takes, the alignment the tensor-core one needs, and a plain model of
its bfloat16 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec_s_tpu.ops.chunk_attention import (
    chunk_cache_attention as jax_chunk_attention)
from wav2vec_s_tpu_torch.ops import chunk_attention as ca
from wav2vec_s_tpu_torch.ops.chunk_attention import (
    CUDA_CORE, TENSOR_CORE, chunk_cache_attention, chunk_cache_attention_ref,
    kernel_path)
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


@pytest.mark.parametrize("grad_input", [0, 1, 3])     # q, a cache, k_new
def test_refuses_autograd_runs_under_no_grad(grad_input):
    """An inference kernel under grad mode with an input that requires grad
    raises, on every device, instead of returning a tensor that lost its
    gradient; under torch.no_grad() it runs."""
    args = [torch.from_numpy(a) for a in _inputs(6)]
    args[grad_input].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        chunk_cache_attention(*args, 5, H)
    with torch.no_grad():
        out = chunk_cache_attention(*args, 5, H)
    assert not out.requires_grad
    assert torch.equal(out, chunk_cache_attention_ref(
        *(a.detach() for a in args), 5, H))


def test_kernel_path_follows_dtype_and_head_width_alone():
    """bfloat16 at the head widths the tensor-core kernel is instantiated
    for takes it; float32 and every other width take the CUDA-core kernel.
    The full-width models land on the first, the tiny parity models (float32,
    heads of 6-8) on the second."""
    from wav2vec_s_tpu_torch.models import (
        Wav2Vec2Config, wav2vec_s_base_config)

    for dh in (32, 64, 128):
        assert kernel_path(torch.bfloat16, dh) == TENSOR_CORE
        assert kernel_path(torch.float32, dh) == CUDA_CORE
    for dh in (4, 6, 8, 16, 48, 96, 256):
        assert kernel_path(torch.bfloat16, dh) == CUDA_CORE
    assert kernel_path(torch.float16, 64) == CUDA_CORE
    assert set(chunk_cache_attention.path_launches) == {TENSOR_CORE,
                                                        CUDA_CORE}

    base = wav2vec_s_base_config(dtype="bfloat16")
    assert kernel_path(base.compute_dtype, base.encoder_embed_dim
                       // base.encoder_attention_heads) == TENSOR_CORE
    assert kernel_path(torch.bfloat16, 1024 // 16) == TENSOR_CORE   # Large
    for dim, heads in ((24, 4), (32, 4)):
        tiny = Wav2Vec2Config(encoder_embed_dim=dim,
                              encoder_attention_heads=heads)
        assert kernel_path(tiny.compute_dtype, tiny.encoder_embed_dim
                           // tiny.encoder_attention_heads) == CUDA_CORE


def _aligned_and_off(*shape):
    n = int(np.prod(shape))
    flat = torch.zeros(n + 8, dtype=torch.bfloat16)
    ok, off = flat[:n].view(*shape), flat[1:n + 1].view(*shape)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    return ok, off


@pytest.mark.parametrize("which", range(5))      # q, caches, k_new, v_new
def test_tensor_core_path_refuses_misaligned_tensors(which):
    """Its 16-byte copies need 16-byte aligned tensors; the check runs on
    the arguments before any device work, and the CUDA-core path takes any
    alignment."""
    R, heads, width = 6, 2, 64
    shapes = [(1, R, width), (8, 1, width), (8, 1, width), (1, R, width),
              (1, R, width)]
    pairs = [_aligned_and_off(*s) for s in shapes]
    ok = [p[0] for p in pairs]
    assert ca._path_of(ok[0], heads, ok) == TENSOR_CORE
    bad = list(ok)
    bad[which] = pairs[which][1]
    with pytest.raises(ValueError, match="16-byte aligned"):
        ca._path_of(bad[0], heads, bad)
    assert ca._path_of(bad[0], 8, bad) == CUDA_CORE            # heads of 8
    assert ca._path_of(bad[0].float(), heads, bad) == CUDA_CORE


def _bf16(t):
    return t.bfloat16().float()


@pytest.mark.parametrize("t0", [0, 65, 480])
def test_bf16_rounding_model_stays_within_the_card_tolerance(t0):
    """A plain model of the tensor-core kernel's arithmetic: q/k/v in
    bfloat16, float32 logits, an online softmax over the chunk's own keys
    first and then 64-key tiles of the cache, the UNNORMALISED probabilities
    rounded to bfloat16 before P.V (the twin rounds the normalised ones),
    float32 accumulation, one division at the end.  At the main path's chunk
    and head width (R 48, dh 64) it stays within what the card tests and
    chip_smoke.py allow bfloat16 against the twin: 2e-2 max abs."""
    Bm, R, Hm, dh, cap = 2, 48, 2, 64, 512
    rng = np.random.default_rng(t0)

    def n(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).bfloat16()

    q, kc, vc = n(Bm, R, Hm * dh) * dh ** -0.5, n(cap, Bm, Hm * dh), n(
        cap, Bm, Hm * dh)
    kn, vn = n(Bm, R, Hm * dh), n(Bm, R, Hm * dh)
    bias = torch.from_numpy(chunk_layout(16, 8, 2)[1])
    assert bias.shape == (R, R)
    want = chunk_cache_attention_ref(q, kc, vc, kn, vn, bias, t0, Hm)

    def split(t):                                  # [B, T, D] -> [B, H, T, dh]
        return t.reshape(Bm, -1, Hm, dh).transpose(1, 2).float()

    qh = split(q)
    tiles = [(split(kn), split(vn), bias)]
    for j0 in range(0, t0, 64):
        j1 = min(j0 + 64, t0)
        tiles.append((split(kc[j0:j1].transpose(0, 1)),
                      split(vc[j0:j1].transpose(0, 1)), 0.0))
    m = torch.full((Bm, Hm, R, 1), -torch.inf)
    l = torch.zeros((Bm, Hm, R, 1))
    o = torch.zeros((Bm, Hm, R, dh))
    for kh, vh, b in tiles:
        s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) + b
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", _bf16(p), vh)
        m = m_new
    got = (o / l.clamp(min=1e-20)).bfloat16().transpose(1, 2).reshape(
        Bm, R, Hm * dh)

    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2, err
    assert err > 0                                  # the model does round
