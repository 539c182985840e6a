"""Block-sparse flash attention (K2 forward, K3 backward, in-kernel dropout)
and the block layout: the port against the JAX package.

- ``blockwise_flash_attention_ref`` (the twin the CUDA kernel is held
  against on the card) equals the JAX ``blockwise_flash_attention_packed``
  run as its Pallas kernel in interpret mode, and its row stats ``m``/``l``
  equal the kernel's (``_flash_attn_impl``), atol/rtol 2e-5 on valid rows,
  at the shapes of tests/test_pallas_attention.py (rc 0 included) with
  non-contiguous key padding;
- the tile-kind tables the kernels walk (32 x 64 tiles for the CUDA-core
  kernels, 64 x 64 for the tensor-core kernels, plain and transposed) cover
  the layout, and the layout rule the kernels evaluate in partial tiles
  (also in its interval form) equals ``allowed``;
- which kernel set a (dtype, head width) takes: bfloat16 at the models'
  widths the tensor cores, float32 and the tiny parity models the CUDA
  cores;
- a rounding model of the tensor-core kernels (probabilities and dS rounded
  to bfloat16 between the products) stays within the card's tolerances of
  the float32 twins, which is why those tolerances are what they are;
- the wrapper runs the twin on CPU tensors and rejects what the kernel
  does not take;
- the backward twin ``blockwise_flash_attention_bwd_ref`` (what the CUDA
  backward kernels are held against), reached through the wrapper's
  ``torch.autograd.Function``, equals torch autograd through the dense
  masked softmax and ``jax.grad`` through the JAX kernel in interpret mode,
  atol/rtol 3e-5 in f32 as tests/test_pallas_attention.py, with cotangents
  zero on padded rows;
- attention dropout: the flash twins equal the dense attention that drops
  the materialised probabilities through ``drop`` at the same site under
  one seed (forward and gradients, f32 rounding apart), the forward's mask
  is the backward's, the keep share is within 4 sigma, masks differ across
  batch slots, heads, seeds and offsets, the scaling preserves the mean
  and a rate near 1 empties rows (tests/test_flash_dropout.py);
- block layout, rc copies, padding extension, dense bias and the positions
  of the full-sequence encoder equal their JAX originals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec_s_tpu.ops import block_mask as jax_bm
from wav2vec_s_tpu.ops.pallas_attention import (
    TILE, _flash_attn_impl, _tile_plan)
from wav2vec_s_tpu.ops.pallas_attention import (
    blockwise_flash_attention_packed as jax_flash)
from wav2vec_s_tpu_torch.models.modules import dot_product_attention
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext, keep_mask
from wav2vec_s_tpu.utils.positional import (
    sinusoidal_positions_from_padding as jax_positions)
from wav2vec_s_tpu_torch.ops import block_mask as bm
from wav2vec_s_tpu_torch.ops import flash_attention as fa
from wav2vec_s_tpu_torch.ops import native
from wav2vec_s_tpu_torch.ops.flash_attention import (
    CUDA_CORE, NEG, TENSOR_CORE, TILES, blockwise_flash_attention_bwd,
    blockwise_flash_attention_bwd_ref, blockwise_flash_attention_packed,
    blockwise_flash_attention_ref, kernel_path, tile_kinds)
from wav2vec_s_tpu_torch.utils.positional import (
    sinusoidal_positions_from_padding)

# (T, mc, rc, B, H, dh): tests/test_pallas_attention.py
CASES = [(96, 16, 8, 2, 2, 32), (200, 16, 8, 1, 4, 64), (64, 8, 0, 2, 2, 64)]
# (T, mc, rc): the full-width one-shot call (ds2, 10 s), its rc 0 twin, the
# tiny decoder's layout, an odd length with a ragged last block
LAYOUTS = [(488, 16, 8), (488, 16, 0), (634, 4, 2), (97, 16, 8), (96, 16, 8)]


def _inputs(T, mc, rc, B, H, dh, seed=0):
    S = bm.block_layout(T, mc, rc).total_len
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H * dh)).astype(np.float32)
               for _ in range(3))
    # non-contiguous padding of the last stream: a frame tail AND the last
    # rc copies
    key_pad = np.zeros((B, S), bool)
    key_pad[-1, T - 10:T] = True
    key_pad[-1, S - 3:] = True
    return q, k, v, key_pad


def _twin(q, k, v, key_pad, H, T, mc, rc):
    return blockwise_flash_attention_ref(
        *map(torch.from_numpy, (q, k, v, key_pad)), H, T, mc, rc)


@pytest.mark.parametrize("T,mc,rc,B,H,dh", CASES)
def test_twin_matches_jax_kernel(T, mc, rc, B, H, dh):
    q, k, v, key_pad = _inputs(T, mc, rc, B, H, dh)
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v, key_pad)), H, T,
                                mc, rc, interpret=True))
    got = _twin(q, k, v, key_pad, H, T, mc, rc)[0].numpy()
    valid = ~key_pad
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("T,mc,rc,B,H,dh", CASES)
def test_row_stats_match_jax_kernel(T, mc, rc, B, H, dh):
    """m and l against the Pallas kernel's, called as the JAX wrapper calls
    it (per-head [B, H, s_pad, dh] blocks, padded to its 128-row tiling)."""
    q, k, v, key_pad = _inputs(T, mc, rc, B, H, dh, seed=1)
    S = key_pad.shape[1]
    s_pad = -(-S // TILE) * TILE

    def four(t):
        t = np.pad(t, ((0, 0), (0, s_pad - S), (0, 0)))
        return jnp.asarray(t.reshape(B, s_pad, H, dh).transpose(0, 2, 1, 3))

    valid_row = np.pad(np.where(key_pad, NEG, 0.0).astype(np.float32),
                       ((0, 0), (0, s_pad - S)), constant_values=NEG)
    plan = _tile_plan(bm.block_layout(T, mc, rc).allowed, s_pad)
    _, m_want, l_want = _flash_attn_impl(
        four(q), four(k), four(v), jnp.asarray(valid_row)[:, None, :],
        jnp.zeros((1,), jnp.int32), dh ** -0.5, plan, True, 0.0, dh)
    _, m, l = _twin(q, k, v, key_pad, H, T, mc, rc)
    rows = np.broadcast_to(~key_pad[:, None, :], (B, H, S))
    for got, want in ((m, m_want), (l, l_want)):
        want = np.asarray(want)[..., :S, 0]
        np.testing.assert_allclose(got.numpy()[rows], want[rows], atol=2e-5,
                                   rtol=2e-5)


# (rows per block, columns per tile): the CUDA-core and tensor-core kernels
TILE_SIZES = [(32, 64), (64, 64)]


def test_tile_sizes_are_the_two_kernel_sets():
    assert sorted(TILES.values()) == TILE_SIZES
    assert TILES[TENSOR_CORE] == (64, 64) and TILES[CUDA_CORE] == (32, 64)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("q_tile,k_tile", TILE_SIZES)
@pytest.mark.parametrize("T,mc,rc", LAYOUTS)
def test_tile_kinds_cover_the_layout(T, mc, rc, q_tile, k_tile, transposed):
    allowed = bm.block_layout(T, mc, rc).allowed
    if transposed:
        allowed = allowed.T
    S = allowed.shape[0]
    kinds = tile_kinds(T, mc, rc, q_tile, k_tile, transposed)
    assert kinds.shape == (-(-S // q_tile), -(-S // k_tile))
    assert kinds.dtype == np.int8
    for qi, ki in np.ndindex(*kinds.shape):
        tile = allowed[qi * q_tile:(qi + 1) * q_tile,
                       ki * k_tile:(ki + 1) * k_tile]
        want = 0 if not tile.any() else 1 if tile.all() else 2
        assert kinds[qi, ki] == want, (qi, ki)
    if q_tile == 32 or S > 4 * q_tile:        # the kernel skips something
        assert (kinds == 0).any()
    if q_tile == k_tile:
        np.testing.assert_array_equal(
            kinds, tile_kinds(T, mc, rc, k_tile, q_tile, not transposed).T)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("q_tile,k_tile", TILE_SIZES)
@pytest.mark.parametrize("T,mc,rc", LAYOUTS)
def test_kernel_layout_rule_equals_allowed(T, mc, rc, q_tile, k_tile,
                                           transposed):
    """The rule the kernels evaluate in partial tiles (csrc/flash_common.cuh
    ``pair_allowed``), its interval form in the tensor-core kernels
    (csrc/flash_mma.cuh ``key_rule``/``allowed``: one unsigned compare), and
    what the tile kinds promise about it: no allowed pair in a skipped
    tile, no forbidden in-range pair in a full one."""
    S = bm.block_layout(T, mc, rc).total_len
    i = np.arange(S)
    blk = np.where((i < T) | (rc == 0), i // mc, (i - T) // max(rc, 1))
    copy = i >= T
    rule = np.where(copy[None, :], blk[:, None] == blk[None, :],
                    blk[:, None] >= blk[None, :])
    np.testing.assert_array_equal(rule, bm.block_layout(T, mc, rc).allowed)
    span = np.where(copy, 0, 0x7FFFFFFF).astype(np.uint32)
    diff = (blk[:, None].astype(np.int32)
            - blk[None, :].astype(np.int32)).astype(np.uint32)
    np.testing.assert_array_equal(diff <= span[None, :], rule)
    if transposed:
        rule = rule.T
    kinds = tile_kinds(T, mc, rc, q_tile, k_tile, transposed)
    for qi, ki in np.ndindex(*kinds.shape):
        tile = rule[qi * q_tile:(qi + 1) * q_tile,
                    ki * k_tile:(ki + 1) * k_tile]
        if kinds[qi, ki] == 0:
            assert not tile.any()
        elif kinds[qi, ki] == 1:
            assert tile.all()


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, TENSOR_CORE),      # Base 768 / 12, Large 1024 / 16
    (torch.bfloat16, 128, TENSOR_CORE),     # the widest head the wrapper takes
    (torch.bfloat16, 32, TENSOR_CORE),      # a small card test's width
    (torch.float32, 64, CUDA_CORE), (torch.float32, 128, CUDA_CORE),
    (torch.float32, 6, CUDA_CORE),          # the tiny parity models: 24 / 4
    (torch.float32, 8, CUDA_CORE),          # ... and 32 / 4
    (torch.bfloat16, 6, CUDA_CORE), (torch.bfloat16, 16, CUDA_CORE),
    (torch.bfloat16, 48, CUDA_CORE), (torch.bfloat16, 96, CUDA_CORE)])
def test_kernel_path_is_a_function_of_dtype_and_head_width(dtype, head_dim,
                                                           want):
    assert kernel_path(dtype, head_dim) == want


def test_model_configs_land_on_their_kernel_sets():
    """Base and Large in bfloat16 take the tensor cores; the tiny models of
    the parity tests (float32, heads of 6 and 8) the CUDA cores."""
    from wav2vec_s_tpu_torch.models import (
        Wav2Vec2Config, wav2vec_s_base_config)

    base = wav2vec_s_base_config(dtype="bfloat16")
    assert kernel_path(torch.bfloat16, base.encoder_embed_dim
                       // base.encoder_attention_heads) == TENSOR_CORE
    assert kernel_path(torch.bfloat16, 1024 // 16) == TENSOR_CORE
    for dim, heads in ((24, 4), (32, 4)):
        tiny = Wav2Vec2Config(encoder_embed_dim=dim,
                              encoder_attention_heads=heads)
        assert kernel_path(torch.float32, tiny.encoder_embed_dim
                           // tiny.encoder_attention_heads) == CUDA_CORE


def test_tensor_core_path_refuses_misaligned_tensors():
    """Its 16-byte copies need 16-byte aligned [B, S, D] tensors; the
    CUDA-core path takes any alignment."""
    flat = torch.zeros(2 * 8 * 64 + 8, dtype=torch.bfloat16)
    ok, off = flat[:-8].view(2, 8, 64), flat[1:-7].view(2, 8, 64)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    assert fa._path_of(ok, 2, ok, ok) == TENSOR_CORE
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._path_of(ok, 2, ok, off)
    assert fa._path_of(off.float(), 2, off) == CUDA_CORE
    assert fa._path_of(off, 4, off) == CUDA_CORE            # heads of 16


def _bf16(t):
    return t.bfloat16().float()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_rounding_model_stays_within_the_card_tolerances(rate):
    """The tensor-core kernels round the probabilities (forward: exp(s - m)
    times keep; backward: p keep) and dS to bfloat16, because they are
    operands of the second products, where the twins keep float32.  A plain
    model of exactly that rounding, at the training call's length and head
    width (S 748, dh 64), stays within what the card tests and
    chip_smoke.py allow bfloat16 against the twins: 2e-2 max abs on the
    output, 1e-2 of the largest entry on each gradient.  Nearly all of it
    is the final bfloat16 rounding of the results (one ulp of an entry of
    size 1-2 is 7.8e-3), which both sides do."""
    T, mc, rc, B, H, dh = 500, 16, 8, 1, 2, 64
    q, k, v, key_pad, w = _grad_inputs(T, mc, rc, B, H, dh, seed=5)
    q, k, v, w = (torch.from_numpy(t).bfloat16() for t in (q, k, v, w))
    key_pad = torch.from_numpy(key_pad)
    S, scale = q.shape[1], dh ** -0.5
    assert S == 748
    seed, offset = DROP["dropout_seed"], DROP["dropout_offset"]
    lay = (key_pad, H, T, mc, rc, rate)
    out, m, l = blockwise_flash_attention_ref(q, k, v, *lay, seed, offset)
    want = blockwise_flash_attention_bwd_ref(q, k, v, out, w, m, l, *lay,
                                             seed, offset)

    qh, kh, vh, doh, oh = (fa._split(t, H) for t in (q, k, v, w, out))
    keep = fa._keep_scale(B, H, S, rate, seed, offset, q.device)
    keep = 1.0 if keep is None else keep
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale + fa._bias(
        key_pad, T, mc, rc)
    e = torch.exp(s - m[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", _bf16(e * keep), vh) / l[..., None]
    got_out = fa._merge(o, q.dtype)
    p = e / l.clamp(min=1e-20)[..., None]
    dvec = (doh * oh).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", doh, vh)
    pt, ds = _bf16(p * keep), _bf16(p * (dp * keep - dvec))
    got = (torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale,
           torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale,
           torch.einsum("bhqk,bhqd->bhkd", pt, doh))
    got = [fa._merge(t, q.dtype) for t in got]

    valid = ~key_pad
    err = (got_out[valid].float() - out[valid].float()).abs().max().item()
    assert err <= 2e-2, err
    assert (got_out.float() - out.float()).abs().max() > 0    # it does round
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 0:
            a, b = a[valid], b[valid]
        rel = ((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert rel.item() <= 1e-2, (i, rel.item())


def test_ptxas_summary_names_kernels_registers_and_spills():
    log = """
ptxas info    : Compiling entry function '_ZN59_GLOBAL__N__b061238f_26_flash_attention_bwd_mma_cu_cc73df7520flash_dkv_mma_kernelILi64ELb1EEEvPK13__nv_bfloat16S3_S3_' for 'sm_90a'
ptxas info    : Function properties for _ZN59_GLOBAL__N__b061238f_26_flash_attention_bwd_mma_cu_cc73df7520flash_dkv_mma_kernelILi64ELb1EEEvPK13__nv_bfloat16S3_S3_
    24 bytes stack frame, 20 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__1f0a_10_dropout_cu_4c5d14dropout_kernelI13__nv_bfloat16EEvPKT_PS2_xy' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__1f0a_10_dropout_cu_4c5d14dropout_kernelI13__nv_bfloat16EEvPKT_PS2_xy
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_13alphas_kernelEPKfS1_Pfii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 23 registers
"""
    assert native.ptxas_summary(log) == [
        ("flash_dkv_mma_kernel<64, true>", 168, 56),
        ("dropout_kernel<bfloat16>", 26, 0), ("alphas_kernel", 23, 0)]
    assert native.ptxas_summary("nvcc warning : nothing") == []


def test_wrapper_runs_the_twin_on_cpu():
    T, mc, rc, B, H, dh = CASES[0]
    q, k, v, key_pad = map(torch.from_numpy, _inputs(T, mc, rc, B, H, dh))
    before = blockwise_flash_attention_packed.launches
    paths = dict(blockwise_flash_attention_packed.path_launches)
    out = blockwise_flash_attention_packed(q, k, v, key_pad, H, T, mc, rc)
    out2, m, l = blockwise_flash_attention_packed(q, k, v, key_pad, H, T, mc,
                                                  rc, return_stats=True)
    assert blockwise_flash_attention_packed.launches == before
    assert blockwise_flash_attention_packed.path_launches == paths
    assert set(paths) == {TENSOR_CORE, CUDA_CORE}
    want = blockwise_flash_attention_ref(q, k, v, key_pad, H, T, mc, rc)
    for got, ref in zip((out, m, l), want):
        assert torch.equal(got, ref)
    assert torch.equal(out, out2) and m.shape == l.shape == (B, H, q.shape[1])
    assert out.dtype == torch.float32
    out_bf16 = blockwise_flash_attention_packed(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), key_pad, H, T, mc, rc)
    assert out_bf16.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["rate", "seed", "length", "mask_dtype",
                                 "dtypes", "heads", "head_width", "kv_shape"])
def test_wrapper_rejects(bad):
    T, mc, rc, B, H, dh = CASES[0]
    q, k, v, key_pad = map(torch.from_numpy, _inputs(T, mc, rc, B, H, dh))
    kw = {}
    if bad == "rate":
        kw["dropout_rate"] = 1.0
    elif bad == "seed":
        kw.update(dropout_rate=0.1, dropout_seed=-1)
    elif bad == "length":
        T = T - 16                              # S no longer the layout's
    elif bad == "mask_dtype":
        key_pad = key_pad.float()
    elif bad == "dtypes":
        k = k.bfloat16()
    elif bad == "heads":
        H = 3                                   # 64 columns in 3 heads
    elif bad == "head_width":
        q = k = v = torch.zeros(B, q.shape[1], 2 * 129)    # dh 129 > 128
    else:
        v = v[:, :-1]
    with pytest.raises(ValueError):
        blockwise_flash_attention_packed(q, k, v, key_pad, H, T, mc, rc, **kw)


@pytest.mark.parametrize("T,mc,rc", LAYOUTS)
def test_block_layout_matches_jax(T, mc, rc):
    got, want = bm.block_layout(T, mc, rc), jax_bm.block_layout(T, mc, rc)
    for f in ("seq_len", "main_context", "right_context", "num_blocks",
              "rc_len", "total_len"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("rc_idx", "rc_invalid", "allowed"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("T,mc,rc", [(97, 16, 8), (96, 16, 8), (64, 8, 0)])
def test_rc_copies_padding_and_bias_match_jax(T, mc, rc):
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, 5)).astype(np.float32)
    pad = np.zeros((2, T), bool)
    pad[1, T - 20:] = True
    got_l, want_l = bm.block_layout(T, mc, rc), jax_bm.block_layout(T, mc, rc)
    xt, pt = torch.from_numpy(x), torch.from_numpy(pad)
    ext = bm.append_right_context(xt, got_l)
    np.testing.assert_array_equal(
        ext.numpy(),
        np.asarray(jax_bm.append_right_context(jnp.asarray(x), want_l)))
    np.testing.assert_array_equal(bm.strip_right_context(ext, got_l).numpy(),
                                  x)
    np.testing.assert_array_equal(
        bm.extend_padding_mask(pt, got_l).numpy(),
        np.asarray(jax_bm.extend_padding_mask(jnp.asarray(pad), want_l)))
    np.testing.assert_array_equal(
        bm.block_attn_bias(got_l, pt).numpy(),
        np.asarray(jax_bm.block_attn_bias(want_l, jnp.asarray(pad))))
    assert bm.block_attn_bias(got_l).shape == (1, 1) + want_l.allowed.shape


def test_positions_from_padding_match_jax():
    pad = np.zeros((3, 50), bool)
    pad[1, 30:] = True
    pad[2, :5] = True                           # leading pad too
    got = sinusoidal_positions_from_padding(torch.from_numpy(pad), 24)
    want = jax_positions(jnp.asarray(pad), 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (T, mc, rc, B, H, dh): tests/test_pallas_attention.py's backward shapes
GRAD_CASES = [(96, 16, 8, 2, 2, 32), (64, 8, 0, 1, 2, 64)]


def _grad_inputs(T, mc, rc, B, H, dh, seed=2):
    """q, k, v, the ragged non-contiguous key padding of ``_inputs`` and a
    cotangent that is zero on padded rows (the encoder strips them before
    the loss)."""
    q, k, v, key_pad = _inputs(T, mc, rc, B, H, dh, seed)
    w = np.random.default_rng(seed + 100).standard_normal(q.shape).astype(
        np.float32) * ~key_pad[:, :, None]
    return q, k, v, key_pad, w


def _dense_bias(key_pad, T, mc, rc):
    allowed = torch.from_numpy(bm.block_layout(T, mc, rc).allowed)
    return (torch.where(allowed, 0.0, NEG)[None, None]
            + torch.where(key_pad, NEG, 0.0)[:, None, None, :])


def _dense(q, k, v, key_pad, H, T, mc, rc, rate=0.0, ctx=None):
    """The dense branch of ``self_attention`` on packed tensors."""
    B, S, D = q.shape

    def split(t):
        return t.reshape(B, S, H, D // H).transpose(1, 2)

    out = dot_product_attention(split(q), split(k), split(v),
                                _dense_bias(key_pad, T, mc, rc), rate, ctx)
    return out.transpose(1, 2).reshape(B, S, D)


def _flash_grads(q, k, v, key_pad, w, H, T, mc, rc, **kw):
    qkv = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = blockwise_flash_attention_packed(*qkv, torch.from_numpy(key_pad),
                                           H, T, mc, rc, **kw)
    return out, torch.autograd.grad(out, qkv, torch.from_numpy(w))


@pytest.mark.parametrize("T,mc,rc,B,H,dh", GRAD_CASES)
def test_twin_backward_matches_dense_autograd(T, mc, rc, B, H, dh):
    q, k, v, key_pad, w = _grad_inputs(T, mc, rc, B, H, dh)
    _, got = _flash_grads(q, k, v, key_pad, w, H, T, mc, rc)
    qkv = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        _dense(*qkv, torch.from_numpy(key_pad), H, T, mc, rc), qkv,
        torch.from_numpy(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5,
                                   rtol=3e-5)


@pytest.mark.parametrize("T,mc,rc,B,H,dh", GRAD_CASES)
def test_twin_backward_matches_jax_grad(T, mc, rc, B, H, dh):
    """Against jax.grad through the Pallas forward and backward kernels in
    interpret mode (the custom_vjp of ``_flash_attn``)."""
    q, k, v, key_pad, w = _grad_inputs(T, mc, rc, B, H, dh)

    def loss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, jnp.asarray(key_pad), H, T, mc, rc,
                        interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _, got = _flash_grads(q, k, v, key_pad, w, H, T, mc, rc)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5,
                                   rtol=3e-5)


def test_backward_wrapper_runs_the_twin_on_cpu_and_checks_shapes():
    T, mc, rc, B, H, dh = GRAD_CASES[0]
    q, k, v, key_pad, w = map(torch.from_numpy,
                              _grad_inputs(T, mc, rc, B, H, dh))
    out, m, l = blockwise_flash_attention_ref(q, k, v, key_pad, H, T, mc, rc)
    before = blockwise_flash_attention_bwd.launches
    got = blockwise_flash_attention_bwd(q, k, v, out, w, m, l, key_pad, H, T,
                                        mc, rc)
    assert blockwise_flash_attention_bwd.launches == before
    want = blockwise_flash_attention_bwd_ref(q, k, v, out, w, m, l, key_pad,
                                             H, T, mc, rc)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="m must be"):
        blockwise_flash_attention_bwd(q, k, v, out, w, m[:, :1], l, key_pad,
                                      H, T, mc, rc)
    with pytest.raises(ValueError, match="dout must be"):
        blockwise_flash_attention_bwd(q, k, v, out, w.bfloat16(), m, l,
                                      key_pad, H, T, mc, rc)


@pytest.mark.parametrize("grad_input", [0, 1, 2])          # q, k, v
def test_autograd_follows_the_grad_mode(grad_input):
    """One input requiring grad is enough for a differentiable result with
    gradients for exactly that input; under torch.no_grad() the inference
    path runs and nothing is recorded."""
    T, mc, rc, B, H, dh = CASES[0]
    q, k, v, pad = map(torch.from_numpy, _inputs(T, mc, rc, B, H, dh))
    qkv = [q, k, v]
    qkv[grad_input].requires_grad_(True)
    out, m, l = blockwise_flash_attention_packed(*qkv, pad, H, T, mc, rc,
                                                 return_stats=True)
    assert out.requires_grad and not m.requires_grad and not l.requires_grad
    out.sum().backward()
    assert [t.grad is not None for t in qkv] == [i == grad_input
                                                 for i in range(3)]
    with torch.no_grad():
        quiet = blockwise_flash_attention_packed(*qkv, pad, H, T, mc, rc)
    assert not quiet.requires_grad
    assert torch.equal(quiet, out.detach())


DROP = dict(dropout_rate=0.3, dropout_seed=0x1234_5678_9ABC_DEF,
            dropout_offset=5)


class _Site(DropoutContext):
    """A context whose next site is a given (seed, offset)."""

    def __init__(self, seed, offset):
        self.seed, self.sites = seed, offset


@pytest.mark.parametrize("T,mc,rc,B,H,dh", GRAD_CASES + [(97, 16, 8, 2, 3, 8)])
def test_dropout_equals_dense_attention_under_one_seed(T, mc, rc, B, H, dh):
    """Forward and gradients; tolerances are f32 rounding (the two sides
    normalise and scale in a different order): atol/rtol 3e-5."""
    q, k, v, key_pad, w = _grad_inputs(T, mc, rc, B, H, dh)
    out, got = _flash_grads(q, k, v, key_pad, w, H, T, mc, rc, **DROP)
    qkv = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    ctx = _Site(DROP["dropout_seed"], DROP["dropout_offset"])
    ref = _dense(*qkv, torch.from_numpy(key_pad), H, T, mc, rc,
                 DROP["dropout_rate"], ctx)
    assert ctx.sites == DROP["dropout_offset"] + 1
    want = torch.autograd.grad(ref, qkv, torch.from_numpy(w))
    valid = ~key_pad
    np.testing.assert_allclose(out.detach().numpy()[valid],
                               ref.detach().numpy()[valid], atol=3e-5,
                               rtol=3e-5)
    plain = blockwise_flash_attention_ref(
        *map(torch.from_numpy, (q, k, v, key_pad)), H, T, mc, rc)[0]
    assert (out.detach() - plain)[torch.from_numpy(valid)].abs().max() > 1e-2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5,
                                   rtol=3e-5)


def _probe(B, H, T, mc, rc, **drop):
    """[B, H, S, S] dropped probabilities read back through the forward
    twin (v = identity per head) and [B, H, S, S] through the backward twin
    (dV for a cotangent of ones picks sum_q p*keep; with do = identity
    columns it is p*keep transposed)."""
    S = bm.block_layout(T, mc, rc).total_len
    q = k = torch.zeros(B, S, H * S)
    v = torch.eye(S).repeat(B, 1, H)
    pad = torch.zeros(B, S, dtype=torch.bool)
    out, m, l = blockwise_flash_attention_ref(q, k, v, pad, H, T, mc, rc,
                                              **drop)
    fwd = out.reshape(B, S, H, S).transpose(1, 2)            # [B, H, q, k]
    _, _, dv = blockwise_flash_attention_bwd_ref(
        q, k, v, out, v, m, l, pad, H, T, mc, rc, **drop)
    bwd = dv.reshape(B, S, H, S).transpose(1, 2).transpose(2, 3)
    return fwd, bwd


def test_dropout_forward_mask_is_backward_mask_and_keep_share():
    B, H, T, mc, rc, rate = 2, 3, 32, 8, 4, 0.25
    fwd, bwd = _probe(B, H, T, mc, rc, **dict(DROP, dropout_rate=rate))
    plain, _ = _probe(B, H, T, mc, rc)
    allowed = plain != 0
    S = allowed.shape[-1]
    assert torch.equal(fwd != 0, bwd != 0)
    want = keep_mask(B * H * S * S, rate, DROP["dropout_seed"],
                     DROP["dropout_offset"]).reshape(B, H, S, S)
    assert torch.equal(fwd != 0, want & allowed)              # bit-equal
    np.testing.assert_allclose(fwd[fwd != 0].numpy(),
                               (plain / (1 - rate))[fwd != 0].numpy(),
                               rtol=1e-6)
    n = int(allowed.sum())
    share = float((fwd != 0).sum()) / n
    assert abs(share - (1 - rate)) <= 4 * (rate * (1 - rate) / n) ** 0.5


def test_dropout_masks_differ_across_slots_heads_seeds_and_offsets():
    """The seed-fold trap of the JAX kernel (every batch slot drew one
    mask): coordinates are counter words here, no seed arithmetic."""
    B, H, T, mc, rc = 2, 2, 32, 8, 4
    base, _ = _probe(B, H, T, mc, rc, **DROP)
    keep = base != 0
    allowed = _probe(B, H, T, mc, rc)[0] != 0

    def differs(a, b):
        return float((a != b)[allowed[0, 0]].float().mean()) > 0.2

    assert differs(keep[0, 0], keep[1, 0])                    # batch slots
    assert differs(keep[0, 0], keep[0, 1])                    # heads
    for other in (dict(DROP, dropout_seed=DROP["dropout_seed"] + 1),
                  dict(DROP, dropout_offset=DROP["dropout_offset"] + 1)):
        assert differs(keep[0, 0], (_probe(B, H, T, mc, rc, **other)[0]
                                    != 0)[0, 0])
    again, _ = _probe(B, H, T, mc, rc, **DROP)
    assert torch.equal(base, again)                           # deterministic


def test_dropout_preserves_the_mean_and_a_rate_near_one_empties_rows():
    T, mc, rc, B, H, dh = 96, 16, 8, 2, 4, 16
    q, k, v, _ = map(torch.from_numpy, _inputs(T, mc, rc, B, H, dh))
    pad = torch.zeros(q.shape[:2], dtype=torch.bool)
    o0 = blockwise_flash_attention_packed(q, k, v, pad, H, T, mc, rc)
    outs = [blockwise_flash_attention_packed(
        q, k, v, pad, H, T, mc, rc, dropout_rate=0.1, dropout_seed=seed)
        for seed in range(8)]
    ratio = float(torch.stack(outs).mean(0).abs().mean() / o0.abs().mean())
    assert 0.93 < ratio < 1.08, ratio
    o = blockwise_flash_attention_packed(q, k, v, pad, H, T, mc, rc,
                                         dropout_rate=0.97, dropout_seed=3)
    rows = o.reshape(B, -1, H, dh)
    zero_frac = float((rows.abs() < 1e-6).all(-1).float().mean())
    assert zero_frac > 0.05, zero_frac
    assert float(o.abs().max()) > 3 * float(o0.abs().max())
