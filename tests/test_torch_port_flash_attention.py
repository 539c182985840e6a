"""Block-sparse flash attention (K2) and the block layout: the port against
the JAX package.

- ``blockwise_flash_attention_ref`` (the twin the CUDA kernel is held
  against on the card) equals the JAX ``blockwise_flash_attention_packed``
  run as its Pallas kernel in interpret mode, and its row stats ``m``/``l``
  equal the kernel's (``_flash_attn_impl``), atol/rtol 2e-5 on valid rows,
  at the shapes of tests/test_pallas_attention.py (rc 0 included) with
  non-contiguous key padding;
- the tile-kind table the kernel walks covers the layout, and the layout
  rule the kernel evaluates in partial tiles equals ``allowed``;
- the wrapper runs the twin on CPU tensors and rejects what the kernel
  does not take;
- block layout, rc copies, padding extension, dense bias and the positions
  of the full-sequence encoder equal their JAX originals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec_s_tpu.ops import block_mask as jax_bm
from wav2vec_s_tpu.ops.pallas_attention import (
    TILE, _flash_attn_impl, _tile_plan)
from wav2vec_s_tpu.ops.pallas_attention import (
    blockwise_flash_attention_packed as jax_flash)
from wav2vec_s_tpu.utils.positional import (
    sinusoidal_positions_from_padding as jax_positions)
from wav2vec_s_tpu_torch.ops import block_mask as bm
from wav2vec_s_tpu_torch.ops.flash_attention import (
    K_TILE, NEG, Q_TILE, blockwise_flash_attention_packed,
    blockwise_flash_attention_ref, tile_kinds)
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


@pytest.mark.parametrize("T,mc,rc", LAYOUTS)
def test_tile_kinds_cover_the_layout(T, mc, rc):
    allowed = bm.block_layout(T, mc, rc).allowed
    S = allowed.shape[0]
    kinds = tile_kinds(T, mc, rc)
    assert kinds.shape == (-(-S // Q_TILE), -(-S // K_TILE))
    for qi, ki in np.ndindex(*kinds.shape):
        tile = allowed[qi * Q_TILE:(qi + 1) * Q_TILE,
                       ki * K_TILE:(ki + 1) * K_TILE]
        want = 0 if not tile.any() else 1 if tile.all() else 2
        assert kinds[qi, ki] == want, (qi, ki)
    assert (kinds == 0).any()                 # the kernel skips something


@pytest.mark.parametrize("T,mc,rc", LAYOUTS)
def test_kernel_layout_rule_equals_allowed(T, mc, rc):
    """The rule csrc/flash_attention.cu evaluates in partial tiles."""
    S = bm.block_layout(T, mc, rc).total_len
    i = np.arange(S)
    blk = np.where((i < T) | (rc == 0), i // mc, (i - T) // max(rc, 1))
    copy = i >= T
    rule = np.where(copy[None, :], blk[:, None] == blk[None, :],
                    blk[:, None] >= blk[None, :])
    np.testing.assert_array_equal(rule, bm.block_layout(T, mc, rc).allowed)


def test_wrapper_runs_the_twin_on_cpu():
    T, mc, rc, B, H, dh = CASES[0]
    q, k, v, key_pad = map(torch.from_numpy, _inputs(T, mc, rc, B, H, dh))
    before = blockwise_flash_attention_packed.launches
    out = blockwise_flash_attention_packed(q, k, v, key_pad, H, T, mc, rc)
    out2, m, l = blockwise_flash_attention_packed(q, k, v, key_pad, H, T, mc,
                                                  rc, return_stats=True)
    assert blockwise_flash_attention_packed.launches == before
    want = blockwise_flash_attention_ref(q, k, v, key_pad, H, T, mc, rc)
    for got, ref in zip((out, m, l), want):
        assert torch.equal(got, ref)
    assert torch.equal(out, out2) and m.shape == l.shape == (B, H, q.shape[1])
    assert out.dtype == torch.float32
    out_bf16 = blockwise_flash_attention_packed(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), key_pad, H, T, mc, rc)
    assert out_bf16.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["dropout", "length", "mask_dtype", "dtypes",
                                 "heads", "head_width", "kv_shape"])
def test_wrapper_rejects(bad):
    T, mc, rc, B, H, dh = CASES[0]
    q, k, v, key_pad = map(torch.from_numpy, _inputs(T, mc, rc, B, H, dh))
    kw = {}
    if bad == "dropout":
        kw["dropout_rate"] = 0.1
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
    err = NotImplementedError if bad == "dropout" else ValueError
    with pytest.raises(err):
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


@pytest.mark.parametrize("grad_input", [0, 1, 2])          # q, k, v
def test_refuses_autograd_runs_under_no_grad(grad_input):
    """Under grad mode with an input that requires grad the wrapper raises
    on every device (the flash backward K3 is not ported, so a CUDA result
    would silently lose its gradient); under torch.no_grad() it runs."""
    T, mc, rc, B, H, dh = CASES[0]
    q, k, v, pad = map(torch.from_numpy, _inputs(T, mc, rc, B, H, dh))
    qkv = [q, k, v]
    qkv[grad_input].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="K3"):
        blockwise_flash_attention_packed(*qkv, pad, H, T, mc, rc)
    with torch.no_grad():
        out = blockwise_flash_attention_packed(*qkv, pad, H, T, mc, rc)
    assert not out.requires_grad
    want = blockwise_flash_attention_ref(q.detach(), k.detach(), v.detach(),
                                         pad, H, T, mc, rc)[0]
    assert torch.equal(out, want)
