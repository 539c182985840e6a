"""The dropout index map of a shard (``ops/dropout.py``): a data-parallel
rank's rows, a context-parallel rank's time block, and both, draw the bits
of their places in the whole tensor, so a sharded step drops what one
process over the whole batch drops.  Plain twins on the CPU (K4's and the
flash kernels' masks; the card holds the kernels to the same maps in
``chip_smoke.py`` phases 3b and 4).  Torch only."""

import pytest
import torch

from wav2vec_s_tpu_torch.ops import flash_attention as fa
from wav2vec_s_tpu_torch.ops.dropout import (
    DropoutContext, global_index, hw_dropout, keep_mask, philox_bits)
from wav2vec_s_tpu_torch.parallel.mesh import Shard

SEED, OFFSET = 0x1234_5678_9ABC_DEF, 17


def _ctx(shard=None):
    return DropoutContext(torch.Generator().manual_seed(0), shard)


@pytest.mark.parametrize("shape,axis", [((6, 10, 12), 1), ((6, 9, 7), 1),
                                        ((6, 3, 10, 9), 2)])
@pytest.mark.parametrize("rows", [(0, 6), (2, 5), (3, 6)])
@pytest.mark.parametrize("seq", [None, (3, 8), (0, 4)])
def test_shard_mask_is_the_whole_masks_part(shape, axis, rows, seq):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    whole = hw_dropout(x, 0.3, SEED, OFFSET)
    ctx = _ctx(None if rows == (0, shape[0]) else Shard(*rows, shape[0]))
    part, want = x[rows[0]:rows[1]], whole[rows[0]:rows[1]]
    split = None
    if seq is not None:
        part = part.narrow(axis, seq[0], seq[1] - seq[0])
        want = want.narrow(axis, seq[0], seq[1] - seq[0])
        split = (axis, seq[0], shape[axis])
    index = ctx.index(tuple(part.shape), split)
    got = hw_dropout(part.contiguous(), 0.3, SEED, OFFSET, index)
    assert torch.equal(got, want)
    # the context's own site draws the same map
    ctx.sites = OFFSET
    ctx.seed = SEED
    assert torch.equal(ctx(part.contiguous(), 0.3, split), want)


def test_whole_tensor_index_is_the_unsharded_mask():
    """base 0 with equal spans (and no index) leave every bit as it was."""
    n = 1001
    assert torch.equal(philox_bits(n, SEED, OFFSET, index=(0, n, n)),
                       philox_bits(n, SEED, OFFSET))
    assert torch.equal(global_index(n, (0, n, n)), torch.arange(n))
    bits = philox_bits(n + 13, SEED, OFFSET)
    for base in (4, 13):            # aligned and unaligned bases
        assert torch.equal(philox_bits(n, SEED, OFFSET,
                                       index=(base, n, n)),
                           bits[base:base + n])


def test_backward_regenerates_the_shard_mask():
    x = torch.randn((4, 6, 5)).requires_grad_(True)
    index = (2 * 6 * 5, 6 * 5, 6 * 5)
    y = hw_dropout(x, 0.5, SEED, OFFSET, index)
    y.backward(torch.ones_like(y))
    keep = keep_mask(x.numel(), 0.5, SEED, OFFSET, index=index)
    assert torch.equal(x.grad != 0, keep.reshape(x.shape))


def test_bad_maps_and_sites_raise():
    x = torch.randn((4, 6))
    with pytest.raises(ValueError):
        hw_dropout(x, 0.1, SEED, OFFSET, (0, 0, 4))
    with pytest.raises(ValueError):
        hw_dropout(x, 0.1, SEED, OFFSET, (0, 8, 4))
    ctx = _ctx(Shard(2, 4, 8))
    with pytest.raises(ValueError, match="batch-major"):
        ctx(torch.randn((3, 6)), 0.1)
    with pytest.raises(ValueError, match="batch-major"):
        ctx.randint(5, (3, 2))


def test_draws_of_a_shard_are_the_whole_batchs_rows():
    """randint and uniform draw the whole batch's values and return the
    rows' (a leading axis of rows x k), leaving the generator where one
    process over the whole batch leaves it."""
    one, two = _ctx(), _ctx(Shard(2, 4, 6))
    a, b = one.randint(7, (6 * 3, 2)), two.randint(7, (2 * 3, 2))
    assert torch.equal(a[6:12], b)
    u, w = one.uniform((6, 5)), two.uniform((2, 5))
    assert torch.equal(u[2:4], w)
    assert one.layer_dropped(0.5) == two.layer_dropped(0.5)
    assert torch.equal(torch.rand(3, generator=one.generator),
                       torch.rand(3, generator=two.generator))


@pytest.mark.parametrize("S", [12, 13])
def test_flash_twin_row_base_is_the_whole_batchs_rows(S):
    """The flash twins' keep mask with ``dropout_row0`` r0 is rows r0: of
    the whole batch's (S % 4 == 0 and not); outputs equal too."""
    B, H = 5, 2
    whole = fa._keep_scale(B, H, S, 0.2, SEED, OFFSET, "cpu")
    for r0 in (1, 3):
        assert torch.equal(fa._keep_scale(B - r0, H, S, 0.2, SEED, OFFSET,
                                          "cpu", r0), whole[r0:])
    T, mc, rc = 8, 4, 2
    S = fa.block_layout(T, mc, rc).total_len
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((B, S, 8), generator=g) for _ in range(3))
    pad = torch.zeros((B, S), dtype=torch.bool)
    out = fa.blockwise_flash_attention_ref(q, k, v, pad, H, T, mc, rc, 0.2,
                                           SEED, OFFSET)[0]
    part = fa.blockwise_flash_attention_ref(q[2:], k[2:], v[2:], pad[2:], H,
                                            T, mc, rc, 0.2, SEED, OFFSET,
                                            2)[0]
    torch.testing.assert_close(part, out[2:], rtol=0, atol=1e-6)
