"""Counter-based dropout of the torch port (``ops/dropout.py``, kernel K4):
the plain twin and the dropout context, on the CPU.

The JAX package draws its masks from other streams (the TPU hardware PRNG,
threefry elsewhere), so nothing here compares bits with it (PARITY.md:222);
the semantics of ``wav2vec_s_tpu/ops/dropout.py`` are checked instead
(tests/test_hw_dropout.py): the identity at rate 0 and in eval mode, the
keep share, ``x * keep / (1 - p)`` in the input dtype, the backward on the
forward's mask.  The generator is Philox4x32-10, held against Random123's
known-answer vectors.  The card compares the kernel's masks with this twin
bit for bit (tests/test_torch_port_gpu.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_import import jax_caat, port_caat
from wav2vec_s_tpu_torch.ops.dropout import (
    DropoutContext, drop, dropout_ref, hw_dropout, keep_mask, philox4x32_10,
    philox_bits)


def _share_ok(keep, p):
    n = keep.numel()
    share = keep.float().mean().item()
    return abs(share - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5


# Random123 kat_vectors, philox4x32_10: (counter, key) -> output
KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
       ((0xffffffff,) * 4, (0xffffffff,) * 2,
        (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
       ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
        (0xa4093822, 0x299f31d0),
        (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answers(case):
    counter, (k0, k1), want = KAT[case]
    words = philox4x32_10(*(torch.tensor([c]) for c in counter),
                          (k1 << 32) | k0)
    assert tuple(int(w) for w in words) == want


def test_bits_follow_element_index_and_offset():
    """Element i draws word i % 4 of the block on counter (i // 4, offset):
    the third vector's key and counter high words as seed and offset."""
    (_, _, c2, c3), (k0, k1), _ = KAT[2]
    seed, offset = (k1 << 32) | k0, (c3 << 32) | c2
    bits = philox_bits(4 * 5 + 2, seed, offset)
    for g in range(6):
        words = philox4x32_10(torch.tensor([g]), torch.tensor([0]),
                              torch.tensor([c2]), torch.tensor([c3]), seed)
        want = [int(w) for w in words][:len(bits) - 4 * g]
        assert bits[4 * g:4 * g + 4].tolist() == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_identity_at_rate_zero_and_in_eval(dtype):
    x = torch.randn(7, 33).to(dtype)
    hw_dropout.launches = 0
    assert hw_dropout(x, 0.0, 1, 2) is x
    assert drop(None, x, 0.3) is x            # eval: no context
    ctx = DropoutContext(torch.Generator().manual_seed(0))
    assert ctx(x, 0.0) is x and ctx.sites == 0
    assert not ctx.layer_dropped(0.0)
    assert hw_dropout.launches == 0


@pytest.mark.parametrize("p", [0.1, 0.3])
@pytest.mark.parametrize("shape", [(64, 768), (16, 3072), (6, 7, 13)])
def test_keep_share_and_scaling(shape, p):
    x = torch.randn(shape)
    y = hw_dropout(x, p, seed=11, offset=3)
    keep = keep_mask(x.numel(), p, 11, 3).reshape(shape)
    assert _share_ok(keep, p)
    scale = torch.tensor(1 / (1 - p), dtype=torch.float32)
    torch.testing.assert_close(y, torch.where(keep, x * scale, 0.0),
                               rtol=0, atol=0)


def test_bf16_rounds_once_from_float32():
    x = torch.randn(40, 64).to(torch.bfloat16)
    y = dropout_ref(x, 0.3, 5, 0)
    keep = keep_mask(x.numel(), 0.3, 5, 0).reshape(x.shape)
    want = torch.where(keep, x.float() * torch.tensor(1 / 0.7), 0.0)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, want.to(torch.bfloat16))


def test_backward_uses_the_forward_mask():
    x = (torch.rand(32, 100) + 0.5).requires_grad_(True)
    y = hw_dropout(x, 0.3, seed=9, offset=4)
    dy = torch.randn_like(y)
    y.backward(dy)
    keep = y.detach() != 0
    torch.testing.assert_close(x.grad, torch.where(keep, dy / 0.7, 0.0))


def test_masks_differ_across_seeds_offsets_and_rows():
    """The seed-fold trap (10440df): rows and sites must not share masks."""
    n, d, p = 96, 64, 0.3
    base = keep_mask(n * d, p, 123, 0).reshape(n, d)
    for seed, offset in ((124, 0), (123, 1), (123 + (1 << 32), 0),
                         (123, 1 << 32)):
        other = keep_mask(n * d, p, seed, offset).reshape(n, d)
        assert (other != base).float().mean() > p * (1 - p)
    rows = {tuple(r.tolist()) for r in base}
    assert len(rows) == n                     # every row its own mask


def test_context_sites_take_successive_offsets():
    gen = torch.Generator().manual_seed(0)
    ctx = DropoutContext(gen)
    x = torch.ones(8, 16)
    a, b = ctx(x, 0.3), ctx(x, 0.3)
    assert ctx.sites == 2 and ctx(x, 0.0) is x and ctx.sites == 2
    assert torch.equal(a, dropout_ref(x, 0.3, ctx.seed, 0))
    assert torch.equal(b, dropout_ref(x, 0.3, ctx.seed, 1))
    again = DropoutContext(torch.Generator().manual_seed(0))
    assert again.seed == ctx.seed
    assert 0 <= ctx.seed < 2 ** 63
    drops = [ctx.layer_dropped(0.25) for _ in range(2000)]
    assert abs(np.mean(drops) - 0.25) < 4 * (0.25 * 0.75 / 2000) ** 0.5


def test_training_forward_threads_dropout_through_every_site():
    """The tiny CAAT model with the recipe's dropouts: the number of sites
    the forward runs, a reproducible loss for one generator seed, another
    for the next, and gradients through the dropped activations."""
    w2v = dataclasses.replace(W2V_TINY, dropout=0.1, attention_dropout=0.1,
                              activation_dropout=0.0, encoder_layerdrop=0.0)
    caat = dataclasses.replace(CAAT_TINY, dropout=0.3, attention_dropout=0.1,
                               activation_dropout=0.1)
    model = port_caat(jax_caat(w2v, caat)[1], w2v, caat)
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.standard_normal((2, 2400)).astype(np.float32))
    prev = torch.from_numpy(rng.integers(4, 30, (2, 6))).long()
    prev[:, 0] = caat.bos

    def run(seed):
        ctx = DropoutContext(torch.Generator().manual_seed(seed))
        h, _ = model(src, prev, ctx=ctx)
        return h, ctx.sites

    (h1, sites), (h2, _), (h3, _) = run(0), run(0), run(1)
    # encoder: input + 3 per layer; LM: input + 4 per layer; jointer: 4 per
    # layer (activation_dropout 0 in the encoder drops one site there)
    assert sites == (1 + 3 * w2v.encoder_layers + 1 + 4 * caat.decoder_layers
                     + 4 * caat.jointer_layers)
    assert torch.equal(h1, h2) and not torch.equal(h1, h3)
    h1.square().sum().backward()
    assert all(p.grad is not None for n, p in model.named_parameters()
               if n != "encoder.w2v2_model.mask_emb")
    with torch.no_grad():
        h0, _ = model(src, prev)              # eval: no context, no dropout
        h0b, _ = model(src, prev, ctx=None)
    assert torch.equal(h0, h0b) and not torch.equal(h0, h1)
