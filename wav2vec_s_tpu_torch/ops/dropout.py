"""Counter-based dropout: CUDA kernel wrapper, its plain twin, and the
per-step dropout context the training forward threads through its sites.

Port of ``wav2vec_s_tpu/ops/dropout.py`` (``hw_dropout``, the Pallas
``_mask_kernel``/``_run`` with the custom_vjp ``_hw_dropout2``).  The TPU
kernel drew its mask from the hardware PRNG; here the mask comes from
Philox4x32-10 keyed on ``(seed, offset, flat element index)`` (the kernel
``csrc/dropout.cu`` says how), so

- the forward is one read and one write of the tensor,
- the backward regenerates the identical mask from ``(seed, offset)``
  instead of storing one (``dx = dy * keep / (1 - p)``), and
- the twin ``dropout_ref`` computes the same bits in int64 torch
  arithmetic, so the card compares masks exactly.

Any feature width and any float dtype: the TPU's ``D % 128`` threefry
fallback was a VMEM limit and has no counterpart.  ``hw_dropout`` runs the
twin for CPU tensors and launches the kernel for CUDA tensors; a build or
launch failure raises, it never falls back to the twin.

Seeds: a training step draws ONE 63-bit base seed from a host
``torch.Generator`` (no device-to-host sync); every dropout site of the
step takes its own ``offset`` from ``DropoutContext``'s site counter.  No
seed is folded through an int32 product (the seed-fold trap of the JAX
flash kernel, fixed there in ``10440df``): rows and sites differ by counter
words, not by wrapped seeds.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57       # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85       # key schedule
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float64: 3}


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product ``m * x`` for a 32-bit
    constant ``m`` and an int64 tensor of 32-bit values.  int64 is signed,
    so the product is split over the 16-bit halves of ``m`` (each partial
    product < 2**48) instead of relying on a wrapping multiply."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (t >> 32) + (p_hi >> 16), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, key: int):
    """Philox4x32-10 (Salmon et al. 2011, Random123) on int64 tensors of
    32-bit counter words under a 64-bit ``key``: the four output words."""
    k0, k1 = key & _MASK32, key >> 32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits(n: int, seed: int, offset: int,
                device=None) -> torch.Tensor:
    """[n] int64 tensor of the 32-bit words the kernel draws for elements
    ``0..n-1`` under ``(seed, offset)``: Philox4x32-10 on counter
    ``(i // 4, offset)`` and key ``seed``, word ``i % 4``."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = philox4x32_10(g & _MASK32, g >> 32,
                          torch.full_like(g, offset & _MASK32),
                          torch.full_like(g, offset >> 32), seed)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def _threshold(rate: float) -> int:
    """keep <=> (bits >> 8) >= threshold: the TPU kernel's ``u >= rate``
    with u the top 24 bits over 2**24, compared in integers."""
    return math.ceil(rate * (1 << 24))


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def keep_mask(n: int, rate: float, seed: int, offset: int,
              device=None) -> torch.Tensor:
    """[n] bool keep mask of the plain twin (True = kept)."""
    return (philox_bits(n, seed, offset, device) >> 8) >= _threshold(rate)


def dropout_ref(x: torch.Tensor, rate: float, seed: int,
                offset: int) -> torch.Tensor:
    """Plain twin of the kernel: ``x * keep / (1 - rate)`` with the mask of
    ``keep_mask`` over ``x``'s flat (row-major) elements; the product in
    float32 (float64 for double), rounded once to ``x.dtype``."""
    acc = _acc(x.dtype)
    keep = keep_mask(x.numel(), rate, seed, offset, x.device)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=acc, device=x.device)
    factor = torch.where(keep.reshape(x.shape), scale, 0.0)
    return (x.to(acc) * factor).to(x.dtype)


def _check(x, rate, seed, offset):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} is not in [0, 1)")
    if not (0 <= seed < 1 << 64 and 0 <= offset < 1 << 64):
        raise ValueError(f"seed {seed} and offset {offset} must be "
                         f"unsigned 64-bit integers")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dropout takes a float tensor, got {x.dtype}")


def _run(x: torch.Tensor, rate: float, seed: int,
         offset: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return dropout_ref(x, rate, seed, offset)
    if x.device.type != "cuda":
        raise ValueError(f"no dropout kernel for device {x.device}")
    from wav2vec_s_tpu_torch.ops import native

    x = x.contiguous()
    with torch.cuda.device(x.device):
        lib = native.library()
        out = torch.empty_like(x)
        err = lib.w2vs_dropout(
            x.data_ptr(), out.data_ptr(), x.numel(), seed, offset,
            _threshold(rate), 1.0 / (1.0 - rate), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dropout kernel launch failed: CUDA error {err}")
    hw_dropout.launches += 1
    return out


class _HwDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed, offset):
        ctx.args = (rate, seed, offset)
        return _run(x, rate, seed, offset)

    @staticmethod
    def backward(ctx, dy):
        # the same (seed, offset) regenerates the forward's mask
        return _run(dy, *ctx.args), None, None, None


def hw_dropout(x: torch.Tensor, rate: float, seed: int,
               offset: int) -> torch.Tensor:
    """``x * keep / (1 - rate)`` with the mask of ``(seed, offset)``.

    Rate 0 returns ``x`` and launches nothing (eval mode passes no
    ``DropoutContext`` and never calls this).  CPU tensors
    run the twin; CUDA tensors launch the kernel (count in
    ``hw_dropout.launches``, forward and backward) or raise."""
    if rate == 0.0:
        return x
    _check(x, rate, seed, offset)
    return _HwDropout.apply(x, float(rate), int(seed), int(offset))


hw_dropout.launches = 0


class DropoutContext:
    """The randomness of one training forward.

    ``seed``: the step's 63-bit base seed, drawn once from ``generator``;
    each dropout site (``ctx(x, rate)``) takes the next ``offset`` (the
    count of sites so far, in ``sites``).  ``layer_dropped``, ``randint``
    and ``uniform`` draw layerdrop decisions, decoder position offsets,
    contrastive negatives and Gumbel noise on the host from the same
    generator.  Give it a CPU generator: the draws then need no
    device-to-host sync, and a card run draws what a CPU run does.  A
    context always means training: inference passes ``ctx=None`` (see
    ``drop``)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=generator))
        self.sites = 0

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        return hw_dropout(x, rate, *self.next_site())

    def next_site(self):
        """``(seed, offset)`` of the next dropout site, for an operator
        that draws its mask itself (the flash-attention kernels)."""
        self.sites += 1
        return self.seed, self.sites - 1

    def layer_dropped(self, p: float) -> bool:
        """One host Bernoulli(p) draw per layer (layerdrop)."""
        if p == 0.0:
            return False
        return bool(torch.rand((), generator=self.generator) < p)

    def randint(self, high: int, shape) -> torch.Tensor:
        """CPU int64 tensor of draws in [0, high)."""
        return torch.randint(0, high, shape, generator=self.generator)

    def uniform(self, shape) -> torch.Tensor:
        """CPU float32 tensor of draws in [1e-10, 1) (the JAX quantizer's
        ``uniform(minval=1e-10, maxval=1.0)``)."""
        return torch.rand(shape, generator=self.generator).clamp_(min=1e-10)


def drop(ctx: Optional[DropoutContext], x: torch.Tensor,
         rate: float) -> torch.Tensor:
    """``ctx(x, rate)``, or ``x`` when there is no context (inference)."""
    return x if ctx is None else ctx(x, rate)
