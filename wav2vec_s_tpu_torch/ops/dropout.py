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

Shards: every rank of a parallel run draws the same step seed, so a rank
that holds part of a tensor (its rows of a data-parallel batch, its time
block under context parallelism, its heads of the attention probabilities
or its columns of the FFN's hidden layer under tensor parallelism) draws
the bits of its elements' places in the whole tensor, through an ``index`` map ``(base, span_local,
span_global)``: local element ``i`` takes the bits of
``base + (i // span_local) * span_global + i % span_local``.  The JAX
package draws the mask of the global array under SPMD; with the map a
sharded run drops exactly what one process over the whole batch drops.
``DropoutContext`` builds the map of each site from its shard (a
``parallel.mesh.Shard``: the rows it reads, never its process group).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Optional, Tuple

import torch

if TYPE_CHECKING:
    from wav2vec_s_tpu_torch.parallel.mesh import Shard

#: (base, span_local, span_global) of a shard; None is the whole tensor
Index = Optional[Tuple[int, int, int]]

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


def _blocks(g: torch.Tensor, seed: int, offset: int):
    """The four Philox words of each block index in ``g``."""
    return philox4x32_10(g & _MASK32, g >> 32,
                         torch.full_like(g, offset & _MASK32),
                         torch.full_like(g, offset >> 32), seed)


def global_index(n: int, index: Index, device=None) -> torch.Tensor:
    """[n] int64: the whole tensor's flat index of each of a shard's ``n``
    elements under ``index`` (``arange(n)`` for None)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    if index is None:
        return i
    base, span_local, span_global = index
    return base + i // span_local * span_global + i % span_local


def philox_bits(n: int, seed: int, offset: int, device=None,
                index: Index = None) -> torch.Tensor:
    """[n] int64 tensor of the 32-bit words the kernel draws for elements
    ``0..n-1`` under ``(seed, offset)``: Philox4x32-10 on counter
    ``(j // 4, offset)`` and key ``seed``, word ``j % 4``, with ``j`` the
    element's index in the whole tensor (``global_index``)."""
    base = 0 if index is None else index[0]
    if index is None or (index[1] == index[2] and base % 4 == 0):
        g = base // 4 + torch.arange((n + 3) // 4, dtype=torch.int64,
                                     device=device)
        return torch.stack(_blocks(g, seed, offset), dim=1).reshape(-1)[:n]
    j = global_index(n, index, device)
    words = torch.stack(_blocks(j >> 2, seed, offset), dim=1)
    return words.gather(1, (j & 3)[:, None])[:, 0]


def _threshold(rate: float) -> int:
    """keep <=> (bits >> 8) >= threshold: the TPU kernel's ``u >= rate``
    with u the top 24 bits over 2**24, compared in integers."""
    return math.ceil(rate * (1 << 24))


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def keep_mask(n: int, rate: float, seed: int, offset: int,
              device=None, index: Index = None) -> torch.Tensor:
    """[n] bool keep mask of the plain twin (True = kept)."""
    return (philox_bits(n, seed, offset, device, index) >> 8) >= (
        _threshold(rate))


def dropout_ref(x: torch.Tensor, rate: float, seed: int,
                offset: int, index: Index = None) -> torch.Tensor:
    """Plain twin of the kernel: ``x * keep / (1 - rate)`` with the mask of
    ``keep_mask`` over ``x``'s flat (row-major) elements; the product in
    float32 (float64 for double), rounded once to ``x.dtype``."""
    acc = _acc(x.dtype)
    keep = keep_mask(x.numel(), rate, seed, offset, x.device, index)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=acc, device=x.device)
    factor = torch.where(keep.reshape(x.shape), scale, 0.0)
    return (x.to(acc) * factor).to(x.dtype)


def _check(x, rate, seed, offset, index):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} is not in [0, 1)")
    if index is not None and not (index[0] >= 0
                                  and 0 < index[1] <= index[2]):
        raise ValueError(f"index map {index} is not (base >= 0, "
                         f"0 < span_local <= span_global)")
    if not (0 <= seed < 1 << 64 and 0 <= offset < 1 << 64):
        raise ValueError(f"seed {seed} and offset {offset} must be "
                         f"unsigned 64-bit integers")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dropout takes a float tensor, got {x.dtype}")


def _run(x: torch.Tensor, rate: float, seed: int, offset: int,
         index: Index) -> torch.Tensor:
    if x.device.type == "cpu":
        return dropout_ref(x, rate, seed, offset, index)
    if x.device.type != "cuda":
        raise ValueError(f"no dropout kernel for device {x.device}")
    from wav2vec_s_tpu_torch.ops import native

    x = x.contiguous()
    with torch.cuda.device(x.device):
        lib = native.library()
        out = torch.empty_like(x)
        base, span_local, span_global = index or (0, max(x.numel(), 1),
                                                  max(x.numel(), 1))
        err = lib.w2vs_dropout(
            x.data_ptr(), out.data_ptr(), x.numel(), seed, offset,
            _threshold(rate), 1.0 / (1.0 - rate), _DTYPE_CODES[x.dtype],
            base, span_local, span_global,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dropout kernel launch failed: CUDA error {err}")
    hw_dropout.launches += 1
    return out


class _HwDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed, offset, index):
        ctx.args = (rate, seed, offset, index)
        return _run(x, rate, seed, offset, index)

    @staticmethod
    def backward(ctx, dy):
        # the same (seed, offset, index) regenerates the forward's mask
        return _run(dy, *ctx.args), None, None, None, None


def hw_dropout(x: torch.Tensor, rate: float, seed: int, offset: int,
               index: Index = None) -> torch.Tensor:
    """``x * keep / (1 - rate)`` with the mask of ``(seed, offset)``;
    ``index`` places a shard's elements in the whole tensor (module
    docstring).

    Rate 0 returns ``x`` and launches nothing (eval mode passes no
    ``DropoutContext`` and never calls this).  CPU tensors
    run the twin; CUDA tensors launch the kernel (count in
    ``hw_dropout.launches``, forward and backward) or raise."""
    if rate == 0.0:
        return x
    _check(x, rate, seed, offset, index)
    if index is not None:
        index = tuple(int(v) for v in index)
    return _HwDropout.apply(x, float(rate), int(seed), int(offset), index)


hw_dropout.launches = 0


#: a site split along one axis (context parallelism's time rows, tensor
#: parallelism's heads or hidden columns): (axis, first index held, length
#: of the whole axis)
SeqSplit = Tuple[int, int, int]


class DropoutContext:
    """The randomness of one training forward.

    ``seed``: the step's 63-bit base seed, drawn once from ``generator``;
    each dropout site (``ctx(x, rate)``) takes the next ``offset`` (the
    count of sites so far, in ``sites``).  ``layer_dropped``, ``randint``,
    ``uniform`` and ``normal`` draw layerdrop decisions, decoder position
    offsets, contrastive negatives, Gumbel noise and the MMA energy noise
    on the host from the same generator.  Give it a CPU generator: the
    draws then need no device-to-host sync, and a card run draws what a
    CPU run does.  A context always means training: inference passes
    ``ctx=None`` (see ``drop``).

    ``shard``: this rank's rows of the batch under data parallelism.  Every
    site then drops the rows' part of the whole batch's mask, and
    ``randint`` / ``uniform`` draw the whole batch's values and return the
    rows' (the generator stays equal on every rank), so a sharded step
    draws what one process over the whole batch draws.  Every tensor a
    site or a draw sees must be batch-major (the rows outermost)."""

    shard: Optional["Shard"] = None

    def __init__(self, generator: torch.Generator,
                 shard: Optional["Shard"] = None):
        self.generator = generator
        self.seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=generator))
        self.sites = 0
        self.shard = shard

    def __call__(self, x: torch.Tensor, rate: float,
                 seq: Optional[SeqSplit] = None) -> torch.Tensor:
        """Drop ``x``; ``seq`` = (axis, start, total) when ``x`` holds the
        indices [start, start + x.shape[axis]) of an axis of ``total``
        (context parallelism's time rows, tensor parallelism's heads or
        hidden columns)."""
        if rate == 0.0:
            return x
        return hw_dropout(x, rate, *self.next_site(),
                          index=self.index(tuple(x.shape), seq))

    def index(self, shape, seq: Optional[SeqSplit] = None) -> Index:
        """The index map of a site's tensor of ``shape`` (None when it is
        the whole tensor)."""
        sh = self.shard
        if sh is None and seq is None:
            return None
        whole = list(shape)
        if sh is not None:
            if shape[0] != sh.rows:
                raise ValueError(f"a dropout site of {tuple(shape)} is not "
                                 f"batch-major over {sh.rows} rows")
            whole[0] = sh.total
        axis = start = 0
        if seq is not None:
            axis, start, total = seq
            whole[axis] = total
        base = start * math.prod(shape[axis + 1:])
        if sh is not None:
            base += sh.start * math.prod(whole[1:])
        if seq is None:
            n = max(math.prod(shape), 1)
            return base, n, n
        return (base, max(math.prod(shape[axis:]), 1),
                max(math.prod(whole[axis:]), 1))

    def first_row(self) -> int:
        """The batch row this rank's first row is (0 unsharded): the base
        of the flash kernels' attention-dropout index."""
        return 0 if self.shard is None else self.shard.start

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

    def _whole(self, shape):
        """(the whole batch's shape, this rank's slice of its leading axis)
        of a draw of ``shape``, whose leading axis is the rows times a
        whole number."""
        sh = self.shard
        if sh is None:
            return tuple(shape), slice(None)
        k, rem = divmod(shape[0], sh.rows)
        if rem:
            raise ValueError(f"a draw of {tuple(shape)} is not batch-major "
                             f"over {sh.rows} rows")
        return ((sh.total * k,) + tuple(shape[1:]),
                slice(sh.start * k, sh.stop * k))

    def randint(self, high: int, shape) -> torch.Tensor:
        """CPU int64 tensor of draws in [0, high)."""
        whole, rows = self._whole(shape)
        return torch.randint(0, high, whole, generator=self.generator)[rows]

    def normal(self, shape) -> torch.Tensor:
        """CPU float32 tensor of standard normal draws (the MMA training
        noise, the JAX ``mono_noise`` stream's ``jax.random.normal``)."""
        whole, rows = self._whole(shape)
        return torch.randn(whole, generator=self.generator)[rows]

    def uniform(self, shape) -> torch.Tensor:
        """CPU float32 tensor of draws in [1e-10, 1) (the JAX quantizer's
        ``uniform(minval=1e-10, maxval=1.0)``)."""
        whole, rows = self._whole(shape)
        return torch.rand(whole, generator=self.generator)[rows].clamp_(
            min=1e-10)


def replayed(fn, generator: torch.Generator):
    """``fn`` for ``torch.utils.checkpoint``, which restores the global
    RNGs in its recompute and knows nothing of the step's own draws.  The
    first call draws from ``generator`` (``fn`` builds its
    ``DropoutContext`` from it, so the seed of every K4 site comes from
    it too) as it would; every later call (the recompute in the backward)
    starts from the state the first call started from, so each K4 site
    takes its first seed and offset again and layerdrop, the negatives,
    the Gumbel uniforms and the MMA noise draw what they drew, and leaves
    ``generator`` as the first call left it, whether the recompute runs
    to its end or the checkpoint stops it early."""
    marks = []

    def run(*args, **kwargs):
        if not marks:
            marks.append(generator.get_state())
            out = fn(*args, **kwargs)
            marks.append(generator.get_state())
            return out
        generator.set_state(marks[0])
        try:
            return fn(*args, **kwargs)
        finally:
            generator.set_state(marks[1])

    return run


def drop(ctx: Optional[DropoutContext], x: torch.Tensor, rate: float,
         seq: Optional[SeqSplit] = None) -> torch.Tensor:
    """``ctx(x, rate, seq)``, or ``x`` when there is no context
    (inference)."""
    return x if ctx is None else ctx(x, rate, seq)
