"""Block-sparse flash attention, forward and backward: CUDA kernel wrappers
and their plain twins.

The one-shot blockwise encoder attends the full utterance (T frames plus
the rc look-ahead copies) under the wav2vec-S block mask.  Port of the
Pallas kernels of ``wav2vec_s_tpu/ops/pallas_attention.py``: the forward
(``_flash_attn_impl``, kernel ``csrc/flash_attention.cu``), the backward
(``_flash_attn_bwd``, kernels ``csrc/flash_attention_bwd.cu``) and the
in-kernel attention dropout (``_keep_scale``, ``csrc/flash_common.cuh``);
the sources' headers say what bounds them and how they are laid out.

``blockwise_flash_attention_packed`` checks its arguments, then runs the
twin for CPU tensors and launches the kernel for CUDA tensors; a build or
launch failure raises, it never falls back to the twin.  Under autograd
(grad mode on and q, k or v requiring grad) it goes through a
``torch.autograd.Function``: the forward always writes the row stats ``m``,
``l`` and saves them with q, k, v, out and the mask; the backward
(``blockwise_flash_attention_bwd``, CPU: ``blockwise_flash_attention_bwd_ref``)
returns dq, dk, dv.  Under ``torch.no_grad()`` nothing is saved.

Attention dropout acts on the normalised probabilities (``l`` sums the
plain ``p``, the value product takes ``p * keep``; ``m`` and ``l`` do not
depend on it).  The keep mask is a function of the element's coordinates in
the [B, H, S, S] probabilities: K4's Philox scheme (``ops/dropout.py``) on
the flat index, under the step ``seed`` and the site ``offset``.  A shard
places itself in the whole batch's [B_all, H_all, S, S] probabilities: a
data-parallel shard whose first row is row ``dropout_row0`` of the whole
batch, a tensor-parallel rank whose first head is head ``dropout_h0`` of
``dropout_heads`` (None: ``H``, the shard holds every head), so element
(b, h, q, k) takes the bits of index ``((row0 + b) * H_all + h0 + h) * S *
S + q * S + k``, and its masks are the matching part of the whole
batch's.  The defaults (``row0 = h0 = 0``, ``H_all = H``) give the index
of an unsharded call.  The twin's
mask is ``keep_mask(B*H*S*S, ...)`` reshaped, bit-equal to the kernels';
flash training therefore equals dense training, which drops the
materialised probabilities at the same site, under one seed.

The twins: ``blockwise_flash_attention_ref`` is the JAX package's own jnp
reference (``pallas_attention.py:388-405``): f32 logits, ``NEG`` for masked
pairs and padded keys, f32 softmax, P.V in f32, cast at the end;
``blockwise_flash_attention_bwd_ref`` repeats the backward kernel's
formulas step by step on [B, H, S, S] tensors.

Two sets of kernels compute the same function, and ``kernel_path`` chooses
between them from the dtype and the head width alone: bfloat16 inputs with
heads of 32, 64 or 128 dims run on the tensor cores
(``csrc/flash_attention_mma.cu``, ``csrc/flash_attention_bwd_mma.cu``:
``mma.sync`` on bf16 tiles staged by ``cp.async``, 64 x 64 tiles);
float32 inputs and every other head width run on the CUDA cores
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``: f32 FMAs,
32 x 64 tiles).  Each wrapper counts its launches in ``.launches`` and, per
set, in ``.path_launches``.

The kernels read host-built tables of tile kinds (``tile_kinds``: skip,
full or partial for each tile of the layout, and of the transposed layout
for the dK/dV kernel, at the tile sizes of the chosen path), uploaded once
per layout and device; inside partial tiles they derive the mask from the
layout rule, so no bias buffer exists.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from wav2vec_s_tpu_torch.ops.block_mask import block_layout
from wav2vec_s_tpu_torch.ops.dropout import _threshold, keep_mask
from wav2vec_s_tpu_torch.ops.native import (  # noqa: F401  (kernel_path)
    CUDA_CORE, TENSOR_CORE, aligned_kernel_path, kernel_path)

NEG = -1e9                 # the TPU kernel's additive mask (not MASK_VALUE)
_MAX_DH = 128              # kMaxDh in csrc/flash_common.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: (rows per block, columns per tile) of each path's tile-kind table:
#: kTileRows in csrc/flash_mma.cuh; kRows, kTile in csrc/flash_common.cuh
TILES = {TENSOR_CORE: (64, 64), CUDA_CORE: (32, 64)}


def _bias(key_padding_mask, seq_len, main_context, right_context):
    """[B, 1, S, S] float32 additive mask: NEG per forbidden pair plus NEG
    per padded key."""
    allowed = torch.as_tensor(
        block_layout(seq_len, main_context, right_context).allowed,
        device=key_padding_mask.device)
    return (torch.where(allowed, 0.0, NEG)[None, None]
            + torch.where(key_padding_mask, NEG, 0.0)[:, None, None, :])


def _keep_scale(B, H, S, rate, seed, offset, device, row0=0, h0=0,
                heads=None):
    """[B, H, S, S] float32 tensor of 0 or 1/(1 - rate) (the kernels' keep
    mask), or None when ``rate`` is 0."""
    if not rate:
        return None
    n = B * H * S * S
    heads = H if heads is None else heads
    index = None
    if row0 or h0 or heads != H:
        index = ((row0 * heads + h0) * S * S, H * S * S, heads * S * S)
    keep = keep_mask(n, rate, seed, offset, device, index)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32,
                         device=device)
    return torch.where(keep.reshape(B, H, S, S), scale, 0.0)


def _split(t, H):
    B, S, D = t.shape
    return t.reshape(B, S, H, D // H).transpose(1, 2).float()


def _merge(t, dtype):
    B, H, S, dh = t.shape
    return t.to(dtype).transpose(1, 2).reshape(B, S, H * dh)


def blockwise_flash_attention_ref(q, k, v, key_padding_mask, num_heads: int,
                                  seq_len: int, main_context: int,
                                  right_context: int,
                                  dropout_rate: float = 0.0,
                                  dropout_seed: int = 0,
                                  dropout_offset: int = 0,
                                  dropout_row0: int = 0,
                                  dropout_h0: int = 0,
                                  dropout_heads=None):
    """Plain PyTorch twin; same arguments as
    ``blockwise_flash_attention_packed``.  Returns ``(out, m, l)``: out
    [B, S, D] in ``q.dtype``, and the row max ``m`` and row sum of
    ``exp(logit - m)`` ``l``, both [B, H, S] float32."""
    B, S, D = q.shape
    H = num_heads
    s = torch.einsum("bhqd,bhkd->bhqk", _split(q, H), _split(k, H))
    s = s * (D // H) ** -0.5 + _bias(key_padding_mask, seq_len, main_context,
                                     right_context)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    p = e / l[..., None]
    keep = _keep_scale(B, H, S, dropout_rate, dropout_seed, dropout_offset,
                       q.device, dropout_row0, dropout_h0, dropout_heads)
    if keep is not None:
        p = p * keep
    o = torch.einsum("bhqk,bhkd->bhqd", p, _split(v, H))
    return _merge(o, q.dtype), m, l


def blockwise_flash_attention_bwd_ref(q, k, v, out, dout, m, l,
                                      key_padding_mask, num_heads: int,
                                      seq_len: int, main_context: int,
                                      right_context: int,
                                      dropout_rate: float = 0.0,
                                      dropout_seed: int = 0,
                                      dropout_offset: int = 0,
                                      dropout_row0: int = 0,
                                      dropout_h0: int = 0,
                                      dropout_heads=None):
    """Plain PyTorch twin of the backward kernels, formula by formula
    (``csrc/flash_attention_bwd.cu``): from the forward's inputs, its
    ``out`` and row stats ``m``, ``l`` and the cotangent ``dout`` to
    ``(dq, dk, dv)``, [B, S, D] in ``q.dtype``; every sum in float32."""
    B, S, D = q.shape
    H = num_heads
    scale = (D // H) ** -0.5
    qs, kh, vh = _split(q, H) * scale, _split(k, H), _split(v, H)
    do = _split(dout, H)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kh) + _bias(
        key_padding_mask, seq_len, main_context, right_context)
    p = torch.exp(s - m[..., None]) / l.clamp(min=1e-20)[..., None]
    keep = _keep_scale(B, H, S, dropout_rate, dropout_seed, dropout_offset,
                       q.device, dropout_row0, dropout_h0, dropout_heads)
    dvec = (do * _split(out, H)).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vh)
    pt = p
    if keep is not None:
        pt, dp = p * keep, dp * keep
    dv = torch.einsum("bhqk,bhqd->bhkd", pt, do)
    ds = p * (dp - dvec)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs)
    return tuple(_merge(t, q.dtype) for t in (dq, dk, dv))


#: tile tables kept: pre-training meets 9 length buckets x 7 context
#: buckets x (forward, transposed) tables per kernel set
TABLE_CACHE = 512


@functools.lru_cache(maxsize=TABLE_CACHE)
def tile_kinds(seq_len: int, main_context: int, right_context: int,
               q_tile: int, k_tile: int,
               transposed: bool = False) -> np.ndarray:
    """[ceil(S / q_tile), ceil(S / k_tile)] int8 table of the layout's
    tiles: 0 no allowed pair (skipped), 1 every in-range pair allowed (no
    structural mask), 2 partial.  Pairs past S do not count.
    ``transposed``: the table of the transposed layout, q_tile keys by
    k_tile queries, that the dK/dV kernel walks."""
    allowed = block_layout(seq_len, main_context, right_context).allowed
    if transposed:
        allowed = allowed.T
    S = allowed.shape[0]
    nq, nk = -(-S // q_tile), -(-S // k_tile)

    def tiles(fill):
        ext = np.full((nq * q_tile, nk * k_tile), fill)
        ext[:S, :S] = allowed
        return ext.reshape(nq, q_tile, nk, k_tile)

    some = tiles(False).any(axis=(1, 3))
    every = tiles(True).all(axis=(1, 3))
    return np.where(every, 1, np.where(some, 2, 0)).astype(np.int8)


@functools.lru_cache(maxsize=TABLE_CACHE)
def _kinds_on(seq_len: int, main_context: int, right_context: int,
              device: str, path: str,
              transposed: bool = False) -> torch.Tensor:
    return torch.from_numpy(tile_kinds(
        seq_len, main_context, right_context, *TILES[path],
        transposed)).to(device)


def _check(q, k, v, key_padding_mask, num_heads, seq_len, main_context,
           right_context, dropout_rate, dropout_seed, dropout_offset,
           dropout_row0=0, dropout_h0=0, dropout_heads=None):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout rate {dropout_rate} is not in [0, 1)")
    if dropout_row0 < 0:
        raise ValueError(f"dropout_row0 {dropout_row0} is negative")
    heads = num_heads if dropout_heads is None else dropout_heads
    if not 0 <= dropout_h0 <= heads - num_heads:
        raise ValueError(f"heads [{dropout_h0}, {dropout_h0 + num_heads}) "
                         f"are not among dropout_heads={heads}")
    if not (0 <= dropout_seed < 1 << 64 and 0 <= dropout_offset < 1 << 64):
        raise ValueError(f"seed {dropout_seed} and offset {dropout_offset} "
                         f"must be unsigned 64-bit integers")
    if q.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)} is not [B, S, D]")
    B, S, D = q.shape
    if num_heads < 1 or D % num_heads or D // num_heads > _MAX_DH:
        raise ValueError(f"D={D} must split into {num_heads} heads of at "
                         f"most {_MAX_DH} dims")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
    if main_context < 1 or right_context < 0:
        raise ValueError(f"bad block layout mc={main_context} "
                         f"rc={right_context}")
    total = block_layout(seq_len, main_context, right_context).total_len
    if S != total:
        raise ValueError(f"S={S} is not the layout's length {total} "
                         f"(T={seq_len}, mc={main_context}, "
                         f"rc={right_context})")
    if (key_padding_mask.shape != (B, S)
            or key_padding_mask.dtype != torch.bool):
        raise ValueError(f"key_padding_mask must be [{B}, {S}] bool, got "
                         f"{tuple(key_padding_mask.shape)} "
                         f"{key_padding_mask.dtype}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype, float32 or "
                         "bfloat16")
    if any(t.device != q.device for t in (k, v, key_padding_mask)):
        raise ValueError("all tensors must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")


def _contiguous(*tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the flash-attention kernels take contiguous "
                         "tensors")


def _path_of(q, num_heads, *packed):
    """The kernel set of a CUDA call; the tensor-core kernels copy 16 bytes
    at a time, so their [B, S, D] tensors must start on a 16-byte
    boundary."""
    return aligned_kernel_path(q.dtype, q.shape[2] // num_heads, packed,
                               "flash-attention")


def _count(wrapper, path):
    wrapper.launches += 1
    wrapper.path_launches[path] += 1


def _forward(q, k, v, key_padding_mask, layout, drop, want_stats: bool):
    """Twin (CPU) or kernel K2 (CUDA) -> (out, m, l); m and l are None on
    CUDA unless ``want_stats``.  ``layout`` = (num_heads, seq_len, mc, rc),
    ``drop`` = (rate, seed, offset, row0, h0, heads)."""
    if q.device.type == "cpu":
        return blockwise_flash_attention_ref(q, k, v, key_padding_mask,
                                             *layout, *drop)
    _contiguous(q, k, v, key_padding_mask)
    from wav2vec_s_tpu_torch.ops import native

    B, S, D = q.shape
    H, seq_len, mc, rc = layout
    rate, seed, offset, row0, h0, heads = drop
    path = _path_of(q, H, q, k, v)
    with torch.cuda.device(q.device):
        lib = native.library()
        kernel = (lib.w2vs_flash_attention_mma if path == TENSOR_CORE
                  else lib.w2vs_flash_attention)
        kinds = _kinds_on(seq_len, mc, rc, str(q.device), path)
        out = torch.empty_like(q)
        m = l = None
        if want_stats:
            m = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
            l = torch.empty_like(m)
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_padding_mask.data_ptr(), kinds.data_ptr(), out.data_ptr(),
            None if m is None else m.data_ptr(),
            None if l is None else l.data_ptr(),
            B, S, D, H, seq_len, mc, rc, _DTYPE_CODES[q.dtype], seed, offset,
            (row0 * heads + h0) * S * S, heads, _threshold(rate),
            1.0 / (1.0 - rate), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA "
                           f"error {err}")
    _count(blockwise_flash_attention_packed, path)
    return out, m, l


def blockwise_flash_attention_bwd(q, k, v, out, dout, m, l, key_padding_mask,
                                  num_heads: int, seq_len: int,
                                  main_context: int, right_context: int,
                                  dropout_rate: float = 0.0,
                                  dropout_seed: int = 0,
                                  dropout_offset: int = 0,
                                  dropout_row0: int = 0,
                                  dropout_h0: int = 0,
                                  dropout_heads=None):
    """The backward of ``blockwise_flash_attention_packed``: the forward's
    inputs, its ``out`` [B, S, D] and row stats ``m``, ``l`` [B, H, S]
    float32, and the cotangent ``dout`` [B, S, D] -> ``(dq, dk, dv)`` in
    ``q.dtype``, under the same dropout arguments as the forward.  CPU
    tensors run ``blockwise_flash_attention_bwd_ref``; CUDA tensors launch
    the backward kernels K3 (one count in
    ``blockwise_flash_attention_bwd.launches`` per call, and in its
    ``path_launches`` under the kernel set that ran) or raise."""
    _check(q, k, v, key_padding_mask, num_heads, seq_len, main_context,
           right_context, dropout_rate, dropout_seed, dropout_offset,
           dropout_row0, dropout_h0, dropout_heads)
    B, S, D = q.shape
    H = num_heads
    heads = H if dropout_heads is None else int(dropout_heads)
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype),
                                  ("dout", dout, q.shape, q.dtype),
                                  ("m", m, (B, H, S), torch.float32),
                                  ("l", l, (B, H, S), torch.float32)):
        if t.shape != shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(shape)} {dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if q.device.type == "cpu":
        return blockwise_flash_attention_bwd_ref(
            q, k, v, out, dout, m, l, key_padding_mask, num_heads, seq_len,
            main_context, right_context, dropout_rate, dropout_seed,
            dropout_offset, dropout_row0, dropout_h0, dropout_heads)
    _contiguous(q, k, v, out, dout, m, l, key_padding_mask)
    from wav2vec_s_tpu_torch.ops import native

    path = _path_of(q, H, q, k, v, out, dout)
    with torch.cuda.device(q.device):
        lib = native.library()
        kernel = (lib.w2vs_flash_attention_bwd_mma if path == TENSOR_CORE
                  else lib.w2vs_flash_attention_bwd)
        layout = (seq_len, main_context, right_context, str(q.device), path)
        kinds, kinds_t = _kinds_on(*layout), _kinds_on(*layout, True)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        dvec = torch.empty_like(m)
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), m.data_ptr(), l.data_ptr(),
            key_padding_mask.data_ptr(), kinds.data_ptr(),
            kinds_t.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dvec.data_ptr(), B, S, D, H, seq_len, main_context,
            right_context, _DTYPE_CODES[q.dtype], dropout_seed,
            dropout_offset, (dropout_row0 * heads + dropout_h0) * S * S,
            heads, _threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash-attention backward kernel launch failed: "
                           f"CUDA error {err}")
    _count(blockwise_flash_attention_bwd, path)
    return dq, dk, dv


blockwise_flash_attention_bwd.launches = 0
blockwise_flash_attention_bwd.path_launches = {TENSOR_CORE: 0, CUDA_CORE: 0}


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, layout, drop):
        out, m, l = _forward(q, k, v, key_padding_mask, layout, drop, True)
        ctx.save_for_backward(q, k, v, out, m, l, key_padding_mask)
        ctx.args = layout + drop
        ctx.mark_non_differentiable(m, l)
        return out, m, l

    @staticmethod
    def backward(ctx, dout, _dm, _dl):
        q, k, v, out, m, l, key_padding_mask = ctx.saved_tensors
        # dout is often a view of the out_proj input's gradient
        grads = blockwise_flash_attention_bwd(
            q, k, v, out, dout.contiguous(), m, l, key_padding_mask,
            *ctx.args)
        return (*grads, None, None, None)


def blockwise_flash_attention_packed(q, k, v, key_padding_mask,
                                     num_heads: int, seq_len: int,
                                     main_context: int, right_context: int,
                                     dropout_rate: float = 0.0,
                                     return_stats: bool = False,
                                     dropout_seed: int = 0,
                                     dropout_offset: int = 0,
                                     dropout_row0: int = 0,
                                     dropout_h0: int = 0,
                                     dropout_heads=None):
    """q, k, v: [B, S, D] packed projections (head h at columns
    ``h*dh:(h+1)*dh``, q NOT pre-scaled), S = ``block_layout(seq_len,
    main_context, right_context).total_len``; key_padding_mask: [B, S]
    bool, True = padded key (the extended mask, rc copies included).
    ``dropout_rate`` > 0 drops the normalised probabilities with the mask
    of ``(dropout_seed, dropout_offset)`` (one site of the step's
    ``DropoutContext``) at the index of the batch row ``dropout_row0`` on
    (a data-parallel shard's first row; 0 for a whole batch) and of the
    head ``dropout_h0`` of ``dropout_heads`` (a tensor-parallel rank's
    first head and the whole head count; 0 and None for every head).

    Returns [B, S, D] in ``q.dtype`` (padded query rows hold anything;
    callers strip them), or ``(out, m, l)`` with the [B, H, S] float32 row
    stats when ``return_stats``.  Differentiable in q, k and v.  CPU
    tensors run the plain twins; CUDA tensors launch the kernels of
    ``kernel_path(q.dtype, D // num_heads)`` (counts in
    ``blockwise_flash_attention_packed.launches`` and
    ``blockwise_flash_attention_bwd.launches``, per kernel set in their
    ``path_launches``) or raise."""
    _check(q, k, v, key_padding_mask, num_heads, seq_len, main_context,
           right_context, dropout_rate, dropout_seed, dropout_offset,
           dropout_row0, dropout_h0, dropout_heads)
    layout = (num_heads, seq_len, main_context, right_context)
    drop = (float(dropout_rate), int(dropout_seed), int(dropout_offset),
            int(dropout_row0), int(dropout_h0),
            int(num_heads if dropout_heads is None else dropout_heads))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type == "cuda":
            q, k, v = (t.contiguous() for t in (q, k, v))
        res = _FlashAttention.apply(q, k, v, key_padding_mask, layout, drop)
    else:
        res = _forward(q, k, v, key_padding_mask, layout, drop, return_stats)
    return res if return_stats else res[0]


blockwise_flash_attention_packed.launches = 0
blockwise_flash_attention_packed.path_launches = {TENSOR_CORE: 0,
                                                  CUDA_CORE: 0}
