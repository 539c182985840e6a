"""One-query attention over a time-major cache: CUDA kernel K7 and its plain
version.

The greedy emission loop attends one query per stream against a time-major
K/V cache on every iteration and layer: the jointer against the encoder
frames, the LM against its own prefix (``stream/caat_step.py``).  Each
stream sees only part of the cache: the rows ``lo <= t < hi`` it is told to
load, and of those, where a boolean plane is given, the rows the plane
shows.  K7 (``csrc/decode_attention.cu``) reads the plane's byte of each row
in ``[lo, hi)`` and the K and V of each row it shows once, in the cache's
dtype, and keeps the f32 logits and softmax on chip; it replaces no TPU
kernel (the JAX package left these attentions to XLA).  Its bound: the rows
loaded and visible x D x 2 bytes (bf16) x 2, plus the plane's bytes, over
3.35 TB/s.

``decode_attention`` checks its arguments (on every device, so a CPU test
sees what the card would refuse), then runs ``decode_attention_ref`` for CPU
tensors and launches the kernel for CUDA tensors; a build or launch failure
raises, it never falls back to the plain version.  It launches on the
current stream and reads nothing back, so a CUDA graph can capture it, and
counts its launches in ``decode_attention.launches``.
"""

from __future__ import annotations

import torch

from wav2vec_s_tpu_torch.ops.block_mask import MASK_VALUE

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DH = 128             # kMaxDh in csrc/decode_attention.cu


def decode_attention_ref(q, k_cache, v_cache, n_heads: int, *, lo=None,
                         hi=None, plane=None) -> torch.Tensor:
    """The plain version; same arguments as ``decode_attention``.

    What ``stream/caat_step.py`` computed before the kernel: logits in f32
    over the whole cache, ``MASK_VALUE`` added where the plane hides a
    loaded row, the softmax in f32, the probabilities cast to ``q.dtype``
    before P.V; rows outside ``[lo, hi)`` weigh exactly 0, and a stream
    with no loaded row the plane shows gets zeros."""
    T, N, D = k_cache.shape
    H = n_heads
    Dh = D // H
    t = torch.arange(T, device=q.device)[None]
    loaded = torch.ones((1, T), dtype=torch.bool, device=q.device)
    if hi is not None:
        loaded = loaded & (t < hi.reshape(-1, 1))
    if lo is not None:
        loaded = loaded & (t >= lo.reshape(-1, 1))
    loaded = loaded.expand(N, T)
    seen = loaded if plane is None else loaded & plane
    bias = torch.where(loaded, torch.where(seen, 0.0, MASK_VALUE),
                       float("-inf"))                         # [N, T]
    qh = q.reshape(N, H, Dh).float()
    kh = k_cache.reshape(T, N, H, Dh).float()
    vh = v_cache.reshape(T, N, H, Dh).to(q.dtype)
    logits = torch.einsum("nhd,tnhd->nht", qh, kh) * (Dh ** -0.5)
    p = torch.softmax(logits + bias[:, None, :], dim=-1).to(q.dtype)
    o = torch.einsum("nht,tnhd->nhd", p, vh).reshape(N, D)
    return torch.where(seen.any(-1)[:, None], o, 0)


def _check_bound(name, b, N, device):
    if b is None:
        return
    if not isinstance(b, torch.Tensor) or b.dtype != torch.int64:
        raise ValueError(f"{name} must be an int64 tensor")
    if b.shape not in ((), (N,)):
        raise ValueError(f"{name} {tuple(b.shape)} is neither [] nor [{N}]")
    if b.device != device:
        raise ValueError(f"{name} is on {b.device}, q on {device}")


def _check(q, k_cache, v_cache, n_heads, lo, hi, plane):
    if q.dim() != 2:
        raise ValueError(f"q {tuple(q.shape)} is not [N, D]")
    N, D = q.shape
    if D % n_heads or D // n_heads > _MAX_DH:
        raise ValueError(f"D={D} must split into {n_heads} heads of at most "
                         f"{_MAX_DH} dims")
    if k_cache.dim() != 3 or k_cache.shape[1:] != (N, D):
        raise ValueError(f"k_cache {tuple(k_cache.shape)} is not "
                         f"[T, {N}, {D}]")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"v_cache {tuple(v_cache.shape)} != k_cache "
                         f"{tuple(k_cache.shape)}")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype or (
            v_cache.dtype != q.dtype):
        raise ValueError(f"q, k_cache and v_cache must share one dtype, "
                         f"float32 or bfloat16: {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    if q.stride(1) != 1:
        raise ValueError(f"q's rows must be contiguous, strides "
                         f"{q.stride()}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not c.is_contiguous():
            raise ValueError(f"{name} must be contiguous, strides "
                             f"{c.stride()}")
    T = k_cache.shape[0]
    if plane is not None and (plane.dtype != torch.bool
                              or plane.shape != (N, T)):
        raise ValueError(f"plane must be bool [{N}, {T}], got "
                         f"{plane.dtype} {tuple(plane.shape)}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("plane", plane)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    _check_bound("lo", lo, N, q.device)
    _check_bound("hi", hi, N, q.device)


def decode_attention(q, k_cache, v_cache, n_heads: int, *, lo=None, hi=None,
                     plane=None) -> torch.Tensor:
    """q: [N, D] (rows contiguous, float32 or bfloat16); k_cache/v_cache:
    contiguous time-major [T, N, D] of q's dtype; lo/hi: int64 row bounds
    ``[N]`` or ``[]`` (one for every stream), None for 0 / T; plane: bool
    ``[N, T]`` of any strides (serving's ``vis``, cut to the cache's
    rows), True where a row is visible, or None.  Returns [N, D] in
    ``q.dtype``: per head, the softmax of ``q . k * Dh**-0.5`` (plus
    ``MASK_VALUE`` where the plane says no) over rows ``lo <= t < hi``,
    times V; zeros for a stream with no such row the plane shows.

    CPU tensors run ``decode_attention_ref``; CUDA tensors launch K7
    (counted in ``decode_attention.launches``) or raise."""
    _check(q, k_cache, v_cache, n_heads, lo, hi, plane)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, n_heads, lo=lo,
                                    hi=hi, plane=plane)
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention for device {q.device}")
    T, N, D = k_cache.shape
    from wav2vec_s_tpu_torch.ops import native

    def bound(b):
        return (None, 0) if b is None else (b.data_ptr(),
                                            b.stride(0) if b.dim() else 0)

    plane_args = ((None, 0, 0) if plane is None
                  else (plane.data_ptr(), *plane.stride()))
    with torch.cuda.device(q.device):
        lib = native.library()
        out = torch.empty((N, D), dtype=q.dtype, device=q.device)
        err = lib.w2vs_decode_attention(
            q.data_ptr(), q.stride(0), k_cache.data_ptr(), v_cache.data_ptr(),
            *bound(lo), *bound(hi), *plane_args, MASK_VALUE,
            (D // n_heads) ** -0.5, out.data_ptr(), T, N, D, n_heads,
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode-attention kernel launch failed: CUDA "
                           f"error {err} (T={T}, N={N}, D={D}, "
                           f"heads={n_heads}; the logits of T rows must fit "
                           f"in shared memory)")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
