"""Incremental-chunk attention: CUDA kernel wrapper and its plain twin.

The incremental blockwise encoder attends a chunk of R new rows against
(a) the committed time-major K/V cache (rows < t0) and (b) the chunk itself
under the intra-chunk block bias.  Port of the Pallas kernel
``wav2vec_s_tpu/ops/chunk_attention.py``; the kernel is
``csrc/chunk_attention.cu`` (its header says what bounds it and how it is
laid out), the twin ``chunk_cache_attention_ref`` is the two-part einsum
softmax of ``wav2vec_s_tpu/stream/incremental.py:231-256``.

``chunk_cache_attention`` checks its arguments, then runs the twin for CPU
tensors and launches the kernel for CUDA tensors; a build or launch failure
raises, it never falls back to the twin.  Inference only, no backward.
"""

from __future__ import annotations

import torch

from wav2vec_s_tpu_torch.ops.block_mask import MASK_VALUE

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DH = 128             # kMaxDh in csrc/chunk_attention.cu


def _split(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, Dh]."""
    B, T, D = x.shape
    return x.reshape(B, T, n_heads, D // n_heads).transpose(1, 2)


def chunk_cache_attention_ref(q, k_cache, v_cache, k_new, v_new, intra_bias,
                              t0: int, n_heads: int) -> torch.Tensor:
    """Plain PyTorch twin; same arguments as ``chunk_cache_attention``.

    Logits in f32 against all ``kv_cap`` cache rows (rows >= t0 masked with
    ``MASK_VALUE``) and against the chunk rows plus ``intra_bias``; one
    shared max; probabilities cast to the input dtype before P.V."""
    B, R, D = q.shape
    T = k_cache.shape[0]
    H, Dh = n_heads, D // n_heads
    qh = _split(q, H).float()                            # [B, H, R, Dh]
    kc = k_cache.reshape(T, B, H, Dh)
    vc = v_cache.reshape(T, B, H, Dh)
    bias_c = torch.where(torch.arange(T, device=q.device) < t0, 0.0,
                         MASK_VALUE)                     # [T]
    lg_cache = torch.einsum("bhqd,tbhd->bhqt", qh, kc.float()) + bias_c
    lg_intra = (torch.einsum("bhqd,bhkd->bhqk", qh, _split(k_new, H).float())
                + intra_bias)
    m = torch.maximum(lg_cache.amax(-1, keepdim=True),
                      lg_intra.amax(-1, keepdim=True))
    e1 = torch.exp(lg_cache - m)
    e2 = torch.exp(lg_intra - m)
    inv = 1.0 / (e1.sum(-1, keepdim=True) + e2.sum(-1, keepdim=True))
    p1 = (e1 * inv).to(q.dtype)
    p2 = (e2 * inv).to(q.dtype)
    o = (torch.einsum("bhqt,tbhd->bhqd", p1, vc)
         + torch.einsum("bhqk,bhkd->bhqd", p2, _split(v_new, H)))
    return o.transpose(1, 2).reshape(B, R, D)


def _check(q, k_cache, v_cache, k_new, v_new, intra_bias, t0, n_heads):
    B, R, D = q.shape
    if D % n_heads or D // n_heads > _MAX_DH:
        raise ValueError(f"D={D} must split into {n_heads} heads of at most "
                         f"{_MAX_DH} dims")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
    if k_cache.dim() != 3 or k_cache.shape[1:] != (B, D):
        raise ValueError(f"k_cache {tuple(k_cache.shape)} is not "
                         f"[T, {B}, {D}]")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"v_cache {tuple(v_cache.shape)} != k_cache "
                         f"{tuple(k_cache.shape)}")
    if intra_bias.shape != (R, R) or intra_bias.dtype != torch.float32:
        raise ValueError(f"intra_bias must be [{R}, {R}] float32, got "
                         f"{tuple(intra_bias.shape)} {intra_bias.dtype}")
    if not 0 <= t0 <= k_cache.shape[0]:
        raise ValueError(f"t0={t0} outside the cache [0, {k_cache.shape[0]}]")
    tensors = (q, k_cache, v_cache, k_new, v_new, intra_bias)
    if q.dtype not in _DTYPE_CODES or any(
            t.dtype != q.dtype for t in tensors[1:5]):
        raise ValueError("q, caches and new K/V must share one dtype, "
                         "float32 or bfloat16")
    if any(t.device != q.device for t in tensors):
        raise ValueError("all tensors must be on one device")


def chunk_cache_attention(q, k_cache, v_cache, k_new, v_new, intra_bias,
                          t0: int, n_heads: int) -> torch.Tensor:
    """q/k_new/v_new: [B, R, D] chunk rows (q pre-scaled by Dh**-0.5);
    k_cache/v_cache: time-major [kv_cap, B, D], rows < ``t0`` committed;
    intra_bias: [R, R] float32 additive block mask; t0: host int.  Returns
    [B, R, D] in ``q.dtype``.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (count
    in ``chunk_cache_attention.launches``) or raise."""
    t0 = int(t0)
    _check(q, k_cache, v_cache, k_new, v_new, intra_bias, t0, n_heads)
    if q.device.type == "cpu":
        return chunk_cache_attention_ref(q, k_cache, v_cache, k_new, v_new,
                                         intra_bias, t0, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no chunk attention for device {q.device}")
    tensors = (q, k_cache, v_cache, k_new, v_new, intra_bias)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the chunk-attention kernel takes contiguous tensors")
    from wav2vec_s_tpu_torch.ops import native

    B, R, D = q.shape
    with torch.cuda.device(q.device):
        lib = native.library()
        out = torch.empty_like(q)
        err = lib.w2vs_chunk_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), intra_bias.data_ptr(),
            out.data_ptr(), B, R, D, n_heads, t0, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"chunk-attention kernel launch failed: CUDA "
                           f"error {err}")
    chunk_cache_attention.launches += 1
    return out


chunk_cache_attention.launches = 0
