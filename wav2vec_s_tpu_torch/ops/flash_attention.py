"""Block-sparse flash attention forward: CUDA kernel wrapper and its plain twin.

The one-shot blockwise encoder attends the full utterance (T frames plus
the rc look-ahead copies) under the wav2vec-S block mask.  Port of the
forward of the Pallas kernel ``wav2vec_s_tpu/ops/pallas_attention.py``
(``_flash_attn_impl``); the kernel is ``csrc/flash_attention.cu`` (its
header says what bounds it and how it is laid out).  The twin
``blockwise_flash_attention_ref`` is the JAX package's own jnp reference
(``pallas_attention.py:388-405``, dropout off): f32 logits, ``NEG`` for
masked pairs and padded keys, f32 softmax, P.V in f32, cast at the end.

``blockwise_flash_attention_packed`` checks its arguments, then runs the
twin for CPU tensors and launches the kernel for CUDA tensors; a build or
launch failure raises, it never falls back to the twin.  Inference only:
dropout raises, and so does a call under autograd with inputs that require
grad, on every device (the kernel has no backward until the flash backward
K3 is ported; a CUDA result would silently lose its gradient).

The kernel reads a host-built table of tile kinds (``tile_kinds``: skip,
full or partial for each ``Q_TILE x K_TILE`` tile of the layout), uploaded
once per layout and device; inside partial tiles it derives the mask from
the layout rule, so no bias buffer exists.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from wav2vec_s_tpu_torch.ops.block_mask import block_layout

NEG = -1e9                 # the TPU kernel's additive mask (not MASK_VALUE)
Q_TILE = 32                # kRows in csrc/flash_attention.cu
K_TILE = 64                # kTile in csrc/flash_attention.cu
_MAX_DH = 128              # kMaxDh in csrc/flash_attention.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def blockwise_flash_attention_ref(q, k, v, key_padding_mask, num_heads: int,
                                  seq_len: int, main_context: int,
                                  right_context: int):
    """Plain PyTorch twin; same arguments as
    ``blockwise_flash_attention_packed``.  Returns ``(out, m, l)``: out
    [B, S, D] in ``q.dtype``, and the row max ``m`` and row sum of
    ``exp(logit - m)`` ``l``, both [B, H, S] float32."""
    layout = block_layout(seq_len, main_context, right_context)
    B, S, D = q.shape
    H = num_heads
    dh = D // H
    allowed = torch.as_tensor(layout.allowed, device=q.device)
    bias = (torch.where(allowed, 0.0, NEG)[None, None]
            + torch.where(key_padding_mask, NEG, 0.0)[:, None, None, :])

    def split(t):
        return t.reshape(B, S, H, dh).transpose(1, 2).float()

    s = torch.einsum("bhqd,bhkd->bhqk", split(q), split(k)) * dh ** -0.5
    s = s + bias
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", e / l[..., None], split(v))
    return o.to(q.dtype).transpose(1, 2).reshape(B, S, D), m, l


@functools.lru_cache(maxsize=64)
def tile_kinds(seq_len: int, main_context: int,
               right_context: int) -> np.ndarray:
    """[ceil(S / Q_TILE), ceil(S / K_TILE)] int8 table of the layout's
    tiles: 0 no allowed pair (skipped), 1 every in-range pair allowed (no
    structural mask), 2 partial.  Pairs past S do not count."""
    allowed = block_layout(seq_len, main_context, right_context).allowed
    S = allowed.shape[0]
    nq, nk = -(-S // Q_TILE), -(-S // K_TILE)

    def tiles(fill):
        ext = np.full((nq * Q_TILE, nk * K_TILE), fill)
        ext[:S, :S] = allowed
        return ext.reshape(nq, Q_TILE, nk, K_TILE)

    some = tiles(False).any(axis=(1, 3))
    every = tiles(True).all(axis=(1, 3))
    return np.where(every, 1, np.where(some, 2, 0)).astype(np.int8)


@functools.lru_cache(maxsize=64)
def _kinds_on(seq_len: int, main_context: int, right_context: int,
              device: str) -> torch.Tensor:
    return torch.from_numpy(
        tile_kinds(seq_len, main_context, right_context)).to(device)


def no_grad_guard(name: str, why: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need a backward that the kernel lacks:
    grad mode on and an input that requires grad.  The same on every
    device, so the CPU twin does not train where the card could not."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} has no backward ({why}); call it "
                                  f"under torch.no_grad()")


def _check(q, k, v, key_padding_mask, num_heads, seq_len, main_context,
           right_context, dropout_rate):
    no_grad_guard("blockwise_flash_attention_packed",
                  "the flash-attention backward K3, wav2vec_s_tpu/ops/"
                  "pallas_attention.py _flash_attn_bwd, is not ported yet: "
                  "train with attention_impl='dense'", q, k, v)
    if dropout_rate:
        raise NotImplementedError("attention dropout needs the training "
                                  "kernels; this is the inference forward")
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


def blockwise_flash_attention_packed(q, k, v, key_padding_mask,
                                     num_heads: int, seq_len: int,
                                     main_context: int, right_context: int,
                                     dropout_rate: float = 0.0,
                                     return_stats: bool = False):
    """q, k, v: [B, S, D] packed projections (head h at columns
    ``h*dh:(h+1)*dh``, q NOT pre-scaled), S = ``block_layout(seq_len,
    main_context, right_context).total_len``; key_padding_mask: [B, S]
    bool, True = padded key (the extended mask, rc copies included).

    Returns [B, S, D] in ``q.dtype`` (padded query rows hold anything;
    callers strip them), or ``(out, m, l)`` with the [B, H, S] float32 row
    stats when ``return_stats``.  CPU tensors run the plain twin; CUDA
    tensors launch the kernel (count in
    ``blockwise_flash_attention_packed.launches``) or raise."""
    _check(q, k, v, key_padding_mask, num_heads, seq_len, main_context,
           right_context, dropout_rate)
    if q.device.type == "cpu":
        res = blockwise_flash_attention_ref(
            q, k, v, key_padding_mask, num_heads, seq_len, main_context,
            right_context)
        return res if return_stats else res[0]
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v, key_padding_mask)):
        raise ValueError("the flash-attention kernel takes contiguous "
                         "tensors")
    from wav2vec_s_tpu_torch.ops import native

    B, S, D = q.shape
    H = num_heads
    with torch.cuda.device(q.device):
        lib = native.library()
        kinds = _kinds_on(seq_len, main_context, right_context, str(q.device))
        out = torch.empty_like(q)
        m = l = None
        if return_stats:
            m = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
            l = torch.empty_like(m)
        err = lib.w2vs_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_padding_mask.data_ptr(), kinds.data_ptr(), out.data_ptr(),
            None if m is None else m.data_ptr(),
            None if l is None else l.data_ptr(),
            B, S, D, H, seq_len, main_context, right_context,
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA "
                           f"error {err}")
    blockwise_flash_attention_packed.launches += 1
    return (out, m, l) if return_stats else out


blockwise_flash_attention_packed.launches = 0
