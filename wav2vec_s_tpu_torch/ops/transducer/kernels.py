"""Transducer lattice kernels: the CUDA wrappers of ``csrc/transducer.cu``.

- ``alphas`` (K5a, replaces ``pallas_kernel.pallas_alphas``): the forward
  lattice;
- ``betas`` (K5b, replaces ``pallas_kernel.pallas_betas``): the backward
  lattice on the virtually extended lattice, ragged lengths;
- ``affine_rows`` (K6, replaces ``pallas_kernel.pallas_affine_rows``): the
  probability-space row recursion of the expected delay, forward or
  reverse.

Each runs its twin in ``lattice.py`` for CPU tensors and launches its
kernel for CUDA tensors (count in ``<fn>.launches``); a build or launch
failure raises, there is no fallback.  The kernels take contiguous float32
[B, T, U] lattices and int32 lengths.
"""

from __future__ import annotations

import torch

from wav2vec_s_tpu_torch.ops.transducer import lattice


def _check(*lats: torch.Tensor) -> None:
    x = lats[0]
    if x.dim() != 3:
        raise ValueError(f"lattice {tuple(x.shape)} is not [B, T, U]")
    for t in lats[1:]:
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"lattices {tuple(t.shape)} on {t.device} and "
                             f"{tuple(x.shape)} on {x.device} differ")


def _cuda_args(*lats: torch.Tensor):
    if lats[0].device.type != "cuda":
        raise ValueError(f"no lattice kernel for device {lats[0].device}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in lats):
        raise ValueError("the lattice kernels take contiguous float32 "
                         "tensors")
    from wav2vec_s_tpu_torch.ops import native

    return native.library(), torch.cuda.current_stream().cuda_stream


def _done(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def alphas(lp_blank: torch.Tensor, lp_emit: torch.Tensor) -> torch.Tensor:
    """Forward lattice scores [B, T, U] (``lattice.alphas``)."""
    _check(lp_blank, lp_emit)
    if lp_blank.device.type == "cpu":
        return lattice.alphas(lp_blank, lp_emit)
    B, T, U = lp_blank.shape
    with torch.cuda.device(lp_blank.device):
        lib, stream = _cuda_args(lp_blank, lp_emit)
        out = torch.empty_like(lp_blank)
        if out.numel():
            _done(lib.w2vs_transducer_alphas(
                lp_blank.data_ptr(), lp_emit.data_ptr(), out.data_ptr(),
                B, T, U, stream), "alphas")
            alphas.launches += 1
    return out


def betas(lp_blank, lp_emit, act_lens, label_lens):
    """Backward lattice scores (``lattice.betas``): returns (betas,
    lp_b_eff, t_valid, emit_ok)."""
    _check(lp_blank, lp_emit)
    if lp_blank.device.type == "cpu":
        return lattice.betas(lp_blank, lp_emit, act_lens, label_lens)
    B, T, U = lp_blank.shape
    t_valid, emit_ok = lattice.lattice_masks((B, T, U), act_lens,
                                             label_lens)
    lp_b_eff = torch.where(t_valid[:, :, None], lp_blank, 0.0)
    with torch.cuda.device(lp_blank.device):
        lib, stream = _cuda_args(lp_blank, lp_emit)
        al = act_lens.to(lp_blank.device, torch.int32).contiguous()
        ll = label_lens.to(lp_blank.device, torch.int32).contiguous()
        if al.shape != (B,) or ll.shape != (B,):
            raise ValueError(f"lengths {tuple(al.shape)}, "
                             f"{tuple(ll.shape)} are not [{B}]")
        out = torch.empty_like(lp_blank)
        if out.numel():
            _done(lib.w2vs_transducer_betas(
                lp_blank.data_ptr(), lp_emit.data_ptr(), al.data_ptr(),
                ll.data_ptr(), out.data_ptr(), B, T, U, stream), "betas")
            betas.launches += 1
    return out, lp_b_eff, t_valid, emit_ok


def affine_rows(a: torch.Tensor, pb: torch.Tensor, c: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
    """x(t, u) = a x(t, u -/+ 1) + pb x(t -/+ 1, u) + c over [B, T, U]
    (``lattice.affine_rows``)."""
    _check(a, pb, c)
    if a.device.type == "cpu":
        return lattice.affine_rows(a, pb, c, reverse)
    B, T, U = a.shape
    with torch.cuda.device(a.device):
        lib, stream = _cuda_args(a, pb, c)
        out = torch.empty_like(a)
        if out.numel():
            _done(lib.w2vs_transducer_affine_rows(
                a.data_ptr(), pb.data_ptr(), c.data_ptr(), out.data_ptr(),
                B, T, U, int(reverse), stream), "affine_rows")
            affine_rows.launches += 1
    return out


alphas.launches = 0
betas.launches = 0
affine_rows.launches = 0
