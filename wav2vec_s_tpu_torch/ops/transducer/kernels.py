"""Transducer lattice kernels: the CUDA wrappers of ``csrc/transducer_warp.cu``
(the warp set) and ``csrc/transducer.cu`` (the block set).

- ``alphas`` (K5a, replaces ``pallas_kernel.pallas_alphas``): the forward
  lattice;
- ``betas`` (K5b, replaces ``pallas_kernel.pallas_betas``): the backward
  lattice on the virtually extended lattice, ragged lengths;
- ``affine_rows`` (K6, replaces ``pallas_kernel.pallas_affine_rows``): the
  probability-space row recursion of the expected delay, forward or
  reverse;
- ``alphas_and_expected_delay`` (the forward fused walk: K5a and the
  forward K6 in one kernel) and ``betas_and_expected_delay_bwd`` (the
  reverse fused walk: K5b and the reverse K6), which the loss runs.

No training path calls the three single recursions or ``lattice``'s
``rows=`` hook: they stay so that each TPU kernel's computation can be
held alone against its twin and against float64 (``chip_smoke.py`` phase
5, ``tests/test_torch_port_gpu.py``).  A numeric fault of a fused walk is
found by running its recursions one at a time, as the block set's delay
error past U 256 was (PERF.md).

``lattice_path(U)`` chooses the kernel set from the label cells alone: the
warp set (one warp per lattice, heads in registers) up to ``WARP_MAX_U``,
the block set (one block per lattice, heads in shared memory) beyond.  Both
sets have all five kernels.  Each wrapper runs its twin in ``lattice.py``
for CPU tensors and launches its kernel for CUDA tensors (count in
``<fn>.launches`` and, per kernel set, in ``<fn>.path_launches``).  Before
a launch a wrapper checks its arguments and nothing else; a failed check,
build or launch raises, there is no fallback.  The kernels take contiguous
float32 [B, T, U] lattices, delay values at any strides, and lengths on the
lattice's device (int32 or int64; the block set's ``betas`` copies them to
int32).
"""

from __future__ import annotations

import torch

from wav2vec_s_tpu_torch.ops.transducer import lattice

#: the two kernel sets: ``csrc/transducer_warp.cu``, ``csrc/transducer.cu``
WARP, BLOCK = "warp", "block"
WARP_MAX_U = 256          # 32 lanes x 8 columns (transducer_warp.cu kMaxU)


def lattice_path(U: int) -> str:
    """Which kernel set a CUDA call of the lattice wrappers runs for a
    lattice of ``U`` label cells."""
    return WARP if U <= WARP_MAX_U else BLOCK


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


def _lens(x: torch.Tensor, *lens: torch.Tensor):
    """(pointer, 1 if int64 else 0) of each [B] length tensor."""
    out = []
    for n in lens:
        if (n.shape != x.shape[:1] or n.device != x.device
                or n.dtype not in (torch.int32, torch.int64)
                or not n.is_contiguous()):
            raise ValueError(f"lengths {tuple(n.shape)} {n.dtype} on "
                             f"{n.device} are not [{x.shape[0]}] int32 or "
                             f"int64 on {x.device}")
        out += [n.data_ptr(), int(n.dtype == torch.int64)]
    return out


def _delay(dv: torch.Tensor):
    """(pointer, element strides) of the delay values."""
    if dv.dtype != torch.float32:
        raise ValueError(f"delay values {dv.dtype} are not float32")
    return [dv.data_ptr(), *dv.stride()]


def _done(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _launched(fn, path: str) -> None:
    fn.launches += 1
    fn.path_launches[path] += 1


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
            path = lattice_path(U)
            fn = (lib.w2vs_lattice_warp_alphas if path == WARP
                  else lib.w2vs_transducer_alphas)
            _done(fn(lp_blank.data_ptr(), lp_emit.data_ptr(), out.data_ptr(),
                     B, T, U, stream), "alphas")
            _launched(alphas, path)
    return out


def betas(lp_blank, lp_emit, act_lens, label_lens) -> torch.Tensor:
    """Backward lattice scores [B, T, U] (``lattice.betas``' first
    output)."""
    _check(lp_blank, lp_emit)
    if lp_blank.device.type == "cpu":
        return lattice.betas(lp_blank, lp_emit, act_lens, label_lens)[0]
    B, T, U = lp_blank.shape
    with torch.cuda.device(lp_blank.device):
        lib, stream = _cuda_args(lp_blank, lp_emit)
        out = torch.empty_like(lp_blank)
        path = lattice_path(U)
        if path == BLOCK:       # the block set reads int32 lengths
            act_lens, label_lens = (n.to(lp_blank.device, torch.int32)
                                    .contiguous()
                                    for n in (act_lens, label_lens))
        lens = _lens(lp_blank, act_lens, label_lens)
        if out.numel():
            if path == WARP:
                err = lib.w2vs_lattice_warp_betas(
                    lp_blank.data_ptr(), lp_emit.data_ptr(), *lens,
                    out.data_ptr(), B, T, U, stream)
            else:
                err = lib.w2vs_transducer_betas(
                    lp_blank.data_ptr(), lp_emit.data_ptr(), lens[0],
                    lens[2], out.data_ptr(), B, T, U, stream)
            _done(err, "betas")
            _launched(betas, path)
    return out


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
            path = lattice_path(U)
            fn = (lib.w2vs_lattice_warp_affine_rows if path == WARP
                  else lib.w2vs_transducer_affine_rows)
            _done(fn(a.data_ptr(), pb.data_ptr(), c.data_ptr(),
                     out.data_ptr(), B, T, U, int(reverse), stream),
                  "affine_rows")
            _launched(affine_rows, path)
    return out


def alphas_and_expected_delay(lp_blank: torch.Tensor, lp_emit: torch.Tensor,
                              delay_values: torch.Tensor):
    """(alphas, ad), each [B, T, U] (``lattice.alphas_and_expected_delay``):
    one forward fused walk."""
    _check(lp_blank, lp_emit, delay_values)
    if lp_blank.device.type == "cpu":
        return lattice.alphas_and_expected_delay(lp_blank, lp_emit,
                                                 delay_values)
    B, T, U = lp_blank.shape
    with torch.cuda.device(lp_blank.device):
        lib, stream = _cuda_args(lp_blank, lp_emit)
        dv = _delay(delay_values)
        a, ad = torch.empty_like(lp_blank), torch.empty_like(lp_blank)
        if a.numel():
            path = lattice_path(U)
            fn = (lib.w2vs_lattice_warp_alphas_delay if path == WARP
                  else lib.w2vs_transducer_alphas_delay)
            _done(fn(lp_blank.data_ptr(), lp_emit.data_ptr(), *dv,
                     a.data_ptr(), ad.data_ptr(), B, T, U, stream),
                  "alphas_and_expected_delay")
            _launched(alphas_and_expected_delay, path)
    return a, ad


def betas_and_expected_delay_bwd(lp_blank, lp_emit, act_lens, label_lens,
                                 delay_values):
    """(betas, bd), each [B, T, U]
    (``lattice.betas_and_expected_delay_bwd``): one reverse fused walk."""
    _check(lp_blank, lp_emit, delay_values)
    if lp_blank.device.type == "cpu":
        return lattice.betas_and_expected_delay_bwd(
            lp_blank, lp_emit, act_lens, label_lens, delay_values)
    B, T, U = lp_blank.shape
    with torch.cuda.device(lp_blank.device):
        lib, stream = _cuda_args(lp_blank, lp_emit)
        lens = _lens(lp_blank, act_lens, label_lens)
        dv = _delay(delay_values)
        be, bd = torch.empty_like(lp_blank), torch.empty_like(lp_blank)
        if be.numel():
            path = lattice_path(U)
            fn = (lib.w2vs_lattice_warp_betas_delay if path == WARP
                  else lib.w2vs_transducer_betas_delay)
            _done(fn(lp_blank.data_ptr(), lp_emit.data_ptr(), *lens, *dv,
                     be.data_ptr(), bd.data_ptr(), B, T, U, stream),
                  "betas_and_expected_delay_bwd")
            _launched(betas_and_expected_delay_bwd, path)
    return be, bd


_WRAPPERS = (alphas, betas, affine_rows, alphas_and_expected_delay,
             betas_and_expected_delay_bwd)
for _fn in _WRAPPERS:
    _fn.launches = 0
    _fn.path_launches = {WARP: 0, BLOCK: 0}
