"""Transducer lattice: the plain-torch pieces and the row-scan twins of the
lattice kernels.

Port of ``wav2vec_s_tpu/ops/transducer/jnp_impl.py`` and the lattice half
of ``analytic.py``.  Layouts follow the reference C API (rnnt.h:107-140):
``acts [B, T, U, V]`` unnormalised (U = labels + 1 cells); cell (t, u) ->
emit consumes ``labels[u]`` with delay cost ``delay_values[t, u + 1]``;
blank is free.

- ``lattice_lse``, ``lattice_log_probs_lse``, ``gather_final``, the masks
  and the delay costs are plain torch on every device (XLA ran them on the
  TPU).
- ``alphas``, ``betas`` and ``affine_rows`` are the twins of the kernels in
  ``kernels.py`` (``csrc/transducer_warp.cu``, ``csrc/transducer.cu``): the
  JAX package's row scans, one Python step per source row with a prefix
  log-sum-exp (``torch.logcumsumexp``) or a Hillis-Steele affine prefix
  along U.  ``expected_delay`` and ``expected_delay_bwd`` build the
  transition probabilities elementwise from the stored alphas (betas) and
  run a row recursion given as ``rows`` (the twin by default, K6 through
  ``kernels.affine_rows`` in the card's checks).
- ``alphas_and_expected_delay`` and ``betas_and_expected_delay_bwd``, the
  twins of the fused walks, are those pieces in sequence.

Every function keeps float64 inputs in float64 (the gradient check) and
computes everything else in float32.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

# "minus infinity" that survives a cumulative sum over the U axis in f32
BLOCK = -1e9


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def lattice_lse(acts: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp over the vocabulary, [B, T, U] in float32."""
    return torch.logsumexp(acts.to(_acc(acts.dtype)), dim=-1)


def lattice_log_probs_lse(acts: torch.Tensor, labels: torch.Tensor,
                          blank: int):
    """-> (lp_blank, lp_emit, lse), each [B, T, U]; lp_emit's last column
    is padding (0).  Only two columns of the normalised log-probs are read,
    so the full [B, T, U, V] log-softmax is never formed."""
    B, T, U, V = acts.shape
    lse = lattice_lse(acts)
    lp_blank = acts[..., blank].to(lse.dtype) - lse
    idx = labels.long()[:, None, :, None].expand(B, T, U - 1, 1)
    emit = torch.gather(acts[:, :, :-1], -1, idx)[..., 0].to(lse.dtype)
    lp_emit = F.pad(emit - lse[:, :, :-1], (0, 1))
    return lp_blank, lp_emit, lse


def gather_final(x: torch.Tensor, act_lens: torch.Tensor,
                 label_lens: torch.Tensor) -> torch.Tensor:
    """x: [B, T, U] -> x[b, T_b - 1, U_b]."""
    bi = torch.arange(x.shape[0], device=x.device)
    return x[bi, act_lens.long() - 1, label_lens.long()]


def lattice_masks(shape, act_lens: torch.Tensor, label_lens: torch.Tensor):
    """-> (t_valid [B, T], emit_ok [B, T, U])."""
    B, T, U = shape
    dev = act_lens.device
    t_valid = torch.arange(T, device=dev)[None, :] < act_lens[:, None]
    u_emit = torch.arange(U, device=dev)[None, :] < label_lens[:, None]
    return t_valid, u_emit[:, None, :] & t_valid[:, :, None]


# --- delay cost schedules (twin of warprnnt_pytorch/delay_transducer.py) ---

def delay_cost_zero(shape, act_lens, label_lens):
    """dv[b, t, u] = t / T_b; lengths clamped to >= 1 (a zero-length pad
    row would give 0/0 = NaN in the backward even where masked)."""
    B, T, U1 = shape
    t = torch.arange(T, dtype=torch.float32,
                     device=act_lens.device)[None, :, None]
    al = act_lens.clamp(min=1).float()[:, None, None]
    return (t / al).expand(B, T, U1)


def _diag_terms(shape, act_lens, label_lens):
    B, T, U1 = shape
    dev = act_lens.device
    src = torch.arange(T, dtype=torch.float32, device=dev)[None, :, None] + 1
    tgt = torch.arange(U1, dtype=torch.float32, device=dev)[None, None, :] + 1
    al = act_lens.clamp(min=1).float()[:, None, None]
    ll = label_lens.clamp(min=1).float()[:, None, None]
    return src * (ll / al) - tgt, ll


def delay_cost_diag_positive(shape, act_lens, label_lens):
    """clamp((t+1) * gamma - (u+1), 0) / U_b, the training default."""
    d, U = _diag_terms(shape, act_lens, label_lens)
    return d.clamp(min=0.0) / U


def delay_cost_diagonal(shape, act_lens, label_lens):
    d, U = _diag_terms(shape, act_lens, label_lens)
    return d.abs() / U


DELAY_FUNCS = {
    "zero": delay_cost_zero,
    "diagonal": delay_cost_diagonal,
    "diag_positive": delay_cost_diag_positive,
}


# --- the row-scan twins of the lattice kernels ---

def alphas(lp_blank: torch.Tensor, lp_emit: torch.Tensor) -> torch.Tensor:
    """Forward lattice scores [B, T, U] (twin of K5a):
    alpha(t, u) = ecum(t, u) + prefixLSE_k<=u[alpha(t-1, k) + blank(t-1, k)
    - ecum(t, k)], ecum the running sum of row t's emission log-probs."""
    T = lp_blank.shape[1]
    ecum = F.pad(torch.cumsum(lp_emit[:, :, :-1], dim=2), (1, 0))
    rows = [ecum[:, 0]]
    for t in range(1, T):
        z = rows[-1] + lp_blank[:, t - 1] - ecum[:, t]
        rows.append(ecum[:, t] + torch.logcumsumexp(z, dim=1))
    return torch.stack(rows, dim=1)


def betas(lp_blank, lp_emit, act_lens, label_lens):
    """Backward scores [B, T, U] on the virtually extended lattice (twin of
    K5b): rows t >= T_b pass blanks through with log-prob 0, emits outside
    u < U_b, t < T_b are BLOCKed, and the virtual row t = T is 0 at
    u = U_b, BLOCK elsewhere.  Returns (betas, lp_b_eff, t_valid, emit_ok).
    Cells that only reach the end through a BLOCKed edge hold BLOCK-sized
    values whose digits differ between this twin and the kernel; no
    gradient reads them."""
    B, T, U = lp_blank.shape
    t_valid, emit_ok = lattice_masks((B, T, U), act_lens, label_lens)
    lp_e_eff = torch.where(emit_ok, lp_emit, BLOCK)
    lp_b_eff = torch.where(t_valid[:, :, None], lp_blank, 0.0)
    # f(u) = sum_{j<u} effective emit(t, j)
    f = F.pad(torch.cumsum(lp_e_eff[:, :, :-1], dim=2), (1, 0))
    u_idx = torch.arange(U, device=lp_blank.device)[None, :]
    beta = torch.where(u_idx == label_lens[:, None], 0.0,
                       BLOCK).to(lp_blank.dtype)
    rows = [None] * T
    for t in range(T - 1, -1, -1):
        z = beta + lp_b_eff[:, t] + f[:, t]
        zrev = torch.logcumsumexp(z.flip(1), dim=1).flip(1)
        beta = zrev - f[:, t]
        rows[t] = beta
    return torch.stack(rows, dim=1), lp_b_eff, t_valid, emit_ok


def beta_shifts(betas_: torch.Tensor, label_lens: torch.Tensor):
    """(B(t+1, u) with the virtual row appended, B(t, u+1))."""
    B, T, U = betas_.shape
    u_idx = torch.arange(U, device=betas_.device)[None, None, :]
    virtual = torch.where(u_idx == label_lens[:, None, None], 0.0,
                          BLOCK).to(betas_.dtype)
    beta_down = torch.cat([betas_[:, 1:], virtual], dim=1)
    beta_up = F.pad(betas_[:, :, 1:], (0, 1), value=BLOCK)
    return beta_down, beta_up


def _affine_prefix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix solve of x_u = a_u x_{u-1} + b_u (x_{-1} = 0) along
    the last axis, Hillis-Steele: log2(U) shifted combines."""
    U = a.shape[-1]
    s = 1
    while s < U:
        a_sh = F.pad(a[..., :-s], (s, 0), value=1.0)
        b_sh = F.pad(b[..., :-s], (s, 0), value=0.0)
        b = a * b_sh + b
        a = a * a_sh
        s *= 2
    return b


def affine_rows(a: torch.Tensor, pb: torch.Tensor, c: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
    """x(t, u) = a(t, u) x(t, u-1) + pb(t, u) x(t-1, u) + c(t, u) over
    [B, T, U], zero outside the lattice (twin of K6).  ``reverse`` runs the
    recursion from the far corner: x(t, u) = a x(t, u+1) + pb x(t+1, u) +
    c."""
    if reverse:
        def flip(v):
            return v.flip((1, 2))
        return flip(affine_rows(flip(a), flip(pb), flip(c)))
    prev = torch.zeros_like(a[:, 0])
    rows = []
    for t in range(a.shape[1]):
        prev = _affine_prefix(a[:, t], pb[:, t] * prev + c[:, t])
        rows.append(prev)
    return torch.stack(rows, dim=1)


Rows = Callable[..., torch.Tensor]


def expected_delay(lp_blank, lp_emit, alphas_, delay_values,
                   rows: Rows = affine_rows) -> torch.Tensor:
    """ad[b, t, u] = expected accumulated delay given state (t, u)
    (``jnp_impl._expected_delay``), as one forward affine-rows recursion:
    row 0 is the pure emission chain (a = 1, c = dv past u = 0), the other
    rows take the transition probabilities into (t, u)
    pe = exp(min(alpha(t, u-1) + emit(t, u-1) - alpha(t, u), 0)) (0 at
    u = 0) and pb = exp(min(alpha(t-1, u) + blank(t-1, u) - alpha(t, u),
    0)) (0 at t = 0), with a = pe and c = pe * dv."""
    pe = torch.exp(torch.clamp(
        alphas_[:, :, :-1] + lp_emit[:, :, :-1] - alphas_[:, :, 1:],
        max=0.0))
    pe = F.pad(pe, (1, 0))
    pb = torch.exp(torch.clamp(
        alphas_[:, :-1] + lp_blank[:, :-1] - alphas_[:, 1:], max=0.0))
    pb = F.pad(pb, (0, 0, 1, 0))
    dv = delay_values.to(pe.dtype)
    first = (torch.arange(pe.shape[2], device=pe.device) > 0).to(pe.dtype)
    a = torch.cat([first.expand_as(pe[:, :1]), pe[:, 1:]], dim=1)
    c = torch.cat([first * dv[:, :1], pe[:, 1:] * dv[:, 1:]], dim=1)
    return rows(a.contiguous(), pb.contiguous(), c.contiguous())


def expected_delay_bwd(lp_blank, lp_emit, betas_, beta_down, beta_up,
                       delay_values, t_valid, emit_ok,
                       rows: Rows = affine_rows):
    """bd[t, u] = expected remaining delay from (t, u)
    (``analytic._expected_delay_bwd``): bd(t, u) = pe (bd(t, u+1) +
    dv(t, u+1)) + pb bd(t+1, u), one reverse affine-rows recursion.
    Returns (bd, dv_edge)."""
    lp_b_eff = torch.where(t_valid[:, :, None], lp_blank, 0.0)
    pb = torch.exp(torch.clamp(beta_down + lp_b_eff - betas_, max=0.0))
    pe_arg = torch.where(emit_ok, beta_up + lp_emit - betas_, BLOCK)
    pe = torch.exp(torch.clamp(pe_arg, max=0.0))
    dv_edge = F.pad(delay_values[:, :, 1:].to(pe.dtype), (0, 1))
    bd = rows(pe.contiguous(), pb.contiguous(), (pe * dv_edge).contiguous(),
              reverse=True)
    return bd, dv_edge


def alphas_and_expected_delay(lp_blank, lp_emit, delay_values):
    """(alphas, ad): ``alphas`` then ``expected_delay`` (twin of the
    forward fused walk)."""
    a = alphas(lp_blank, lp_emit)
    return a, expected_delay(lp_blank, lp_emit, a, delay_values)


def betas_and_expected_delay_bwd(lp_blank, lp_emit, act_lens, label_lens,
                                 delay_values):
    """(betas, bd): ``betas``, ``beta_shifts``, then ``expected_delay_bwd``
    (twin of the reverse fused walk)."""
    be, _, t_valid, emit_ok = betas(lp_blank, lp_emit, act_lens, label_lens)
    down, up = beta_shifts(be, label_lens)
    bd, _ = expected_delay_bwd(lp_blank, lp_emit, be, down, up, delay_values,
                               t_valid, emit_ok)
    return be, bd
