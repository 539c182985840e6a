"""Delay-transducer loss with the analytic forward-backward gradient.

Port of ``wav2vec_s_tpu/ops/transducer/analytic.py``
(``delay_transducer_loss_vjp``): a ``torch.autograd.Function`` whose

- forward runs the alphas and the expected delay in one forward fused walk
  (K5a + K6, ``kernels.alphas_and_expected_delay``) and returns (total,
  prob, delay) per utterance;
- backward runs the betas and the expected remaining delay in one reverse
  fused walk (K5b + K6, ``kernels.betas_and_expected_delay_bwd``), then
  the closed-form gradient w.r.t. ``acts``

    dP/da(t,u,v) = occ p_v - [v==blank] e_b - [v==y_u] e_y           (P=-ll)
    dE/da(t,u,v) = [v==blank] e_b c0 + [v==y_u] e_y c1
                   - p_v (e_b c0 + e_y c1)                           (E=delay)

  with the edge posteriors e_b = exp(min(a + lp_b + B(t+1,u) - ll, 30)),
  e_y = exp(min(a + lp_y + B(t,u+1) - ll, 30)), occ = e_b + e_y,
  c0 = ad + bd(t+1,u) - E, c1 = ad + dv(t,u+1) + bd(t,u+1) - E, and
  p_v = exp(acts - lse) from the saved lse; zero outside the valid cells.

The lattice recursions go through ``kernels.py``: their twins for CPU
tensors, the CUDA kernels for CUDA tensors (a build or launch failure
raises; ``kernels.lattice_path`` picks the kernel set by U).  On the card
the kernels are the path; the TPU package's ``set_lattice_impl`` switch is
not ported.  The gradient assembly is plain torch.

``temperature`` != 1 is the reference's gradient smoothing
(compute_grad_withdelay_smooth_kernel): the probability part's posteriors
are raised to ``temperature``; forward and delay gradient are unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wav2vec_s_tpu_torch.ops.transducer import kernels
from wav2vec_s_tpu_torch.ops.transducer.lattice import (
    BLOCK, beta_shifts, gather_final, lattice_log_probs_lse, lattice_masks)


class DelayTransducerLoss(torch.autograd.Function):
    """apply(acts [B, T, U, V], labels [B, U-1], act_lens [B],
    label_lens [B], delay_values [B, T, U], delay_scale, blank,
    temperature) -> (total, prob, delay), each [B]."""

    @staticmethod
    def forward(ctx, acts, labels, act_lens, label_lens, delay_values,
                delay_scale: float = 1.0, blank: int = 0,
                temperature: float = 1.0):
        lp_blank, lp_emit, lse = lattice_log_probs_lse(acts, labels, blank)
        alphas, ad = kernels.alphas_and_expected_delay(
            lp_blank.contiguous(), lp_emit, delay_values)
        ll = (gather_final(alphas, act_lens, label_lens)
              + gather_final(lp_blank, act_lens, label_lens))
        prob = -ll
        delay = gather_final(ad, act_lens, label_lens)
        total = prob + delay_scale * delay
        ctx.save_for_backward(acts, labels, act_lens, label_lens,
                              delay_values, lp_blank, lp_emit, lse, alphas,
                              ll, ad, delay)
        ctx.args = (delay_scale, blank, temperature)
        return total, prob, delay

    @staticmethod
    def backward(ctx, ct, cp, cd):
        (acts, labels, act_lens, label_lens, delay_values, lp_blank, lp_emit,
         lse, alphas, ll, ad, delay) = ctx.saved_tensors
        delay_scale, blank, temperature = ctx.args
        B, T, U, V = acts.shape

        betas, bd = kernels.betas_and_expected_delay_bwd(
            lp_blank.contiguous(), lp_emit, act_lens, label_lens,
            delay_values)
        t_valid, emit_ok = lattice_masks((B, T, U), act_lens, label_lens)
        lp_b_eff = torch.where(t_valid[:, :, None], lp_blank, 0.0)
        beta_down, beta_up = beta_shifts(betas, label_lens)
        dv_edge = F.pad(delay_values[:, :, 1:].to(betas.dtype), (0, 1))

        E = delay[:, None, None]
        llb = ll[:, None, None]
        # edge posteriors (zero outside the valid lattice)
        e_b = torch.exp(torch.clamp(alphas + lp_b_eff + beta_down - llb,
                                    max=30.0))
        e_b = torch.where(t_valid[:, :, None], e_b, 0.0)
        e_y = torch.exp(torch.where(
            emit_ok, torch.clamp(alphas + lp_emit + beta_up - llb, max=30.0),
            BLOCK))
        occ = e_b + e_y

        bd_down = torch.cat([bd[:, 1:], torch.zeros_like(bd[:, :1])], dim=1)
        bd_up = F.pad(bd[:, :, 1:], (0, 1))
        c0 = ad + bd_down - E
        c1 = ad + dv_edge + bd_up - E

        w_prob = (ct + cp)[:, None, None]
        w_delay = (ct * delay_scale + cd)[:, None, None]
        if temperature != 1.0:
            occ_p, e_b_p, e_y_p = (occ ** temperature, e_b ** temperature,
                                   e_y ** temperature)
        else:
            occ_p, e_b_p, e_y_p = occ, e_b, e_y
        s_pv = w_prob * occ_p - w_delay * (e_b * c0 + e_y * c1)
        s_b = w_prob * e_b_p - w_delay * e_b * c0
        s_y = w_prob * e_y_p - w_delay * e_y * c1

        # posteriors from the saved lse: exp(a - lse) == softmax(a)
        grad = torch.exp(acts.to(lse.dtype) - lse[..., None])
        grad.mul_(s_pv[..., None])
        grad[..., blank] -= s_b
        idx = labels.long()[:, None, :, None].expand(B, T, U - 1, 1)
        grad[:, :, :-1].scatter_add_(-1, idx, -s_y[:, :, :-1, None])
        cell_valid = (t_valid[:, :, None]
                      & (torch.arange(U, device=acts.device)[None, None, :]
                         <= label_lens[:, None, None]))
        grad = torch.where(cell_valid[..., None], grad, 0.0)
        return grad.to(acts.dtype), None, None, None, None, None, None, None


def delay_transducer_loss(acts, labels, act_lens, label_lens, delay_values,
                          delay_scale: float = 1.0, blank: int = 0,
                          temperature: float = 1.0):
    """(total, prob, delay) per utterance, analytic gradient w.r.t.
    ``acts`` (``DelayTransducerLoss``)."""
    return DelayTransducerLoss.apply(acts, labels, act_lens, label_lens,
                                     delay_values, float(delay_scale),
                                     int(blank), float(temperature))
