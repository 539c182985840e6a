"""Incremental CAAT decode steps: slot-aligned cached LM + cached jointer.

Port of the greedy subset of ``wav2vec_s_tpu/stream/caat_step.py``: the
one-token LM step over a slot-aligned K/V cache and the one-query jointer
pass over pre-projected encoder K/V, so a greedy emission is O(1).  The
functions read the parameters of a ``W2V2CaatModel`` (``model``) and the
``CaatConfig`` (``cfg``).  Attention in the LM and jointer is plain torch,
as the JAX package left it to XLA: logits in f32, probabilities cast to
the compute dtype before P.V.  Cache updates are in place.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F

from wav2vec_s_tpu_torch.models.modules import dense, layer_tail
from wav2vec_s_tpu_torch.models.modules import ln as _ln
from wav2vec_s_tpu_torch.ops.block_mask import MASK_VALUE
from wav2vec_s_tpu_torch.utils.positional import PADDING_IDX, sinusoidal_table


def _dense_qkv(att, x):
    """q/k/v projections as ONE [3D, D] matmul (each output element keeps
    the same contraction as the separate projections)."""
    projs = (att.q_proj, att.k_proj, att.v_proj)
    w = torch.cat([p.weight for p in projs]).to(x.dtype)
    b = torch.cat([p.bias for p in projs]).to(x.dtype)
    return F.linear(x, w, b).chunk(3, dim=-1)


@dataclasses.dataclass
class SlotLMState:
    """Slot-aligned incremental LM state for lockstep greedy decode.

    The K/V row of an emission step is the global step counter ``ptr``,
    the same for every stream; a per-stream validity plane selects each
    stream's prefix keys (attention is a set operation).

    k/v: per-layer [S, N, D]; valid: [S, N] bool; ptr: host int, next
    write slot; h_last: [N, D] jointer query (LM output at the last prefix
    position, after the final norm when pre-LN)."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    valid: torch.Tensor
    ptr: int
    h_last: torch.Tensor


def _attend_slots(q, k_cache, v_cache, valid, n_heads):
    """One-query attention over slot-aligned caches.

    q: [N, D]; k_cache/v_cache: [S, N, D]; valid: [S, N] bool."""
    S, N, D = k_cache.shape
    H, Dh = n_heads, D // n_heads
    qh = q.reshape(N, H, Dh).float()
    kh = k_cache.reshape(S, N, H, Dh).float()
    vh = v_cache.reshape(S, N, H, Dh)
    logits = torch.einsum("nhd,snhd->nhs", qh, kh) * (Dh ** -0.5)
    bias = torch.where(valid.T, 0.0, MASK_VALUE)            # [N, S]
    p = torch.softmax(logits + bias[:, None, :], dim=-1).to(q.dtype)
    return torch.einsum("nhs,snhd->nhd", p, vh).reshape(N, D)


@torch.no_grad()
def lm_slot_step(model, cfg, state: SlotLMState, tokens: torch.Tensor,
                 index: torch.Tensor, advance: torch.Tensor) -> SlotLMState:
    """Consume one token per stream through the IsolatedDecoder.

    tokens: [N] ids appended at prefix position ``index`` ([N], the old
    prefix length — it drives the positional embedding); advance: [N] bool.
    The new K/V rows land at slot ``state.ptr`` and are marked valid only
    where ``advance``; streams that do not advance keep their ``h_last``.
    Updates ``state`` in place and returns it."""
    c = cfg
    D = c.decoder_embed_dim
    lm = model.decoder.lm
    dtype = c.compute_dtype
    embed = lm.embed_tokens.weight.to(dtype)

    x = embed[tokens] * (D ** 0.5)                               # [N, D]
    table = sinusoidal_table(
        c.max_target_positions + PADDING_IDX + 1 + c.rand_pos_decoder, D,
        x.device)
    x = x + table[index + 1 + PADDING_IDX].to(dtype)

    ptr = state.ptr
    # the new row is visible to its own query regardless of ``advance``;
    # the validity plane keeps it only where the stream advances
    state.valid[ptr] = True
    for i, layer in enumerate(lm.layers):
        att = layer.self_attn
        h_in = (_ln(layer.self_attn_layer_norm, x)
                if c.decoder_normalize_before else x)
        q, k1, v1 = _dense_qkv(att, h_in)
        state.k[i][ptr] = k1
        state.v[i][ptr] = v1
        o = _attend_slots(q, state.k[i].to(dtype), state.v[i].to(dtype),
                          state.valid, c.decoder_attention_heads)
        h = dense(att.out_proj, o)
        x = layer_tail(layer, x, h, c.decoder_normalize_before, F.relu)

    if c.decoder_normalize_before:
        x = _ln(lm.layer_norm, x)
    state.valid[ptr] = advance
    state.h_last = torch.where(advance[:, None], x, state.h_last)
    state.ptr = ptr + 1
    return state


def lm_slot_init(model, cfg, n_streams: int, n_slots: int) -> SlotLMState:
    """Empty slot caches + one step on bos (slot 0 = bos, valid for all)."""
    c = cfg
    dtype = c.compute_dtype
    device = model.decoder.lm.embed_tokens.weight.device

    def z():
        return torch.zeros((n_slots, n_streams, c.decoder_embed_dim),
                           dtype=dtype, device=device)

    state = SlotLMState(
        k=[z() for _ in range(c.decoder_layers)],
        v=[z() for _ in range(c.decoder_layers)],
        valid=torch.zeros((n_slots, n_streams), dtype=torch.bool,
                          device=device),
        ptr=0,
        h_last=torch.zeros((n_streams, c.decoder_embed_dim), dtype=dtype,
                           device=device))
    toks = torch.full((n_streams,), c.bos, dtype=torch.long, device=device)
    return lm_slot_step(model, cfg, state, toks,
                        torch.zeros(n_streams, dtype=torch.long,
                                    device=device),
                        torch.ones(n_streams, dtype=torch.bool,
                                   device=device))


@torch.no_grad()
def jointer_kv(model, cfg, x_new: torch.Tensor):
    """Project new encoder frames to per-layer jointer K/V.

    x_new: time-major [n, N, D] -> (k, v) lists of ``jointer_layers``
    tensors [n, N, D] (the reference caches exactly these in
    ExpandMultiheadAttention's incremental state,
    attention_transducer.py:667-684)."""
    ks, vs = [], []
    for layer in model.decoder.jointer.layers:
        ks.append(dense(layer.enc_attn.k_proj, x_new))
        vs.append(dense(layer.enc_attn.v_proj, x_new))
    return ks, vs


def jointer_kv_append(jk, jv, k_new, v_new, t0: int):
    """Write per-layer new-frame K/V into the time-major caches at row
    ``t0``, in place; returns the caches."""
    for cache, new in zip(list(jk) + list(jv), list(k_new) + list(v_new)):
        cache[t0:t0 + new.shape[0]] = new
    return jk, jv


@torch.no_grad()
def jointer_step(model, cfg, h_last: torch.Tensor, jk, jv,
                 visible: torch.Tensor) -> torch.Tensor:
    """Next-symbol log-probs [N, V] (f32) from cached jointer K/V.

    h_last: [N, D] LM state; jk/jv: per-layer time-major [T, N, D];
    visible: [N] number of revealed encoder frames."""
    c = cfg
    D = c.jointer_embed_dim
    H = c.jointer_attention_heads
    Dh = D // H
    t_cap = jk[0].shape[0]
    N = h_last.shape[0]
    dtype = h_last.dtype
    bias = torch.where(
        torch.arange(t_cap, device=h_last.device)[None] < visible[:, None],
        0.0, MASK_VALUE)                                         # [N, T]
    x = h_last
    pre = c.decoder_normalize_before
    for i, layer in enumerate(model.decoder.jointer.layers):
        att = layer.enc_attn
        h = _ln(layer.attn_layer_norm, x) if pre else x
        q = dense(att.q_proj, h).reshape(N, H, Dh).float()
        k = jk[i].reshape(t_cap, N, H, Dh).float()
        v = jv[i].to(dtype).reshape(t_cap, N, H, Dh)
        logits = torch.einsum("nhd,tnhd->nht", q, k) * (Dh ** -0.5)
        p = torch.softmax(logits + bias[:, None, :], dim=-1).to(dtype)
        o = torch.einsum("nht,tnhd->nhd", p, v).reshape(N, D)
        x = x + dense(att.out_proj, o)
        if not pre:
            x = _ln(layer.attn_layer_norm, x)
        h = _ln(layer.final_layer_norm, x) if pre else x
        x = x + dense(layer.fc2, F.relu(dense(layer.fc1, h)))
        if not pre:
            x = _ln(layer.final_layer_norm, x)

    # tied (or separate) vocabulary projection: compute-dtype operands,
    # f32 accumulation and result
    w = model.decoder.transducer_out.output_proj.weight.to(c.compute_dtype)
    logits = x.float() @ w.float().T
    return torch.log_softmax(logits, dim=-1)
