"""Incremental CAAT decode steps: cached LM + cached jointer.

Port of ``wav2vec_s_tpu/stream/caat_step.py``, the single home of the
streaming decode math shared by the greedy decoders (``stream/batched.py``),
the serving session (``stream/serving.py``) and the beam decoders
(``stream/beam_batched.py``):

- greedy: the one-query jointer pass over pre-projected encoder K/V, the
  one-token LM step over the position-aligned ``LMState``
  (``lm_init``/``lm_step``/``lm_reset``), and ``greedy_emit``, the one
  masked emission body that both decoders and the session run, so a greedy
  emission is O(1);
- beam: the whole-prefix ``lm_prefill`` and its narrow
  ``lm_prefill_extend`` (over ``LMState``), the split prefix|suffix
  ``BeamLMState`` (``lm_beam_init``/``lm_beam_reorder``/``lm_beam_step``)
  and the beam-shaped jointer (``jointer_beam_logits``,
  ``jointer_step_beam``).

The functions read the parameters of a ``W2V2CaatModel`` (``model``) and the
``CaatConfig`` (``cfg``).  The one-query attentions of ``jointer_step`` and
``lm_step`` go through ``ops/decode_attention`` (K7 on the card), which
loads only the rows each stream can see; the beam attentions are plain
torch, as the JAX package left them to XLA.  Both: logits in f32,
probabilities cast to the compute dtype before P.V.  Token ids and cache
indices are int64.  Which functions write their state in place is said in
each docstring.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from wav2vec_s_tpu_torch.models.modules import dense, layer_tail
from wav2vec_s_tpu_torch.models.modules import ln as _ln
from wav2vec_s_tpu_torch.ops.block_mask import MASK_VALUE
from wav2vec_s_tpu_torch.ops.decode_attention import decode_attention
from wav2vec_s_tpu_torch.utils.positional import PADDING_IDX, sinusoidal_table


def _dense_qkv(att, x):
    """q/k/v projections as ONE [3D, D] matmul (each output element keeps
    the same contraction as the separate projections)."""
    projs = (att.q_proj, att.k_proj, att.v_proj)
    w = torch.cat([p.weight for p in projs]).to(x.dtype)
    b = torch.cat([p.bias for p in projs]).to(x.dtype)
    return F.linear(x, w, b).chunk(3, dim=-1)


def _embed_at(model, cfg, tokens: torch.Tensor, positions: torch.Tensor):
    """Scaled token embedding plus the fairseq sinusoidal position: the
    token at prefix index i sits at table row i + 1 + padding_idx.
    ``positions`` broadcasts against ``tokens``."""
    c = cfg
    D = c.decoder_embed_dim
    dtype = c.compute_dtype
    embed = model.decoder.lm.embed_tokens.weight.to(dtype)
    table = sinusoidal_table(
        c.max_target_positions + PADDING_IDX + 1 + c.rand_pos_decoder, D,
        embed.device)
    return (embed[tokens] * (D ** 0.5)
            + table[positions + 1 + PADDING_IDX].to(dtype))


def _final_norm(model, cfg, x):
    """The LM's post-stack norm (pre-LN configurations only)."""
    if cfg.decoder_normalize_before:
        return _ln(model.decoder.lm.layer_norm, x)
    return x


def _vocab_logits(model, cfg, x: torch.Tensor) -> torch.Tensor:
    """Tied (or separate) vocabulary projection: compute-dtype operands,
    f32 accumulation and result."""
    w = model.decoder.transducer_out.output_proj.weight.to(cfg.compute_dtype)
    return x.float() @ w.float().T


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


class SlotPlane(NamedTuple):
    """The serving step's visibility plane with each slot's extent: slot i
    loads the rows ``lo[i] <= t < hi`` and sees those of them that ``vis``
    shows (int64 bounds on the device)."""

    vis: torch.Tensor           # [N, T_cap] bool
    lo: torch.Tensor            # [N]
    hi: torch.Tensor            # []


@torch.no_grad()
def jointer_step(model, cfg, h_last: torch.Tensor, jk, jv,
                 visible) -> torch.Tensor:
    """Next-symbol log-probs [N, V] (f32) from cached jointer K/V.

    h_last: [N, D] LM state; jk/jv: per-layer time-major [T, N, D];
    visible: [N] number of revealed encoder frames (the rows loaded), or,
    for the continuous-batching serving path, whose slots hold scattered
    global rows (``stream/serving.py``), a ``SlotPlane``: the [N, T_cap]
    boolean plane (True = revealed) with the rows each slot loads.  Rows
    that are not loaded would weigh exactly 0 (``ops/decode_attention``)."""
    c = cfg
    H = c.jointer_attention_heads
    t_cap = jk[0].shape[0]
    dtype = h_last.dtype
    if isinstance(visible, SlotPlane):
        plane, lo, hi = visible.vis[:, :t_cap], visible.lo, visible.hi
    else:
        plane, lo, hi = None, None, visible
    x = h_last
    pre = c.decoder_normalize_before
    for i, layer in enumerate(model.decoder.jointer.layers):
        att = layer.enc_attn
        h = _ln(layer.attn_layer_norm, x) if pre else x
        q = dense(att.q_proj, h)
        o = decode_attention(q, jk[i].to(dtype), jv[i].to(dtype), H, lo=lo,
                             hi=hi, plane=plane)
        x = x + dense(att.out_proj, o)
        if not pre:
            x = _ln(layer.attn_layer_norm, x)
        h = _ln(layer.final_layer_norm, x) if pre else x
        x = x + dense(layer.fc2, F.relu(dense(layer.fc1, h)))
        if not pre:
            x = _ln(layer.final_layer_norm, x)

    return torch.log_softmax(_vocab_logits(model, c, x), dim=-1)


# -- the LM cache and the greedy emission body -----------------------------

@dataclasses.dataclass
class LMState:
    """Per-stream incremental LM state, position-aligned.

    k/v: per-layer TIME-MAJOR [U_cap, N, D] caches of the projected
    keys/values (row j = prefix position j); h_last: [N, D] LM output at
    the last prefix position (after the final norm when pre-LN) — the
    jointer query."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    h_last: torch.Tensor


@torch.no_grad()
def lm_step(model, cfg, state: LMState, tokens: torch.Tensor,
            index: torch.Tensor, advance: torch.Tensor) -> LMState:
    """Consume one token per stream through the IsolatedDecoder.

    tokens: [N] ids appended at prefix position ``index`` ([N], the old
    prefix length); advance: [N] bool — streams with False keep their
    ``h_last`` (their K/V rows at ``index`` are written but stay invisible
    until ``index`` grows).  Writes every tensor of ``state`` in place and
    returns it; reads nothing on the host, so a CUDA graph can replay it."""
    c = cfg
    dtype = c.compute_dtype
    x = _embed_at(model, c, tokens, index)                       # [N, D]
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    n_rows = index + 1              # keys j <= index attend: all loaded
    for i, layer in enumerate(model.decoder.lm.layers):
        att = layer.self_attn
        h_in = (_ln(layer.self_attn_layer_norm, x)
                if c.decoder_normalize_before else x)
        q, k1, v1 = _dense_qkv(att, h_in)
        state.k[i][index, rows] = k1.to(state.k[i].dtype)
        state.v[i][index, rows] = v1.to(state.v[i].dtype)
        o = decode_attention(q, state.k[i].to(dtype), state.v[i].to(dtype),
                             c.decoder_attention_heads, hi=n_rows)
        x = layer_tail(layer, x, dense(att.out_proj, o),
                       c.decoder_normalize_before, F.relu)
    x = _final_norm(model, c, x)
    state.h_last.copy_(torch.where(advance[:, None], x, state.h_last))
    return state


def lm_init(model, cfg, n_streams: int, u_cap: int) -> LMState:
    """Zeroed caches of ``u_cap`` rows, reset (``lm_reset``)."""
    c = cfg
    dtype = c.compute_dtype
    device = model.decoder.lm.embed_tokens.weight.device

    def z():
        return torch.zeros((u_cap, n_streams, c.decoder_embed_dim),
                           dtype=dtype, device=device)

    return lm_reset(model, cfg, LMState(
        k=[z() for _ in range(c.decoder_layers)],
        v=[z() for _ in range(c.decoder_layers)],
        h_last=torch.zeros((n_streams, c.decoder_embed_dim), dtype=dtype,
                           device=device)))


def lm_reset(model, cfg, state: LMState) -> LMState:
    """One step on bos at index 0 for every stream (prefix = [bos]), in
    place; returns ``state``.  The rows past the new prefix keep what they
    held: no step loads them, and they are finite (``lm_init`` zeroes
    them), so a reset state steps as a fresh one."""
    toks = torch.full_like(state.h_last[:, 0], cfg.bos, dtype=torch.long)
    return lm_step(model, cfg, state, toks, torch.zeros_like(toks),
                   torch.ones_like(toks, dtype=torch.bool))


@torch.no_grad()
def greedy_emit(model, cfg, lm: LMState, jk, jv, visible,
                prefixes: torch.Tensor, lens: torch.Tensor,
                blocked: torch.Tensor, *, max_emit: int, max_len: int,
                blank: int, pad: int) -> None:
    """``max_emit`` masked greedy emissions of the greedy decoders and the
    serving session, in place in ``prefixes`` [N, max_len + 1], ``lens``
    [N] and ``lm`` (whose caches hold ``max_len`` + 1 rows, or at least one
    more than the longest prefix a caller can reach).

    jk/jv/visible: as ``jointer_step`` takes them; blocked: [N] bool, the
    streams that do not emit at all.  The JAX decoders run a
    ``while_loop`` that exits once every stream has emitted blank; here
    that test would be a host read per emission, so the iterations are
    fixed and masked: a stream that emits blank, reaches ``max_len`` or is
    blocked writes nothing from then on, so the emissions are the same.
    Nothing is read on the host, so a CUDA graph can replay the body.
    ``jointer_step`` is looked up in this module on every call (callers
    replace it to keep or script its log-probs), and its result's pad
    column is set to -inf in place."""
    rows = torch.arange(prefixes.shape[0], device=prefixes.device)
    for _ in range(max_emit):
        lp = jointer_step(model, cfg, lm.h_last, jk, jv, visible)
        lp[:, pad] = -float("inf")
        tok = torch.argmax(lp, dim=-1)           # first maximum, as jnp
        emit = ~blocked & (tok != blank) & (lens < max_len)
        prefixes[rows, lens] = torch.where(emit, tok, prefixes[rows, lens])
        lm_step(model, cfg, lm, tok, lens, emit)
        lens.add_(emit)
        blocked = blocked | ~emit


# -- the beam half ---------------------------------------------------------

def lm_reorder(state: LMState, rows: torch.Tensor) -> LMState:
    """Gather beam rows (the fairseq ``reorder_incremental_state``): rows
    [K] indices into the stream axis of the caches and ``h_last``.  Returns
    a new state with its own tensors."""
    return LMState(k=[k[:, rows] for k in state.k],
                   v=[v[:, rows] for v in state.v],
                   h_last=state.h_last[rows])


@torch.no_grad()
def lm_prefill(model, cfg, tokens: torch.Tensor, lens: torch.Tensor,
               u_cap: int) -> LMState:
    """Full-prefix LM forward that also materializes the per-layer K/V
    caches — one recompute per chunk instead of one per emission: the
    incremental state the prefixes would have produced through ``lm_step``.

    tokens: [K, U] right-padded (bos first); lens: [K]; u_cap >= U cache
    capacity.  Returns an LMState with k/v [u_cap, K, D] and ``h_last`` at
    position lens - 1."""
    c = cfg
    D = c.decoder_embed_dim
    H = c.decoder_attention_heads
    Dh = D // H
    K, U = tokens.shape
    dev = tokens.device
    x = _embed_at(model, c, tokens, torch.arange(U, device=dev)[None])
    causal = torch.triu(torch.full((U, U), MASK_VALUE, device=dev),
                        diagonal=1)
    ks, vs = [], []
    for layer in model.decoder.lm.layers:
        att = layer.self_attn
        h_in = (_ln(layer.self_attn_layer_norm, x)
                if c.decoder_normalize_before else x)
        q, k1, v1 = _dense_qkv(att, h_in)
        qh = q.reshape(K, U, H, Dh).float()
        kh = k1.reshape(K, U, H, Dh).float()
        vh = v1.reshape(K, U, H, Dh)
        logits = torch.einsum("kuhd,kjhd->khuj", qh, kh) * (Dh ** -0.5)
        p = torch.softmax(logits + causal[None, None], dim=-1).to(x.dtype)
        o = torch.einsum("khuj,kjhd->kuhd", p, vh).reshape(K, U, D)
        x = layer_tail(layer, x, dense(att.out_proj, o),
                       c.decoder_normalize_before, F.relu)
        # time-major caches padded to capacity
        pad = (0, 0, 0, 0, 0, u_cap - U)
        ks.append(F.pad(k1.transpose(0, 1), pad))
        vs.append(F.pad(v1.transpose(0, 1), pad))
    x = _final_norm(model, c, x)
    h_last = x[torch.arange(K, device=dev), lens - 1]
    return LMState(k=ks, v=vs, h_last=h_last)


@torch.no_grad()
def lm_prefill_extend(model, cfg, state: LMState, plen: torch.Tensor,
                      tokens: torch.Tensor, new_lens: torch.Tensor
                      ) -> LMState:
    """Extend a prefilled LM cache by a short batch of new tokens.

    The chunk-entry prefix at inter_beam=1 is the previous chunk's prefix
    plus the tokens it emitted (<= max_steps of them), so the new tokens
    attend [existing cache | themselves, causal] in one narrow call
    instead of a full-width ``lm_prefill`` per chunk.

    state: LMState with k/v [u_cap, K, D]; plen: [K] valid prefix lengths
    (incl. bos); tokens: [K, S] right-padded new tokens; new_lens: [K] in
    [0, S].  Returns a new LMState (``state`` is not written): h_last at
    the last valid new token, rows with new_lens == 0 keep theirs.  Only
    rows ``plen + s`` with ``s < new_lens`` change; a row past ``u_cap``
    is dropped, never wrapped or clamped onto another."""
    c = cfg
    D = c.decoder_embed_dim
    H = c.decoder_attention_heads
    Dh = D // H
    dtype = c.compute_dtype
    K, S = tokens.shape
    dev = tokens.device
    u_cap = state.k[0].shape[0]
    steps = torch.arange(S, device=dev)

    x = _embed_at(model, c, tokens, plen[:, None] + steps[None, :])
    pre_bias = torch.where(
        torch.arange(u_cap, device=dev)[None, :] < plen[:, None], 0.0,
        MASK_VALUE)                                              # [K, u_cap]
    causal = torch.triu(torch.full((S, S), MASK_VALUE, device=dev),
                        diagonal=1)
    # cache row r of stream k takes new token r - plen[k] where that is in
    # [0, new_lens[k]); every other row keeps its value
    src = torch.arange(u_cap, device=dev)[:, None] - plen[None, :]
    written = ((src >= 0) & (src < new_lens[None, :]))[..., None]
    src = src.clamp(0, S - 1)[..., None].expand(u_cap, K, D)

    new_k, new_v = [], []
    for i, layer in enumerate(model.decoder.lm.layers):
        att = layer.self_attn
        h_in = (_ln(layer.self_attn_layer_norm, x)
                if c.decoder_normalize_before else x)
        q, k1, v1 = _dense_qkv(att, h_in)
        qh = q.reshape(K, S, H, Dh).float()
        kc = state.k[i].to(dtype).reshape(u_cap, K, H, Dh)
        vc = state.v[i].to(dtype).reshape(u_cap, K, H, Dh)
        lg_pre = (torch.einsum("kshd,ukhd->khsu", qh, kc.float())
                  * (Dh ** -0.5) + pre_bias[:, None, None, :])
        kh = k1.reshape(K, S, H, Dh)
        vh = v1.reshape(K, S, H, Dh)
        lg_new = (torch.einsum("kshd,kjhd->khsj", qh, kh.float())
                  * (Dh ** -0.5) + causal[None, None])
        p = torch.softmax(torch.cat([lg_pre, lg_new], dim=-1),
                          dim=-1).to(x.dtype)
        o = (torch.einsum("khsu,ukhd->kshd", p[..., :u_cap], vc)
             + torch.einsum("khsj,kjhd->kshd", p[..., u_cap:], vh)
             ).reshape(K, S, D)
        x = layer_tail(layer, x, dense(att.out_proj, o),
                       c.decoder_normalize_before, F.relu)
        for out, cache, new in ((new_k, state.k[i], k1),
                                (new_v, state.v[i], v1)):
            rows = torch.gather(new.transpose(0, 1).to(cache.dtype), 0, src)
            out.append(torch.where(written, rows, cache))

    x = _final_norm(model, c, x)
    h_new = x[torch.arange(K, device=dev), (new_lens - 1).clamp(min=0)]
    h_last = torch.where((new_lens > 0)[:, None], h_new, state.h_last)
    return LMState(k=new_k, v=new_v, h_last=h_last)


@dataclasses.dataclass
class BeamLMState:
    """Split-cache incremental LM state for the batched beam search.

    The beam block re-seeds every chunk from at most ``inter_beam`` kept
    prefixes per stream, so the B beams of a stream share their chunk-entry
    prefix.  The cache splits into

    - a PREFIX part, computed once per chunk over the N*IB live seed rows
      and never reordered or written again (pk/pv: per-layer
      [U_pre, NI, D], NI = N*inter_beam; plen: [NI]);
    - a chunk-local SUFFIX part holding only the tokens emitted inside the
      current beam block, slot-aligned on the loop iteration (sk/sv:
      [L, S, N*B, D] STACKED over layers, so a beam reorder is one gather
      per cache; svalid: [S, N*B] bool, the slots each beam's prefix
      holds);
    - ``origin``: [N*B] local seed index in [0, IB) each beam descends
      from — reorders permute beams within a stream, so the shared prefix
      stays valid and only origin, suffix and h_last travel.

    Attention is a set operation, so the softmax over the concatenated
    (prefix | suffix) logits equals the position-aligned ``lm_step``.
    ``sptr`` is a host int, the next suffix slot."""

    pk: List[torch.Tensor]
    pv: List[torch.Tensor]
    plen: torch.Tensor
    origin: torch.Tensor
    sk: torch.Tensor
    sv: torch.Tensor
    svalid: torch.Tensor
    sptr: int
    h_last: torch.Tensor


def lm_beam_init(pre: LMState, plen: torch.Tensor, origin: torch.Tensor,
                 n_slots: int, beams: int) -> BeamLMState:
    """Beam state from a prefilled LMState over the seed rows.

    pre: k/v [U_pre, NI, D], h_last [NI, D]; plen: [NI] prefix lengths
    (incl. bos); origin: [N*B] LOCAL seed index in [0, IB) per beam (dead
    beams borrow a live seed: their -inf scores keep them out of every
    reduction); beams: B."""
    NI, D = pre.h_last.shape
    NB = origin.shape[0]
    IB = NI // (NB // beams)
    dev = origin.device
    shape = (len(pre.k), n_slots, NB, D)
    rows = torch.arange(NB, device=dev) // beams * IB + origin
    return BeamLMState(
        pk=pre.k, pv=pre.v, plen=plen, origin=origin,
        sk=torch.zeros(shape, dtype=pre.k[0].dtype, device=dev),
        sv=torch.zeros(shape, dtype=pre.k[0].dtype, device=dev),
        svalid=torch.zeros((n_slots, NB), dtype=torch.bool, device=dev),
        sptr=0, h_last=pre.h_last[rows])


def lm_beam_reorder(state: BeamLMState, rows: torch.Tensor) -> BeamLMState:
    """Beam-reorder gather: only the chunk-local suffix, the origin
    pointers and h_last travel; the shared prefix caches are untouched.
    ``rows`` must permute beams within a stream (``n*B + origin_beam``).
    Returns a new state whose suffix tensors are its own."""
    return dataclasses.replace(
        state, origin=state.origin[rows], sk=state.sk[:, :, rows],
        sv=state.sv[:, :, rows], svalid=state.svalid[:, rows],
        h_last=state.h_last[rows])


@torch.no_grad()
def lm_beam_step(model, cfg, state: BeamLMState, tokens: torch.Tensor,
                 index: torch.Tensor, advance: torch.Tensor,
                 beams: int) -> BeamLMState:
    """Split-cache twin of ``lm_step`` for the beam block.

    tokens/index/advance: [N*B] as in ``lm_step`` (``index`` is the new
    token's prefix position); the new K/V rows land in the suffix at slot
    ``state.sptr`` and count as valid only where ``advance``.  ``beams`` =
    B groups the row axis as [N, B] for the shared-prefix attention.
    Writes the suffix of ``state`` in place and returns it."""
    c = cfg
    D = c.decoder_embed_dim
    H = c.decoder_attention_heads
    Dh = D // H
    dtype = c.compute_dtype
    NB = tokens.shape[0]
    B = beams
    N = NB // B
    U_pre, NI, _ = state.pk[0].shape
    IB = NI // N
    dev = tokens.device
    ptr = state.sptr
    if ptr >= state.sk.shape[1]:
        raise ValueError(f"beam step {ptr} does not fit the "
                         f"{state.sk.shape[1]} suffix slots")
    n_suf = ptr + 1          # later slots hold nothing yet

    x = _embed_at(model, c, tokens, index)                       # [NB, D]
    org = state.origin.reshape(N, B)
    plen_nb = torch.gather(state.plen.reshape(N, IB), 1, org)    # [N, B]
    pre_bias = torch.where(
        torch.arange(U_pre, device=dev)[None, None] < plen_nb[..., None],
        0.0, MASK_VALUE)                                     # [N, B, U_pre]
    # the new row is visible to its own query whatever ``advance`` says
    state.svalid[ptr] = True
    suf_bias = torch.where(state.svalid[:n_suf].T, 0.0, MASK_VALUE)
    pick = org[:, :, None, None, None]

    for i, layer in enumerate(model.decoder.lm.layers):
        att = layer.self_attn
        h_in = (_ln(layer.self_attn_layer_norm, x)
                if c.decoder_normalize_before else x)
        q, k1, v1 = _dense_qkv(att, h_in)
        state.sk[i, ptr] = k1.to(state.sk.dtype)
        state.sv[i, ptr] = v1.to(state.sv.dtype)

        qh = q.reshape(N, B, H, Dh).float()
        kp = state.pk[i].to(dtype).reshape(U_pre, N, IB, H, Dh)
        vp = state.pv[i].to(dtype).reshape(U_pre, N, IB, H, Dh)
        if IB == 1:
            # one shared seed per stream: no per-origin select
            lp_sel = torch.einsum("nbhd,unhd->nbhu", qh, kp[:, :, 0].float())
        else:
            # logits against every seed's prefix, then each beam's origin:
            # one shared [U_pre, NI, D] read instead of a per-beam gather
            lp_all = torch.einsum("nbhd,unihd->nbihu", qh, kp.float())
            lp_sel = torch.gather(
                lp_all, 2, pick.expand(N, B, 1, H, U_pre))[:, :, 0]
        lp_sel = lp_sel * (Dh ** -0.5) + pre_bias[:, :, None, :]

        ks = state.sk[i, :n_suf].to(dtype).reshape(n_suf, NB, H, Dh)
        vs = state.sv[i, :n_suf].to(dtype).reshape(n_suf, NB, H, Dh)
        ls = (torch.einsum("mhd,smhd->mhs", qh.reshape(NB, H, Dh),
                           ks.float()) * (Dh ** -0.5)
              + suf_bias[:, None, :])                        # [NB, H, S]
        p = torch.softmax(
            torch.cat([lp_sel.reshape(NB, H, U_pre), ls], dim=-1),
            dim=-1).to(dtype)
        p_pre = p[..., :U_pre].reshape(N, B, H, U_pre)
        if IB == 1:
            o_pre = torch.einsum("nbhu,unhd->nbhd", p_pre, vp[:, :, 0])
        else:
            o_all = torch.einsum("nbhu,unihd->nbihd", p_pre, vp)
            o_pre = torch.gather(
                o_all, 2, pick.expand(N, B, 1, H, Dh))[:, :, 0]
        o_suf = torch.einsum("mhs,smhd->mhd", p[..., U_pre:], vs)
        o = (o_pre.reshape(NB, H, Dh) + o_suf).reshape(NB, D)
        x = layer_tail(layer, x, dense(att.out_proj, o),
                       c.decoder_normalize_before, F.relu)

    x = _final_norm(model, c, x)
    state.svalid[ptr] = advance
    state.h_last = torch.where(advance[:, None], x, state.h_last)
    state.sptr = ptr + 1
    return state


@torch.no_grad()
def jointer_beam_logits(model, cfg, h_last: torch.Tensor, jk, jv,
                        visible: torch.Tensor) -> torch.Tensor:
    """Beam-batched jointer step sharing per-stream encoder K/V.

    h_last: [N, B, D] LM states for B beams per stream; jk/jv: per-layer
    time-major [T_cap, N, D] — ONE copy per stream: the beams of a stream
    attend the same revealed frames, so the cache is never tiled per beam;
    visible: [N].  Returns the [N, B, V] f32 vocabulary LOGITS
    (un-normalized): log-probs are logits - logsumexp, and the beam block
    applies that per-row constant to the few candidates it selects."""
    c = cfg
    D = c.jointer_embed_dim
    H = c.jointer_attention_heads
    Dh = D // H
    t_cap = jk[0].shape[0]
    N, B, _ = h_last.shape
    dtype = h_last.dtype
    bias = torch.where(
        torch.arange(t_cap, device=h_last.device)[None] < visible[:, None],
        0.0, MASK_VALUE)                                         # [N, T]
    x = h_last
    pre = c.decoder_normalize_before
    for i, layer in enumerate(model.decoder.jointer.layers):
        att = layer.enc_attn
        h = _ln(layer.attn_layer_norm, x) if pre else x
        q = dense(att.q_proj, h).reshape(N, B, H, Dh).float()
        k = jk[i].reshape(t_cap, N, H, Dh).float()
        v = jv[i].to(dtype).reshape(t_cap, N, H, Dh)
        logits = torch.einsum("nbhd,tnhd->nbht", q, k) * (Dh ** -0.5)
        p = torch.softmax(logits + bias[:, None, None, :], dim=-1).to(dtype)
        o = torch.einsum("nbht,tnhd->nbhd", p, v).reshape(N, B, D)
        x = x + dense(att.out_proj, o)
        if not pre:
            x = _ln(layer.attn_layer_norm, x)
        h = _ln(layer.final_layer_norm, x) if pre else x
        x = x + dense(layer.fc2, F.relu(dense(layer.fc1, h)))
        if not pre:
            x = _ln(layer.final_layer_norm, x)
    return _vocab_logits(model, c, x)


def jointer_step_beam(model, cfg, h_last: torch.Tensor, jk, jv,
                      visible: torch.Tensor) -> torch.Tensor:
    """[N, B, V] log-probs (normalized ``jointer_beam_logits``): the math
    of ``jointer_step`` batched over beams."""
    return torch.log_softmax(
        jointer_beam_logits(model, cfg, h_last, jk, jv, visible), dim=-1)
