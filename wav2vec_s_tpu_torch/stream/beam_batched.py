"""Batched multi-stream streaming BEAM decode (the quality path, batched).

Port of ``wav2vec_s_tpu/stream/beam_batched.py``.  The full
``FullTransducerSearcher`` semantics (rain/simul/transducer_searcher.py:
103-459) — intra-block beam, blank->eos aliasing while open, 2x-beam
finished pool with identical-path merging, length-normalized scores, early
stop, word-boundary-gated LCP emission — as a lockstep decoder: N streams x
B beams advance through ONE beam block per chunk.

- beams are a fixed axis: every per-iteration op (scoring, pool merge,
  top-B expansion) is batched over [N, B] with a masked per-stream early
  stop — no data-dependent shapes;
- the jointer never tiles encoder state per beam
  (``caat_step.jointer_beam_logits``);
- the prefix LM runs once per block (or is carried and extended across
  chunks) and stays shared per stream seed (``caat_step.BeamLMState``);
- identical-path pool merging is a vectorized equivalence-class reduce;
- ties go to the lowest index everywhere (stable sorts, first-maximum
  argmax): dead beams and the pool's empty half make -inf ties the rule;
- the outer surface-form merge + LCP word emission stay on the host per
  chunk (they detokenize): the searcher's own functions
  (``stream/searcher.py``).

Four decoders: ``BatchedBeamStreamingDecoder`` and ``OneShotBeamDecoder``
read the pool back every chunk (host surface merge between chunks);
``FusedBeamStreamingDecoder`` and ``FusedOneShotBeamDecoder`` re-seed on
the device and read nothing back until the per-chunk best rows are fetched
once at the end, but for the beam block's early-stop test
(``stop_check_every``).  The streaming ones run the incremental encoder
(``stream/incremental.py``, the chunk-attention kernel on CUDA), the
one-shot ones ``model.encode`` in sub-batches (the flash-attention kernel
when the model's ``attention_impl`` is "flash").
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from wav2vec_s_tpu_torch.data.batching import bucket_for
from wav2vec_s_tpu_torch.models.feature_extractor import conv_output_length
from wav2vec_s_tpu_torch.models.modules import compute_copy
from wav2vec_s_tpu_torch.stream import caat_step
from wav2vec_s_tpu_torch.stream.incremental import IncrementalBlockwiseEncoder
from wav2vec_s_tpu_torch.stream.searcher import (
    NINF, lcp_emit, merge_surface_scores, spm_style_vocab)


def _merge_identical_batched(tokens: torch.Tensor, scores: torch.Tensor,
                             add_reduce: bool) -> torch.Tensor:
    """Vectorized twin of the searcher's ``_merge_identical`` (merge_paths,
    transducer_searcher.py:298-311): rows with identical token sequences
    collapse onto the first of their class (max or logaddexp), the rest
    drop to -inf.  tokens [N, P, U], scores [N, P]."""
    eq = (tokens[:, :, None, :] == tokens[:, None, :, :]).all(-1)  # [N,P,P]
    P = scores.shape[1]
    earlier = torch.tril(torch.ones((P, P), dtype=torch.bool,
                                    device=scores.device), diagonal=-1)
    first = ~((eq & earlier[None]).any(-1))                # no earlier equal
    class_max = torch.where(eq, scores[:, None, :], NINF).amax(-1)
    if add_reduce:
        # exp(-inf - -inf) is NaN: classes with no finite member stay -inf
        finite = torch.isfinite(class_max)
        safe_m = torch.where(finite, class_max, 0.0)
        e = torch.where(eq & torch.isfinite(scores)[:, None, :],
                        torch.exp(scores[:, None, :] - safe_m[..., None]),
                        0.0)
        merged = torch.where(
            finite, safe_m + torch.log(e.sum(-1).clamp(min=1e-38)), NINF)
    else:
        merged = class_max
    return torch.where(first, merged, NINF)


def _top_b_per_row(masked: torch.Tensor, B: int, C: int = 128):
    """Exact top-B of every row of ``masked`` [N, R, V], hierarchical.

    The vocabulary axis reduces to per-bucket maxima once; each of the B
    passes takes the first bucket holding the maximum, then the first
    index inside it — the flat argmax's first-index rule, so equal values
    come out in index order, as a stable descending sort gives them.
    Returns (values [N, R, B], indices [N, R, B] int64)."""
    N, R, V = masked.shape
    G = -(-V // C)
    dev = masked.device
    tiles = F.pad(masked, (0, G * C - V), value=NINF).reshape(N, R, G, C)
    bmax = tiles.amax(-1)                                    # [N, R, G]
    cols = torch.arange(C, device=dev)[None, None]
    buckets = torch.arange(G, device=dev)[None, None]
    cand_v, cand_i = [], []
    for _ in range(B):
        g = bmax.argmax(-1)                                  # [N, R]
        tile = torch.gather(
            tiles, 2, g[..., None, None].expand(N, R, 1, C))[:, :, 0]
        gidx = g[..., None] * C + cols                       # [N, R, C]
        for pi in cand_i:            # already selected, same bucket
            tile = torch.where(gidx == pi[..., None], NINF, tile)
        j = tile.argmax(-1)                                  # [N, R]
        cand_v.append(torch.gather(tile, -1, j[..., None])[..., 0])
        cand_i.append(g * C + j)
        # refresh the winning bucket's maximum without the pick
        rest = torch.where(cols == j[..., None], NINF, tile)
        bmax = torch.where(buckets == g[..., None],
                           rest.amax(-1)[..., None], bmax)
    return torch.stack(cand_v, -1), torch.stack(cand_i, -1)


class BatchedBeamStreamingDecoder:
    """N-stream lockstep streaming beam search over the incremental encoder.

    Mirrors ``StreamingTransducerSearcher`` chunk for chunk with
    ``read_step`` = one encoder step (``main_context * blocks_per_step``
    frames).  Arguments are those of the JAX decoder except ``params``: the
    ``W2V2CaatModel`` carries its parameters and its device.  The decoder
    works on a copy whose matmul weights are cast to the compute dtype
    once.
    """

    #: host->device wire format of ``stage`` (the fused decoders): "int16"
    #: ships 16-bit PCM and converts on the device
    transfer_dtype = "float32"

    #: the beam block's early-stop test (every stream done) is a read from
    #: the device: n > 0 reads it every n-th iteration and leaves the loop
    #: when all are done, 0 runs the fixed ``max_steps`` iterations and
    #: reads nothing.  The results are the same either way (a done stream's
    #: arrays are frozen and its LM state no longer advances); reading
    #: every iteration is the faster on the card, where the host leads the
    #: device by little and every iteration saved is ~700 kernels not sent
    #: (measured at Base width on an H100: PERF.md, the beam findings).
    stop_check_every = 1

    def __init__(self, model, vocab, w2v_cfg, tokenizer=None,
                 beam_size: int = 5, inter_beam: int = 1,
                 gen_beam: float = 2.0, max_steps: int = 40,
                 max_len: int = 200, bos_bias: float = 0.0,
                 len_scale: float = 1.0, len_penalty: float = 0.0,
                 eager: bool = False, merge_add: bool = False,
                 t_cap: int = 1024, blocks_per_step: int = 1):
        self.model = compute_copy(model, model.cfg.compute_dtype)
        self.device = model.decoder.lm.embed_tokens.weight.device
        self.vocab = vocab
        self.tokenizer = tokenizer
        self.w2v_cfg = w2v_cfg
        self.caat = model.cfg
        self.B = beam_size
        self.inter_beam = inter_beam
        self.gen_beam = gen_beam
        self.max_steps = max_steps
        self.max_len = max_len
        self.bos_bias = bos_bias
        self.len_scale = len_scale
        self.len_penalty = len_penalty
        self.eager = eager
        self.merge_add = merge_add
        self.t_cap = t_cap
        self.blocks_per_step = blocks_per_step
        self.mc = w2v_cfg.main_context
        self.rc = w2v_cfg.right_context
        self.conv_layers = w2v_cfg.conv_feature_layers
        self._spm_style = spm_style_vocab(vocab)
        self.U_cap = max_len + max_steps + 2
        # working-width buckets of the beam block (the prefix LM's cost
        # scales with the padded width)
        b = 16
        self._token_buckets = []
        while b < self.U_cap:
            self._token_buckets.append(b)
            b *= 2
        self._token_buckets.append(self.U_cap)
        self._enc_cache = {}         # n_streams -> encoder
        #: jointer-cache capacity segment
        self.cap_seg = 128
        #: beam iterations run since the decoder was built
        self.iterations_run = 0
        # pad/bos/eos are never expansion tokens (pad is dead, bos is the
        # blank -> aliased to eos, eos only finishes paths)
        colmask = torch.zeros(len(vocab), device=self.device)
        colmask[[vocab.pad(), vocab.bos(), vocab.eos()]] = NINF
        self._colmask = colmask

    def _encoder(self, n: int) -> IncrementalBlockwiseEncoder:
        enc = self._enc_cache.get(n)
        if enc is None:
            enc = self._enc_cache[n] = IncrementalBlockwiseEncoder(
                self.w2v_cfg, self.model.encoder.w2v2_model, n,
                t_cap=self.t_cap, blocks_per_step=self.blocks_per_step,
                proj=self.model.encoder.encoder_proj)
        return enc

    # -- scores -----------------------------------------------------------
    def _norm_dev(self, score, length, is_end):
        lp = torch.where(is_end, 0.0, self.len_penalty)
        ln = length.clamp(min=1.0)
        return score * ln ** (-self.len_scale) - ln * lp

    def _unnorm_dev(self, score, length, is_end):
        lp = torch.where(is_end, 0.0, self.len_penalty)
        ln = length.clamp(min=1.0)
        return (score + ln * lp) * ln ** self.len_scale

    def _norm_host(self, score, lengths, is_end):
        lp = 0.0 if is_end else self.len_penalty
        lengths = np.maximum(lengths, 1.0)
        return score * lengths ** (-self.len_scale) - lengths * lp

    # -- the beam block ---------------------------------------------------
    @torch.no_grad()
    def _beam_block(self, prefixes, nlens, scores, jk, jv, visible, is_end,
                    active, cap=None, lm_pre=None, plen=None):
        """One ``search_at`` (transducer_searcher.py:313-459) for all
        streams at once.

        prefixes [N, B, U_blk] int64 right-padded; nlens [N, B] incl. bos;
        scores [N, B] float32 unnormalized; visible [N]; is_end/active [N]
        bool; all on the decoder's device.  The working width U_blk is the
        host-bucketed prefix length.  The prefix LM runs ONCE per block
        (``lm_prefill`` over the first ``inter_beam`` rows per stream, the
        only live ones at chunk entry) or arrives carried (``lm_pre``,
        ``plen``: inter_beam 1); each beam iteration is then an O(1) cached
        step over the split prefix|suffix cache with a suffix-only reorder
        gather.  ``cap`` slices the jointer K/V to the revealed-frame
        capacity (None: the caches come sliced).  Returns (pool tokens
        [N, B, U_blk], unnormalized pool scores [N, B]); the inputs are
        not written."""
        model, caat = self.model, self.caat
        B, max_steps = self.B, self.max_steps
        pad_id, bos_id, eos_id = (self.vocab.pad(), self.vocab.bos(),
                                  self.vocab.eos())
        if cap is not None:
            jk = [k[:cap] for k in jk]
            jv = [v[:cap] for v in jv]
        N, _, U_blk = prefixes.shape
        dev = prefixes.device
        IB = min(self.inter_beam, B)
        if lm_pre is None:
            lm_small = caat_step.lm_prefill(
                model, caat, prefixes[:, :IB].reshape(N * IB, U_blk),
                nlens[:, :IB].reshape(N * IB), U_blk)
            plen_ib = nlens[:, :IB].reshape(N * IB)
        else:
            if IB != 1:
                raise ValueError("a carried prefill requires inter_beam=1")
            lm_small, plen_ib = lm_pre, plen
        origin0 = torch.arange(B, device=dev).clamp(max=IB - 1).repeat(N)
        lm = caat_step.lm_beam_init(lm_small, plen_ib, origin0,
                                    n_slots=max_steps, beams=B)
        pool_t = torch.full((N, 2 * B, U_blk), pad_id, dtype=torch.long,
                            device=dev)
        pool_s = torch.full((N, 2 * B), NINF, device=dev)
        lengths = nlens.float() - 1.0
        done = ~active
        end_col = is_end[:, None]
        n_base = (torch.arange(N, device=dev) * B)[:, None]
        check = self.stop_check_every

        for i in range(max_steps):
            if check and i % check == 0 and bool(done.all()):
                break
            self.iterations_run += 1
            # raw logits; log-prob = logit - lse, applied to the few
            # columns and candidates the block needs
            logits = caat_step.jointer_beam_logits(
                model, caat, lm.h_last.reshape(N, B, -1), jk, jv, visible)
            lse = torch.logsumexp(logits, dim=-1)
            # blank -> eos alias while the stream is open (:345-347)
            eos_lp = torch.where(end_col, logits[..., eos_id],
                                 logits[..., bos_id] + self.bos_bias) - lse
            lengths2 = lengths + 1.0

            # finish current paths with blank/eos into the pool
            fin = self._norm_dev(scores + eos_lp, lengths2, end_col)
            new_pt = torch.cat([pool_t[:, :B], prefixes], dim=1)
            new_ps = torch.cat([pool_s[:, :B], fin], dim=1)
            merged = _merge_identical_batched(new_pt, new_ps, self.merge_add)
            order = torch.argsort(-merged, dim=1, stable=True)
            new_ps = torch.gather(merged, 1, order)
            new_pt = torch.gather(
                new_pt, 1, order[..., None].expand(N, 2 * B, U_blk))

            # expand with real tokens: exact top-B of the B*V normed
            # scores.  The norm is monotone in the log-prob within a beam
            # row, so the per-row top-B of the masked logits IS the per-row
            # top-B of normed scores; then the B*B survivors merge exactly
            cand_v, cand_i = _top_b_per_row(logits + self._colmask, B)
            cand_s = scores[:, :, None] + (cand_v - lse[:, :, None])
            # prefixes at the buffer limit may only finish
            cand_s = torch.where(nlens[:, :, None] >= U_blk - 1, NINF,
                                 cand_s)
            normed = self._norm_dev(cand_s, lengths2[:, :, None],
                                    end_col[:, :, None])
            # top-B of the B*B, lowest index first among equals
            # (torch.topk promises no order there)
            top_v, ci = torch.sort(normed.reshape(N, B * B), dim=1,
                                   descending=True, stable=True)
            top_v, ci = top_v[:, :B], ci[:, :B]
            rows = ci // B
            toks = torch.gather(cand_i.reshape(N, B * B), 1, ci)
            nx_prefix = torch.gather(
                prefixes, 1, rows[..., None].expand(N, B, U_blk))
            nx_nlens = torch.gather(nlens, 1, rows)
            nx_scores = torch.gather(cand_s.reshape(N, B * B), 1, ci)
            nx_lengths = torch.gather(lengths2, 1, rows)
            pos = nx_nlens.clamp(max=U_blk - 1)
            nx_prefix.scatter_(2, pos[..., None], toks[..., None])
            # cached LM advance: gather the origin beams' suffix caches
            # (the shared prefix never moves), then consume the new token
            # (frozen streams keep h_last)
            lm = caat_step.lm_beam_reorder(lm, (n_base + rows).reshape(-1))
            adv = (~done)[:, None].expand(N, B).reshape(-1)
            lm = caat_step.lm_beam_step(model, caat, lm, toks.reshape(-1),
                                        pos.reshape(-1), adv, B)
            nx_nlens = nx_nlens + 1

            # early stop: best finished beats best open by gen_beam
            # (:380-383)
            newly_done = new_ps[:, 0] - self.gen_beam > top_v[:, 0]

            def sel(new, old):
                d = done.reshape((N,) + (1,) * (new.dim() - 1))
                return torch.where(d, old, new)

            prefixes, nlens = sel(nx_prefix, prefixes), sel(nx_nlens, nlens)
            scores, lengths = sel(nx_scores, scores), sel(nx_lengths, lengths)
            pool_t, pool_s = sel(new_pt, pool_t), sel(new_ps, pool_s)
            done = done | newly_done

        pool_t, pool_s = pool_t[:, :B], pool_s[:, :B]
        keep = pool_s > pool_s[:, :1] - self.gen_beam
        pool_s = torch.where(keep, pool_s, NINF)
        plens = (pool_t != pad_id).sum(-1).float()
        return pool_t, self._unnorm_dev(pool_s, plens, end_col)

    def _cap_of(self, t_main: int) -> int:
        seg = self.cap_seg
        return min(-(-int(t_main) // seg) * seg, self.t_cap)

    # -- staging (the fused decoders) -------------------------------------
    def stage(self, wavs: List[np.ndarray]):
        """Assemble a corpus on the host and start its copy to the device
        (the greedy decoders' staging protocol): callers that stage corpus
        k+1 before blocking on corpus k hide the host link.  In int16 mode
        the host clips ``w * 32768``.  Returns the handle ``(N,
        max_samples, totals, audio)`` that ``decode_corpus`` of the fused
        decoders accepts."""
        N = len(wavs)
        W = self._encoder(N).window
        max_samples = max(len(w) for w in wavs)
        int16 = self.transfer_dtype == "int16"
        audio = np.zeros((N, max_samples + W),
                         np.int16 if int16 else np.float32)
        for i, w in enumerate(wavs):
            if int16 and w.dtype != np.int16:
                audio[i, :len(w)] = np.clip(w * 32768.0, -32768, 32767)
            else:
                audio[i, :len(w)] = w
        totals = np.asarray([len(w) for w in wavs])
        return N, max_samples, totals, torch.from_numpy(audio).to(self.device)

    def _staged(self, wavs):
        """A wavs list or a staged handle -> (N, max_samples, totals,
        device audio)."""
        if isinstance(wavs, tuple) and len(wavs) == 4:
            return wavs
        return self.stage(wavs)

    def _dev_audio(self, x):
        """Device-side wire-format conversion of a staged window."""
        if self.transfer_dtype == "int16":
            return x.float() / 32768.0
        return x

    # -- helpers of the fused decoders ------------------------------------
    def _chunk_schedule(self, frames_i, n_chunks, n_main, rc):
        """Host-static per-chunk schedule: revealed frames, per-stream
        visibility, end flags, and the run mask (a stream stops running
        after the first chunk that ran with is_end).  Everything the
        per-chunk host loop derives from the encoder's ``t_main`` is a pure
        function of the chunk index."""
        t_mains, vis_s, end_s, run_s = [], [], [], []
        alive = np.ones(len(frames_i), bool)
        for k in range(n_chunks):
            t_main = (k + 1) * n_main + (rc if k == n_chunks - 1 else 0)
            is_end = t_main >= frames_i
            visible = np.where(is_end, np.minimum(t_main, frames_i),
                               np.minimum(t_main,
                                          np.maximum(frames_i - rc, 0)))
            run = alive & (visible > 0)
            alive = alive & ~(run & is_end)
            t_mains.append(t_main)
            vis_s.append(visible.astype(np.int64))
            end_s.append(is_end)
            run_s.append(run)
        return t_mains, np.stack(vis_s), np.stack(end_s), np.stack(run_s)

    def _width_of(self, k: int) -> int:
        """Static prefix-width bound of chunk ``k``: each chunk adds at most
        ``max_steps`` tokens."""
        return min(self.U_cap, bucket_for(
            min(1 + k * self.max_steps, self.max_len) +
            self.max_steps + 1, self._token_buckets))

    def _geometry(self, N, max_samples, totals):
        """(encoder, per-stream frame counts, number of chunks, samples per
        chunk) of a corpus."""
        enc = self._encoder(N)
        frames_i = np.asarray([conv_output_length(int(n), self.conv_layers)
                               for n in totals])
        total_frames = (max_samples - enc.rf) // enc.hop + 1
        n_chunks = max((total_frames - self.rc) // enc.n_main, 1)
        return enc, frames_i, n_chunks, enc.n_main * enc.hop

    def _replay_emission(self, hist, run_s, end_s, n_chunks, stride, W,
                         totals):
        """Host replay of the per-chunk LCP word emission + delay
        bookkeeping from the recorded best rows — one pass, after the
        device has finished."""
        N = len(totals)
        words_out = [[] for _ in range(N)]
        delays = [[] for _ in range(N)]
        out_pos = np.ones(N, np.int32)
        for k in range(n_chunks):
            consumed_ms = np.minimum(k * stride + W, totals) / 16.0
            for i in range(N):
                if not run_s[k, i]:
                    continue
                ws, out_pos[i] = lcp_emit(
                    self.vocab, self.tokenizer, self._spm_style, self.eager,
                    hist[k, i][None], int(out_pos[i]), bool(end_s[k, i]))
                if ws:
                    words_out[i].extend(ws)
                    delays[i].extend([float(consumed_ms[i])] * len(ws))
        texts = [" ".join(w) for w in words_out]
        return texts, delays

    def _extend_carry(self, lm_pre, plen, bt_full, run):
        """Extend the carried LM prefix cache past a device re-seed.

        At inter_beam=1 the re-seeded prefix is the previous seed plus the
        tokens the winning pool row appended (at most ``max_steps``), so
        the carried ``LMState`` advances with one narrow
        ``lm_prefill_extend`` instead of a full-width ``lm_prefill`` next
        chunk.  Streams with ``run`` False keep their state."""
        S = self.max_steps
        new_plen = torch.where(
            run, (bt_full != self.vocab.pad()).sum(-1), plen)
        cols = (plen[:, None] + torch.arange(S, device=plen.device)[None, :]
                ).clamp(max=bt_full.shape[1] - 1)
        toks = torch.gather(bt_full, 1, cols)
        new_lens = (new_plen - plen).clamp(0, S)
        lm_pre = caat_step.lm_prefill_extend(self.model, self.caat, lm_pre,
                                             plen, toks, new_lens)
        return lm_pre, plen + new_lens

    @staticmethod
    def _pad_carry(lm_pre, w: int):
        """Grow the carried prefix cache to the next segment's width."""
        u = lm_pre.k[0].shape[0]
        if u == w:
            return lm_pre
        if w < u:
            raise ValueError(f"the carried prefix cache holds {u} rows and "
                             f"cannot shrink to {w}")
        pad = (0, 0, 0, 0, 0, w - u)
        return caat_step.LMState(k=[F.pad(k, pad) for k in lm_pre.k],
                                 v=[F.pad(v, pad) for v in lm_pre.v],
                                 h_last=lm_pre.h_last)

    def _reseed_best(self, pool_t, pool_s, is_end, run, prefixes, nlens,
                     scores, width_pad):
        """Device twin of ``_host_merge_chunk`` at inter_beam=1 /
        merge_add=False: the pool row with the best length-normalized score
        re-seeds beam 0, the rest go to -inf.  Returns the new (prefixes,
        nlens, scores) and the best row (padded to U_cap) for the emission
        replay."""
        pad_id = self.vocab.pad()
        N, B = pool_s.shape
        plens = (pool_t != pad_id).sum(-1)
        normed = self._norm_dev(pool_s, plens.float(), is_end[:, None])
        # -inf * len ** -scale can be NaN-free yet order wrongly: re-mask
        normed = torch.where(torch.isfinite(pool_s), normed, NINF)
        best = torch.argmax(normed, dim=1)         # first maximum
        bt = torch.gather(
            pool_t, 1, best[:, None, None].expand(N, 1, pool_t.shape[2]))[:, 0]
        bs = torch.gather(pool_s, 1, best[:, None])[:, 0]
        bt_full = F.pad(bt, (0, width_pad), value=pad_id)
        np_ = torch.full_like(prefixes, pad_id)
        np_[:, 0, :] = bt_full
        nn = torch.ones_like(nlens)
        nn[:, 0] = (bt != pad_id).sum(-1)
        ns = torch.full_like(scores, NINF)
        ns[:, 0] = bs
        prefixes = torch.where(run[:, None, None], np_, prefixes)
        nlens = torch.where(run[:, None], nn, nlens)
        scores = torch.where(run[:, None], ns, scores)
        return prefixes, nlens, scores, bt_full

    def _init_beams_dev(self, N):
        """Device beam arrays of a fresh corpus: beam 0 = [bos] at score 0,
        the others dead."""
        dev = self.device
        prefixes = torch.full((N, self.B, self.U_cap), self.vocab.pad(),
                              dtype=torch.long, device=dev)
        prefixes[:, 0, 0] = self.vocab.bos()
        nlens = torch.ones((N, self.B), dtype=torch.long, device=dev)
        scores = torch.full((N, self.B), NINF, device=dev)
        scores[:, 0] = 0.0
        return prefixes, nlens, scores

    def _init_beams_host(self, N):
        prefixes = np.full((N, self.B, self.U_cap), self.vocab.pad(),
                           np.int32)
        prefixes[:, 0, 0] = self.vocab.bos()
        nlens = np.ones((N, self.B), np.int32)
        scores = np.full((N, self.B), NINF)
        scores[:, 0] = 0.0
        return prefixes, nlens, scores

    def _jointer_caches(self, N, dtype):
        def z():
            return torch.zeros((self.t_cap, N, self.caat.jointer_embed_dim),
                               dtype=dtype, device=self.device)

        layers = range(self.caat.jointer_layers)
        return [z() for _ in layers], [z() for _ in layers]

    def _block_from_host(self, prefixes, nlens, scores, jk, jv, visible,
                         is_end, run, u_blk, cap):
        """The beam block on host beam arrays: copies them to the device
        and returns the device pool."""
        dev = self.device

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        return self._beam_block(
            up(prefixes[:, :, :u_blk], torch.long), up(nlens, torch.long),
            up(scores, torch.float32), jk, jv, up(visible, torch.long),
            up(is_end, torch.bool), up(run, torch.bool), cap=cap)

    # -- corpus decode ----------------------------------------------------
    @torch.no_grad()
    def decode_corpus(self, wavs: List[np.ndarray],
                      return_delays: bool = True):
        """Stream a corpus in lockstep; returns (texts, delays_ms/word)."""
        N = len(wavs)
        max_samples = max(len(w) for w in wavs)
        totals = np.asarray([len(w) for w in wavs])
        enc, frames_i, n_chunks, stride = self._geometry(N, max_samples,
                                                         totals)
        W = enc.window
        audio = np.zeros((N, max_samples + W), np.float32)
        for i, w in enumerate(wavs):
            audio[i, :len(w)] = w
        audio = torch.from_numpy(audio).to(self.device)

        estate = enc.init()
        jk, jv = self._jointer_caches(N, estate.out_cache.dtype)
        prefixes, nlens, scores = self._init_beams_host(N)
        out_pos = np.ones(N, np.int32)
        active = np.ones(N, bool)
        words_out = [[] for _ in range(N)]
        delays = [[] for _ in range(N)]

        for k in range(n_chunks):
            start = k * stride
            t0 = estate.t_main
            estate = enc.step(estate, audio[:, start:start + W],
                              flush=k == n_chunks - 1)
            t_main = estate.t_main
            n_new = t_main - t0
            if n_new <= 0:
                continue
            k_new, v_new = caat_step.jointer_kv(
                self.model, self.caat, estate.out_cache[t0:t_main])
            caat_step.jointer_kv_append(jk, jv, k_new, v_new, t0)

            # per-stream visibility: open streams hide their trailing rc
            # frames; a stream ends when every one of its frames is
            # committed
            is_end = t_main >= frames_i
            visible = np.where(is_end, np.minimum(t_main, frames_i),
                               np.minimum(t_main,
                                          np.maximum(frames_i - self.rc, 0)))
            run = active & (visible > 0)
            if not run.any():
                continue

            u_blk = min(self.U_cap,
                        bucket_for(int(nlens.max()) + self.max_steps + 1,
                                   self._token_buckets))
            pool_t, pool_s = self._block_from_host(
                prefixes, nlens, scores, jk, jv, visible, is_end, run,
                u_blk, self._cap_of(t_main))
            # host per stream: outer surface merge + inter-beam keep + LCP
            # word emission (searcher.search, :207-278)
            consumed_ms = np.minimum(start + W, totals) / 16.0
            self._host_merge_chunk(
                pool_t.cpu().numpy(), pool_s.cpu().numpy().astype(np.float64),
                run, is_end, consumed_ms, prefixes, nlens, scores, out_pos,
                active, words_out, delays)
            if not active.any():
                break

        texts = [" ".join(w) for w in words_out]
        return (texts, delays) if return_delays else texts

    def _host_merge_chunk(self, pool_t, pool_s, run, is_end, consumed_ms,
                          prefixes, nlens, scores, out_pos, active,
                          words_out, delays):
        """Per-chunk host tail: outer surface merge + inter-beam keep + LCP
        word emission, re-seeding the beam arrays in place."""
        vocab = self.vocab
        pad_id = vocab.pad()
        for i in range(len(run)):
            if not run[i]:
                continue
            toks, sc = pool_t[i], pool_s[i]
            sc = merge_surface_scores(vocab, self.tokenizer, toks, sc,
                                      self.merge_add)
            lens = (toks != pad_id).sum(1).astype(np.float64)
            normed = self._norm_host(sc, lens, bool(is_end[i]))
            order = np.argsort(-normed, kind="stable")
            keep = [j for j in order[:self.inter_beam]
                    if normed[j] > normed[order[0]] - self.gen_beam
                    and np.isfinite(normed[j])]
            kt = toks[keep]
            ks = sc[keep]
            ws, out_pos[i] = lcp_emit(vocab, self.tokenizer,
                                      self._spm_style, self.eager, kt,
                                      int(out_pos[i]), bool(is_end[i]))
            if ws:
                words_out[i].extend(ws)
                delays[i].extend([float(consumed_ms[i])] * len(ws))
            prefixes[i] = pad_id
            nlens[i] = 1
            scores[i] = NINF
            for b, (row, s) in enumerate(zip(kt, ks)):
                prefixes[i, b, :len(row)] = row
                nlens[i, b] = int((row != pad_id).sum())
                scores[i, b] = s
            if is_end[i]:
                active[i] = False


class OneShotBeamDecoder(BatchedBeamStreamingDecoder):
    """Corpus-eval beam path: one-shot encode + interleaved beam blocks.

    Same chunk-for-chunk semantics as ``BatchedBeamStreamingDecoder`` with
    two structural changes that exist only because, in corpus evaluation,
    all audio is available up front (the blockwise encoder is prefix-exact
    at block granularity):

    - the encoder and the jointer K/V projections run ONCE for the whole
      corpus at full utterance length, so the per-chunk device work is one
      beam block instead of encoder step + K/V append + beam block;
    - streams are split into two halves decoded in alternation: while the
      device runs one half's beam block, the host does the other half's
      surface merge + LCP emission.
    """

    #: streams per one-shot encode sub-batch (lowered until it divides N)
    encode_batch = 32

    def _oneshot_geometry(self, N, max_samples, totals):
        enc, frames_i, n_chunks, stride = self._geometry(N, max_samples,
                                                         totals)
        # the frames the policy ever sees (the flush commits the final
        # look-ahead)
        t_frames = n_chunks * enc.n_main + self.rc
        n_samples = min((t_frames - 1) * enc.hop + enc.rf, max_samples)
        if self.t_cap < t_frames:
            raise ValueError(f"t_cap={self.t_cap} does not hold the "
                             f"{t_frames} frames of this corpus")
        return enc, frames_i, n_chunks, stride, t_frames, n_samples

    def _encode_all(self, audio, N, t_frames):
        """One-shot encode in sub-batches -> per-layer jointer K/V,
        time-major and padded to ``t_cap`` like the incremental caches.
        audio: [N, n_samples] float on the device."""
        eb = min(self.encode_batch, N)
        while N % eb:
            eb -= 1
        enc_tm = None
        for i in range(0, N, eb):
            e, _ = self.model.encode(audio[i:i + eb], None, self.mc, self.rc)
            if enc_tm is None:
                enc_tm = e.new_zeros((self.t_cap, N, e.shape[-1]))
            enc_tm[:e.shape[1], i:i + eb] = e.transpose(0, 1)
        return caat_step.jointer_kv(self.model, self.caat, enc_tm)

    @torch.no_grad()
    def decode_corpus(self, wavs: List[np.ndarray],
                      return_delays: bool = True):
        N = len(wavs)
        max_samples = max(len(w) for w in wavs)
        totals = np.asarray([len(w) for w in wavs])
        enc, frames_i, n_chunks, stride, t_frames, n_samples = \
            self._oneshot_geometry(N, max_samples, totals)
        W, rc = enc.window, self.rc
        audio = np.zeros((N, max_samples), np.float32)
        for i, w in enumerate(wavs):
            audio[i, :len(w)] = w
        jk, jv = self._encode_all(
            torch.from_numpy(audio[:, :n_samples]).to(self.device), N,
            t_frames)

        # two-half interleave: device(half A) overlaps host-merge(half B).
        # Contiguous slices, NOT index arrays: the host tail mutates the
        # beam arrays through these views in place
        halves = ([slice(0, N)] if N < 2 else
                  [slice(0, N // 2), slice(N // 2, N)])
        jk_h = [[k[:, h].contiguous() for k in jk] for h in halves]
        jv_h = [[v[:, h].contiguous() for v in jv] for h in halves]

        prefixes, nlens, scores = self._init_beams_host(N)
        out_pos = np.ones(N, np.int32)
        active = np.ones(N, bool)
        words_out = [[] for _ in range(N)]
        delays = [[] for _ in range(N)]

        pending = None           # (half-rows, device pool, run, is_end, ms)

        def flush_pending():
            nonlocal pending
            if pending is None:
                return
            rows, pool_t, pool_s, run_h, is_end_h, ms_h = pending
            self._host_merge_chunk(
                pool_t.cpu().numpy(), pool_s.cpu().numpy().astype(np.float64),
                run_h, is_end_h, ms_h,
                prefixes[rows], nlens[rows], scores[rows], out_pos[rows],
                active[rows], words_out[rows], delays[rows])
            pending = None

        for k in range(n_chunks):
            t_main = (k + 1) * enc.n_main + (rc if k == n_chunks - 1 else 0)
            is_end = t_main >= frames_i
            visible = np.where(is_end, np.minimum(t_main, frames_i),
                               np.minimum(t_main,
                                          np.maximum(frames_i - rc, 0)))
            consumed_ms = np.minimum(k * stride + W, totals) / 16.0
            for h, rows in enumerate(halves):
                run_h = active[rows] & (visible[rows] > 0)
                if not run_h.any():
                    continue
                u_blk = min(self.U_cap, bucket_for(
                    int(nlens[rows].max()) + self.max_steps + 1,
                    self._token_buckets))
                dev_pool = self._block_from_host(
                    prefixes[rows], nlens[rows], scores[rows], jk_h[h],
                    jv_h[h], visible[rows], is_end[rows], run_h, u_blk,
                    self._cap_of(t_main))
                flush_pending()      # overlaps with the dispatched block
                pending = (rows, dev_pool[0], dev_pool[1], run_h,
                           is_end[rows], consumed_ms[rows])
            if pending is None and not active.any():
                break
        flush_pending()

        texts = [" ".join(w) for w in words_out]
        return (texts, delays) if return_delays else texts


def _require_fused_point(dec):
    if dec.inter_beam != 1 or dec.merge_add:
        raise ValueError("the fused beam decoders require inter_beam=1, "
                         "merge_add=False; use the unfused decoders for "
                         "other operating points")


class FusedBeamStreamingDecoder(BatchedBeamStreamingDecoder):
    """Serving-semantics fused beam: no per-chunk host tail.

    Same chunk-for-chunk semantics as ``BatchedBeamStreamingDecoder`` at
    the inter_beam=1 / merge_add=False operating point (see
    ``FusedOneShotBeamDecoder`` for why the host tail collapses there), the
    encoder running INCREMENTALLY inside the chunk loop — O(T) serving cost
    per stream, audio windows sliced from a device-resident buffer.  The
    quality twin of ``CachedFusedGreedyDecoder``: encoder step + jointer
    K/V append + beam block + argmax re-seed per chunk, the chunk schedule
    precomputed on the host, the per-chunk best rows stacked on the device
    and fetched once for the host emission replay.
    """

    @torch.no_grad()
    def decode_corpus(self, wavs, return_delays: bool = True):
        _require_fused_point(self)
        N, max_samples, totals, audio = self._staged(wavs)
        enc, frames_i, n_chunks, stride = self._geometry(N, max_samples,
                                                         totals)
        W, dev = enc.window, self.device
        t_mains, vis_s, end_s, run_s = self._chunk_schedule(
            frames_i, n_chunks, enc.n_main, self.rc)
        vis_d, end_d, run_d = (torch.from_numpy(a).to(dev)
                               for a in (vis_s, end_s, run_s))

        estate = enc.init()
        jk, jv = self._jointer_caches(N, estate.out_cache.dtype)
        prefixes, nlens, scores = self._init_beams_dev(N)
        # prefill carry-over: the chunk-entry seed prefix is the previous
        # chunk's seed + the tokens the re-seed appended, so the LM prefix
        # cache extends by at most max_steps narrow rows per chunk
        lm_pre = caat_step.lm_init(self.model, self.caat, N,
                                   u_cap=self._width_of(0))
        plen = torch.ones((N,), dtype=torch.long, device=dev)

        hist = []
        for k in range(n_chunks):
            flush = k == n_chunks - 1
            cap, w = self._cap_of(t_mains[k]), self._width_of(k)
            lm_pre = self._pad_carry(lm_pre, w)
            t0 = estate.t_main                     # a host int, no read
            win = self._dev_audio(audio[:, k * stride:k * stride + W])
            estate = enc.step_fn_cap(cap, flush=flush)(estate, win)
            k_new, v_new = caat_step.jointer_kv(
                self.model, self.caat, estate.out_cache[t0:estate.t_main])
            caat_step.jointer_kv_append(jk, jv, k_new, v_new, t0)
            pool_t, pool_s = self._beam_block(
                prefixes[:, :, :w], nlens, scores, jk, jv, vis_d[k],
                end_d[k], run_d[k], cap=cap, lm_pre=lm_pre, plen=plen)
            prefixes, nlens, scores, bt_full = self._reseed_best(
                pool_t, pool_s, end_d[k], run_d[k], prefixes, nlens, scores,
                self.U_cap - w)
            lm_pre, plen = self._extend_carry(lm_pre, plen, bt_full,
                                              run_d[k])
            hist.append(bt_full)

        hist = torch.stack(hist).cpu().numpy()     # the one read
        texts, delays = self._replay_emission(hist, run_s, end_s, n_chunks,
                                              stride, W, totals)
        return (texts, delays) if return_delays else texts


class FusedOneShotBeamDecoder(OneShotBeamDecoder):
    """Fully fused corpus-eval beam path: no per-chunk host tail.

    At the published eval operating point — ``inter_beam=1`` (one
    hypothesis survives each chunk) with max-reduce merging — the per-chunk
    host tail of the beam search collapses: the surface merge cannot change
    the argmax (identical TOKEN paths are already max-merged on the device
    by ``_merge_identical_batched``, and with max-reduce a
    cross-tokenization surface merge only re-labels the winning row), and
    the LCP word emission over a single kept row is pure bookkeeping.  So
    the whole chunk loop runs on the device, carrying the beam arrays there
    and recording only the per-chunk best row; words AND delays are
    replayed on the host once, after the device finishes.  Texts and delays
    equal ``OneShotBeamDecoder``'s.

    The device-side re-seed mirrors ``_host_merge_chunk`` at
    inter_beam=1/merge_add=False: the pool row with the best
    length-normalized score seeds beam 0, everything else goes to -inf.
    (Where two tokenizations of one surface string co-exist in the pool,
    the device path keeps the higher-scoring row instead of the earlier
    one; the emitted string is the same.)
    """

    @torch.no_grad()
    def decode_corpus(self, wavs, return_delays: bool = True):
        _require_fused_point(self)
        N, max_samples, totals, audio = self._staged(wavs)
        enc, frames_i, n_chunks, stride, t_frames, n_samples = \
            self._oneshot_geometry(N, max_samples, totals)
        W, dev = enc.window, self.device
        t_mains, vis_s, end_s, run_s = self._chunk_schedule(
            frames_i, n_chunks, enc.n_main, self.rc)
        vis_d, end_d, run_d = (torch.from_numpy(a).to(dev)
                               for a in (vis_s, end_s, run_s))

        # staged wire-format audio: slice + convert on the device
        jk, jv = self._encode_all(self._dev_audio(audio[:, :n_samples]), N,
                                  t_frames)
        prefixes, nlens, scores = self._init_beams_dev(N)
        # prefill carry-over (see FusedBeamStreamingDecoder)
        lm_pre = caat_step.lm_init(self.model, self.caat, N,
                                   u_cap=self._width_of(0))
        plen = torch.ones((N,), dtype=torch.long, device=dev)

        hist = []
        for k in range(n_chunks):
            w = self._width_of(k)
            lm_pre = self._pad_carry(lm_pre, w)
            pool_t, pool_s = self._beam_block(
                prefixes[:, :, :w], nlens, scores, jk, jv, vis_d[k],
                end_d[k], run_d[k], cap=self._cap_of(t_mains[k]),
                lm_pre=lm_pre, plen=plen)
            prefixes, nlens, scores, bt_full = self._reseed_best(
                pool_t, pool_s, end_d[k], run_d[k], prefixes, nlens, scores,
                self.U_cap - w)
            lm_pre, plen = self._extend_carry(lm_pre, plen, bt_full,
                                              run_d[k])
            hist.append(bt_full)

        hist = torch.stack(hist).cpu().numpy()     # the one read
        texts, delays = self._replay_emission(hist, run_s, end_s, n_chunks,
                                              stride, W, totals)
        return (texts, delays) if return_delays else texts
