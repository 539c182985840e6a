"""Streaming transducer beam search.

Behavioral twin of ``FullTransducerSearcher``
(rain/simul/transducer_searcher.py:103-459): per revealed read-step an
intra-block beam search over the expanded (blank ∪ vocab) space with

- blank -> eos aliasing while the stream is open (``bos_bias``, :345-347),
- a 2x-beam finished-path pool with identical-path merging (:298-311, 398),
- length-normalized scoring ``score * len^-len_scale`` (:144-154),
- early stop when best-finished - gen_beam > best-unfinished (:380-383),
- word-boundary-gated emission of the longest common prefix across beams
  (:175-205, ``--eager`` emits partial words).

A copy of the numpy host searcher of ``wav2vec_s_tpu/stream/searcher.py``
(the port imports nothing of that package): all per-step scoring runs
through ``stream/engine.StreamingEngine`` at bucketed shapes, prefixes stay
right-padded numpy arrays on the host, and recompute replaces the
reference's incremental-state surgery (``rollback_steps``/``recalc_lm``/
``convert_cache_pad``/left-pad regather, :403-421).  It is the oracle the
batched beam decoders (``stream/beam_batched.py``) are held against, and
its module functions are their per-chunk host tail.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from wav2vec_s_tpu_torch.data.dictionary import Dictionary

NINF = -np.inf


def spm_style_vocab(vocab: Dictionary) -> bool:
    """spm-style vocabs mark word starts with '▁'; plain word vocabs have a
    boundary at every token."""
    return any(s.startswith("▁")
               for s in vocab.symbols[vocab.nspecial:vocab.nspecial + 500])


def detok_pieces(vocab: Dictionary, tokenizer, ids) -> str:
    pieces = [vocab[int(i)] for i in ids if int(i) >= vocab.nspecial]
    if tokenizer is not None:
        return tokenizer.decode(pieces)
    if any("▁" in p for p in pieces):
        return "".join(pieces).replace("▁", " ").strip()
    # plain word vocab: every token is a word (boundary at every token,
    # WordEndChecker semantics for non-spm dictionaries)
    return " ".join(pieces).strip()


def merge_surface_scores(vocab: Dictionary, tokenizer, tokens: np.ndarray,
                         scores: np.ndarray, merge_add: bool) -> np.ndarray:
    """Dedup beams by detokenized surface string (searcher outer merge,
    transducer_searcher.py:298-311): keep earliest, others -> -inf."""
    strings = [detok_pieces(vocab, tokenizer, row) for row in tokens]
    out = scores.copy()
    for i in range(len(strings)):
        if not np.isfinite(out[i]):
            continue
        for j in range(i + 1, len(strings)):
            if np.isfinite(out[j]) and strings[i] == strings[j]:
                out[i] = (np.logaddexp(out[i], out[j])
                          if merge_add else max(out[i], out[j]))
                out[j] = NINF
    return out


def lcp_emit(vocab: Dictionary, tokenizer, spm_style: bool, eager: bool,
             toks: np.ndarray, out_pos: int, is_end: bool):
    """Word-boundary-gated emission of the longest common prefix across
    beams (emit_words, transducer_searcher.py:175-205).

    toks: [B, U] kept beams, best first, right-padded.  Returns
    (words, new_out_pos)."""
    pad = vocab.pad()
    if is_end:
        ids = [t for t in toks[0] if t != pad]
        out = detok_pieces(vocab, tokenizer, ids[out_pos:])
        return out.split(), len(ids)

    lens = (toks != pad).sum(1)
    if toks.shape[0] == 1:
        ident_pos = int(lens[0])
    else:
        neq = (toks != toks[:1]).any(0)
        neq = np.cumsum(neq)
        ident = (neq == 0) & (toks[0] != pad)
        ident_pos = int(ident.sum())
    ident_pos = max(ident_pos, out_pos)

    ids = toks[0, out_pos:ident_pos].tolist()
    if not ids:
        return [], out_pos
    if eager:
        out = detok_pieces(vocab, tokenizer, ids)
        return out.split(), ident_pos

    # hold back the trailing (possibly partial) word: emit pieces up to the
    # last word boundary among the agreed tokens
    if spm_style:
        boundary = 0
        for k, i in enumerate(ids):
            if int(i) >= vocab.nspecial and vocab[int(i)].startswith("▁"):
                boundary = k  # words before this piece are complete
    else:
        # word-level vocab: every token is a word; hold back the last one
        boundary = max(len(ids) - 1, 0)
    if boundary == 0:
        return [], out_pos
    out = detok_pieces(vocab, tokenizer, ids[:boundary])
    return out.split(), out_pos + boundary


@dataclasses.dataclass
class SearchState:
    prefixes: np.ndarray          # [B, U] right-padded with pad
    scores: np.ndarray            # [B] unnormalized log-probs
    enc: Optional[np.ndarray] = None    # [T, D] encoded frames so far
    enc_len: int = 0
    out_token_pos: int = 1        # tokens already emitted (skip bos)


class StreamingTransducerSearcher:
    def __init__(self, engine, vocab: Dictionary, tokenizer=None,
                 bos_bias: float = 0.0, len_scale: float = 1.0,
                 len_penalty: float = 0.0, eager: bool = False,
                 merge_add: bool = False):
        self.engine = engine
        self.vocab = vocab
        self.tokenizer = tokenizer
        self.bos = vocab.bos()
        self.pad = vocab.pad()
        self.eos = vocab.eos()
        self.vocab_size = len(vocab)
        self.bos_bias = bos_bias
        self.len_scale = len_scale
        self.len_penalty = len_penalty
        self.eager = eager
        self.merge_add = merge_add
        self._spm_style = spm_style_vocab(vocab)

    def init_state(self) -> SearchState:
        return SearchState(
            prefixes=np.asarray([[self.bos]], np.int32),
            scores=np.zeros(1), out_token_pos=1)

    # -- scoring helpers ------------------------------------------------
    def _norm(self, score, lengths, is_end):
        lp = 0.0 if is_end else self.len_penalty
        lengths = np.maximum(lengths, 1.0)
        return score * lengths ** (-self.len_scale) - lengths * lp

    def _unnorm(self, score, lengths, is_end):
        lp = 0.0 if is_end else self.len_penalty
        lengths = np.maximum(lengths, 1.0)
        return (score + lengths * lp) * lengths ** self.len_scale

    @staticmethod
    def _merge_identical(tokens: np.ndarray, scores: np.ndarray,
                         add_reduce: bool) -> np.ndarray:
        """Merge duplicate rows: keep earliest, others -> -inf
        (merge_paths, :298-311)."""
        out = scores.copy()
        B = len(scores)
        for i in range(B):
            if not np.isfinite(out[i]):
                continue
            for j in range(i + 1, B):
                if np.isfinite(out[j]) and np.array_equal(tokens[i], tokens[j]):
                    out[i] = (np.logaddexp(out[i], out[j])
                              if add_reduce else max(out[i], out[j]))
                    out[j] = NINF
        return out

    # -- the intra-block beam (search_at, :313-459) ---------------------
    def search_at(self, state: SearchState, visible: int, beam_size: int,
                  gen_beam: float, max_steps: int, is_end: bool) -> SearchState:
        prefixes, scores = state.prefixes, state.scores
        prev_len = prefixes.shape[1]
        pool_cap = beam_size * 2
        pool_tokens = np.full((pool_cap, prev_len + max_steps), self.pad,
                              np.int32)
        pool_scores = np.full(pool_cap, NINF)
        lengths = (prefixes != self.pad).sum(1).astype(np.float64) - 1

        for nstep in range(max_steps):
            B, T = prefixes.shape
            lens = (prefixes != self.pad).sum(1)
            lprobs = self.engine.decode_scores(
                prefixes, lens, state.enc, visible)
            lprobs[:, self.pad] = NINF
            if not is_end:
                lprobs[:, self.eos] = lprobs[:, self.bos] + self.bos_bias
            lprobs[:, self.bos] = NINF
            lengths = lengths + 1

            # finish current paths with blank/eos
            blank = self._norm(scores + lprobs[:, self.eos], lengths, is_end)
            pool_scores[-B:] = blank
            pool_tokens[-B:, :] = self.pad
            pool_tokens[-B:, :T] = prefixes
            if T > prev_len:
                pool_scores = self._merge_identical(
                    pool_tokens, pool_scores, self.merge_add)
            order = np.argsort(-pool_scores, kind="stable")
            pool_scores = pool_scores[order]
            pool_tokens = pool_tokens[order]

            # expand with real tokens
            lprobs[:, self.eos] = NINF
            expand = scores[:, None] + lprobs
            normed = self._norm(expand, lengths[:, None], is_end)
            flat = normed.reshape(-1)
            k = min(beam_size, B * self.vocab_size)
            tidx = np.argpartition(-flat, k - 1)[:k]
            tidx = tidx[np.argsort(-flat[tidx])]
            next_tok = (tidx % self.vocab_size).astype(np.int32)
            rows = tidx // self.vocab_size
            prefixes = np.concatenate(
                [prefixes[rows], next_tok[:, None]], axis=1)
            scores = expand.reshape(-1)[tidx]
            lengths = lengths[rows]

            if pool_scores[0] - gen_beam > flat[tidx[0]]:
                break

        pool_scores = pool_scores[:beam_size]
        pool_tokens = pool_tokens[:beam_size]
        keep = pool_scores > pool_scores[0] - gen_beam
        pool_scores, pool_tokens = pool_scores[keep], pool_tokens[keep]

        # trim trailing all-pad columns
        tail_pad = (pool_tokens[:, prev_len:] == self.pad).all(0).sum()
        if tail_pad:
            pool_tokens = pool_tokens[:, :pool_tokens.shape[1] - tail_pad]
        lens = (pool_tokens != self.pad).sum(1).astype(np.float64)
        unnorm = self._unnorm(pool_scores, lens, is_end)
        return dataclasses.replace(state, prefixes=pool_tokens, scores=unnorm)

    # -- outer per-chunk search (search, :207-278) ----------------------
    def search(self, state: SearchState, audio_prefix: np.ndarray,
               is_end: bool, intra_beam: int = 5, inter_beam: int = 1,
               gen_beam: float = 2.0, read_step: int = 1,
               max_steps: int = 40) -> tuple:
        enc, t_eff = self.engine.encode_prefix(audio_prefix, is_end)
        new_frames = t_eff - state.enc_len
        state = dataclasses.replace(state, enc=enc)

        if new_frames <= 0:
            assert is_end, "no new frames while stream still open"
            state = self.search_at(state, t_eff, intra_beam, gen_beam,
                                   max_steps, True)
        else:
            blocks = max(new_frames // read_step, 1)
            for i in range(blocks):
                seen = (i + 1) * read_step if i < blocks - 1 else new_frames
                ended = is_end and (seen == new_frames)
                state = self.search_at(state, state.enc_len + seen,
                                       intra_beam, gen_beam, max_steps, ended)
        state = dataclasses.replace(state, enc_len=t_eff)

        # dedup by surface string, keep within gen_beam, top inter_beam
        scores = self._merge_surface(state.prefixes, state.scores)
        lengths = (state.prefixes != self.pad).sum(1).astype(np.float64)
        normed = self._norm(scores, lengths, is_end)
        order = np.argsort(-normed, kind="stable")
        keep = [i for i in order[:inter_beam]
                if normed[i] > normed[order[0]] - gen_beam
                and np.isfinite(normed[i])]
        state = dataclasses.replace(
            state, prefixes=state.prefixes[keep], scores=scores[keep])

        words, state = self._emit_words(state, is_end)
        return state, words

    def _merge_surface(self, tokens, scores):
        return merge_surface_scores(self.vocab, self.tokenizer, tokens,
                                    scores, self.merge_add)

    def _detok(self, ids) -> str:
        return detok_pieces(self.vocab, self.tokenizer, ids)

    def _emit_words(self, state: SearchState, is_end: bool):
        """Longest common prefix across beams, word-boundary gated
        (emit_words, :175-205)."""
        words, out_pos = lcp_emit(self.vocab, self.tokenizer, self._spm_style,
                                  self.eager, state.prefixes,
                                  state.out_token_pos, is_end)
        return words, dataclasses.replace(state, out_token_pos=out_pos)
