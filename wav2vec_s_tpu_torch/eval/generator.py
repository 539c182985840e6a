"""Offline generation: seq2seq beam search, the two-stage joint beam, the
batched greedy decoders of validation, and the transducer offline decode
(torch port of ``wav2vec_s_tpu/eval/generator.py``).

Re-provides fairseq ``SequenceGenerator`` and rain's ``SequenceGenerator2``
family (rain/sequence_generator_w2v2.py:12-366: offline beam search over
raw-audio encoder outputs, used for eval-BLEU during validation and
fairseq-generate).  The host bookkeeping is the JAX package's, line for
line (``argpartition`` then ``argsort``, eos forced at the length cap, the
stop test, the dedup); only the scorer changed.  Greedy argmax takes the
lowest index among equals (``torch.argmax``), and the CTC compaction is a
stable sort, as ``jnp.argmax`` / ``jnp.argsort(stable=True)`` are.

Where the JAX decoders recompute the decoder over the whole padded prefix
``[., max_len + 1]`` (static shapes), these score the live prefix width
only: the causal mask keeps every position from seeing the columns after
it, so the logits of the last live position are the same.

The batched greedy decoders run on the model's device and return host
arrays ``(prefixes [B, L + 1], lens [B])`` with a sentinel at
``prefixes[:, 0]``: callers detokenize ``prefixes[r, 1:lens[r]]``.  Their
loop reads one flag from the device per emitted position (the JAX
``while_loop``'s condition).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class BeamHypo:
    tokens: List[int]
    score: float


def _host(x) -> np.ndarray:
    """A numpy array of a tensor on any device (or of an array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _on(model, x, dtype=None) -> Optional[torch.Tensor]:
    """``x`` (array or tensor, or None) as a tensor on the model's
    device."""
    if x is None:
        return None
    return torch.as_tensor(x, dtype=dtype).to(_device_of(model))


class Seq2SeqBeamGenerator:
    """Beam search over ``Wav2Vec2Seq2Seq`` for one utterance (the JAX
    class; ``model`` holds its weights)."""

    def __init__(self, model, vocab, beam_size: int = 5,
                 max_len_a: float = 0.0, max_len_b: int = 200,
                 len_penalty: float = 1.0):
        self.model = model
        self.vocab = vocab
        self.beam = beam_size
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.len_penalty = len_penalty

    @torch.no_grad()
    def _scores(self, prev, enc, enc_pad, step) -> np.ndarray:
        """float32 log-probs [K, V] of the next token after the ``step``
        live columns of ``prev``."""
        logits = self.model.decode_logits(
            _on(self.model, prev[:, :step], torch.long), enc, enc_pad)
        return _host(torch.log_softmax(logits[:, step - 1], dim=-1))

    def generate(self, source, padding_mask=None) -> List[BeamHypo]:
        """source: [1, S] waveform -> beam hypotheses sorted by score."""
        eos, pad = self.vocab.eos(), self.vocab.pad()
        source = np.asarray(source)
        if padding_mask is None:
            padding_mask = np.zeros(source.shape, bool)
        with torch.no_grad():
            enc, enc_pad = self.model.encode(_on(self.model, source),
                                             _on(self.model, padding_mask))
        K = self.beam
        enc = enc.repeat_interleave(K, dim=0)
        enc_pad = enc_pad.repeat_interleave(K, dim=0)

        max_len = int(self.max_len_a * source.shape[1] + self.max_len_b)
        max_len = max(2, min(max_len, 512))
        prefixes = np.full((K, max_len + 1), pad, np.int32)
        prefixes[:, 0] = eos  # fairseq convention: prefix starts with eos
        scores = np.full(K, -np.inf)
        scores[0] = 0.0
        finished: List[BeamHypo] = []

        for step in range(1, max_len + 1):
            lp = self._scores(prefixes, enc, enc_pad, step)
            lp[:, pad] = -np.inf
            if step == max_len:  # force eos at the length cap
                keep = lp[:, eos].copy()
                lp[:] = -np.inf
                lp[:, eos] = keep
            total = scores[:, None] + lp
            flat = total.reshape(-1)
            top = np.argpartition(-flat, 2 * K - 1)[:2 * K]
            top = top[np.argsort(-flat[top])]
            V = lp.shape[1]
            new_prefixes = np.full_like(prefixes, pad)
            new_scores = np.full(K, -np.inf)
            n_new = 0
            for idx in top:
                row, tok = idx // V, idx % V
                sc = float(flat[idx])
                if not np.isfinite(sc):
                    continue
                if tok == eos:
                    toks = prefixes[row, 1:step].tolist()
                    finished.append(BeamHypo(
                        toks, sc / (step ** self.len_penalty)))
                    continue
                if n_new < K:
                    new_prefixes[n_new, :step] = prefixes[row, :step]
                    new_prefixes[n_new, step] = tok
                    new_scores[n_new] = sc
                    n_new += 1
            prefixes, scores = new_prefixes, new_scores
            if len(finished) >= K and max(
                    (h.score for h in finished)) >= (
                        scores[0] / ((step + 1) ** self.len_penalty)
                        if np.isfinite(scores[0]) else -np.inf):
                break
            if not np.isfinite(scores).any():
                break

        finished.sort(key=lambda h: -h.score)
        if not finished:
            finished = [BeamHypo(prefixes[0, 1:].tolist(), float(scores[0]))]
        return finished[:K]


class TwoStageJointGenerator:
    """Two-stage joint beam decode — twin of ``StageGenerator``
    (rain/stage_generator.py:14-563, vestigial in the reference: no rain
    model implements its decode1/decode2 contract, no task builds it).

    Stage 1 beam-decodes ASR transcripts (len_penalty 1).  Stage 2
    beam-decodes the translation with the beam ranging *jointly* over
    (asr hypothesis, mt prefix): stage-1 cumulative scores enter as the
    initial beam scores (``prev_scores``, :467-472) and final scores
    normalize by the combined (asr + mt) length ** 2 (the reference's
    ``len_penalty = 2`` stage schedule, :478/:489).  ``asr_1best``
    restricts stage 2 to the best transcript (:487-489).

    Model-agnostic: ``asr_generate(source, padding_mask) -> [BeamHypo]``
    (scores length-normalized, best first) and ``mt_score_fn(asr_tokens
    [K, U_s], prev_mt [K, U], lens [K]) -> log-probs [K, V]`` (an array or
    a tensor on any device).
    """

    def __init__(self, asr_generate, mt_score_fn, vocab, beam_size: int = 5,
                 len_penalty_2: float = 2.0, max_len: int = 200,
                 asr_1best: bool = False):
        self.asr_generate = asr_generate
        self.mt_score_fn = mt_score_fn
        self.vocab = vocab
        self.beam = beam_size
        self.len_penalty_2 = len_penalty_2
        self.max_len = max_len
        self.asr_1best = asr_1best

    def generate(self, source, padding_mask=None):
        eos, pad = self.vocab.eos(), self.vocab.pad()
        asr_hypos = self.asr_generate(source, padding_mask)[:self.beam]
        if self.asr_1best:
            asr_hypos = asr_hypos[:1]
        K = len(asr_hypos)
        U_s = max(max(len(h.tokens) for h in asr_hypos), 1)
        asr_tokens = np.full((K, U_s), pad, np.int32)
        asr_lens = np.zeros(K, np.float64)
        prev_scores = np.zeros(K, np.float64)
        for i, h in enumerate(asr_hypos):
            toks = list(h.tokens)
            asr_tokens[i, :len(toks)] = toks
            asr_lens[i] = len(toks)
            # de-normalize: BeamHypo scores are length-normalized (lp = 1)
            prev_scores[i] = h.score * max(len(toks), 1)

        # stage-2 beam: slots = (asr hypo, mt prefix); start one beam per
        # transcript with its carried cumulative score
        B = self.beam
        prefixes = np.full((K, self.max_len + 1), pad, np.int32)
        prefixes[:, 0] = eos                # fairseq decoding starts at eos
        slots = np.arange(K)
        scores = prev_scores.copy()
        lens = np.ones(K, np.int32)
        finished = []

        for step in range(self.max_len):
            lp = _host(self.mt_score_fn(
                asr_tokens[slots], prefixes, lens)).astype(np.float64)
            lp[:, pad] = -np.inf
            cum = scores[:, None] + lp
            # finalize eos extensions (joint normalization over both stages)
            total_len = asr_lens[slots] + lens
            fin_scores = cum[:, eos] / np.maximum(
                total_len, 1.0) ** self.len_penalty_2
            for r in np.argsort(-fin_scores)[:B]:
                if np.isfinite(fin_scores[r]):
                    finished.append({
                        "mt_tokens": prefixes[r, 1:lens[r]].tolist(),
                        "score": float(fin_scores[r]),
                        "asr_tokens": asr_hypos[slots[r]].tokens,
                        "asr_score": float(asr_hypos[slots[r]].score),
                    })
            cum[:, eos] = -np.inf
            flat = cum.reshape(-1)
            V = lp.shape[1]
            k = min(B, np.isfinite(flat).sum())
            if k == 0:
                break
            top = np.argpartition(-flat, k - 1)[:k]
            top = top[np.argsort(-flat[top])]
            rows, toks = top // V, top % V
            new_prefixes = prefixes[rows].copy()
            new_prefixes[np.arange(k), lens[rows]] = toks
            prefixes = new_prefixes
            scores = flat[top]
            slots = slots[rows]
            lens = lens[rows] + 1
            if finished:
                best_fin = max(f["score"] for f in finished)
                best_open = scores[0] / np.maximum(
                    asr_lens[slots[0]] + lens[0], 1.0) ** self.len_penalty_2
                if best_fin >= best_open and len(finished) >= B:
                    break

        finished.sort(key=lambda f: -f["score"])
        # dedup identical (asr, mt) pairs, keep best
        seen, out = set(), []
        for f in finished:
            key = (tuple(f["asr_tokens"]), tuple(f["mt_tokens"]))
            if key not in seen:
                seen.add(key)
                out.append(f)
        return out[:self.beam]


def _greedy_loop(step_log_probs, B, first, stop, pad, max_len, device,
                 group=None):
    """The batched greedy emission loop of the JAX decoders' ``while_loop``:
    ``step_log_probs(prefixes[:, :width], lens) -> [B, V]``; a row emits
    its argmax unless it is ``stop`` or the row is at ``max_len``, and is
    blocked from its first non-emission on.  With a process ``group`` the
    loop runs until every rank's rows are blocked, so that the ranks'
    forwards pair up (blocked rows emit nothing more: the result is the
    same)."""
    prefixes = torch.full((B, max_len + 1), pad, dtype=torch.long,
                          device=device)
    prefixes[:, 0] = first
    lens = torch.ones(B, dtype=torch.long, device=device)
    blocked = torch.zeros(B, dtype=torch.bool, device=device)
    rows = torch.arange(B, device=device)
    for width in range(1, max_len + 1):
        lp = step_log_probs(prefixes[:, :width], lens)
        lp[:, pad] = float("-inf")
        tok = lp.argmax(-1)
        emit = ~blocked & (tok != stop) & (lens < max_len)
        prefixes[rows, lens] = torch.where(emit, tok, prefixes[rows, lens])
        lens = lens + emit.long()
        blocked = blocked | ~emit
        done = blocked.all()
        if group is not None:
            import torch.distributed as dist

            done = done.to(torch.int32)
            dist.all_reduce(done, op=dist.ReduceOp.MIN, group=group)
        if bool(done):
            break
    return _host(prefixes).astype(np.int32), _host(lens).astype(np.int32)


def make_offline_greedy_decoder(model, vocab, main_context=None,
                                right_context=None, max_len: int = 200,
                                group=None):
    """Batched offline greedy transducer decode for validation BLEU (JAX
    ``make_offline_greedy_decoder``): full-context blockwise encode, then
    cached-prefix greedy emissions through ``W2V2CaatModel.decode_step``
    until every row stops (blank = bos); ``group``: ``_greedy_loop``'s.
    ``decode(source, padding_mask) -> (prefixes, lens)``."""
    blank, pad = vocab.bos(), vocab.pad()

    @torch.no_grad()
    def decode(source, padding_mask=None):
        enc, enc_pad = model.encode(_on(model, source),
                                    _on(model, padding_mask), main_context,
                                    right_context)
        if enc_pad is None:
            enc_pad = torch.zeros(enc.shape[:2], dtype=torch.bool,
                                  device=enc.device)
        return _greedy_loop(
            lambda pfx, lens: model.decode_step(pfx, lens, enc, enc_pad),
            enc.shape[0], blank, blank, pad, max_len, enc.device, group)

    return decode


def make_s2s_greedy_decoder(model, vocab, main_context=None,
                            right_context=None, max_len: int = 200,
                            group=None):
    """Batched greedy decode for ``Wav2Vec2Seq2Seq`` (JAX
    ``make_s2s_greedy_decoder``; rain w2v2_s2s_task.py:199-236 at beam 1):
    validation BLEU/WER of offline ASR/ST training.  The prefix starts with
    eos (the fairseq convention); a row stops at eos; ``group``:
    ``_greedy_loop``'s."""
    eos, pad = vocab.eos(), vocab.pad()

    @torch.no_grad()
    def decode(source, padding_mask=None):
        enc, enc_pad = model.encode(_on(model, source),
                                    _on(model, padding_mask), main_context,
                                    right_context)
        rows = torch.arange(enc.shape[0], device=enc.device)

        def step(pfx, lens):
            logits = model.decode_logits(pfx, enc, enc_pad)
            return logits[rows, lens - 1]

        return _greedy_loop(step, enc.shape[0], eos, eos, pad, max_len,
                            enc.device, group)

    return decode


def make_ctc_greedy_decoder(model, vocab, main_context=None,
                            right_context=None, blank: int = 0):
    """Batched CTC best-path decode for ``Wav2VecCtc`` (JAX
    ``make_ctc_greedy_decoder``; fairseq's argmax WER path in
    criterions/ctc.py): argmax, collapse repeats, drop blanks, on the
    device; kept tokens are compacted to the left in time order by a
    stable sort on "dropped?"."""
    eos = vocab.eos()

    @torch.no_grad()
    def decode(source, padding_mask=None):
        logits, lpad = model(_on(model, source), _on(model, padding_mask),
                             main_context, right_context)
        ids = logits.argmax(-1)                                  # [B, T]
        prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], 1)
        keep = ~lpad & (ids != blank) & (ids != prev)
        order = torch.sort((~keep).to(torch.uint8), dim=1,
                           stable=True).indices
        toks = torch.gather(ids, 1, order)
        lens = keep.sum(1) + 1
        sentinel = torch.full_like(ids[:, :1], eos)
        return (_host(torch.cat([sentinel, toks], 1)).astype(np.int32),
                _host(lens).astype(np.int32))

    return decode


def transducer_offline_decode(searcher, audio: np.ndarray,
                              intra_beam: int = 5, max_steps: int = 200):
    """Offline CAAT decode = one streaming search over the whole utterance
    (the reference's offline path runs the same blockwise encoder full-
    context, rain/tasks/w2v2_s2s_task.py:400-488)."""
    state = searcher.init_state()
    state, words = searcher.search(
        state, audio, is_end=True, intra_beam=intra_beam, inter_beam=1,
        gen_beam=5.0, read_step=10 ** 9, max_steps=max_steps)
    return " ".join(words)
