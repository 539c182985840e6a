"""BLEU scoring.

A copy of the pure-Python path of ``wav2vec_s_tpu/eval/bleu.py``:
sacrebleu when it is installed (the reference's scorer,
simuleval/simuleval/scorer/scorer.py:123-165 and fairseq eval-BLEU), else a
self-contained corpus BLEU (uniform 4-gram, exp brevity penalty).  The
original's optional C++ n-gram counter is left out, its counts are the same.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _pair_counts(ht, rt):
    """Clipped n-gram matches/totals for one (hyp, ref) token pair
    (fairseq/fairseq/clib/libbleu/libbleu.cpp counts the same)."""
    matches, totals = [0] * 4, [0] * 4
    for n in range(1, 5):
        hc, rc = _ngrams(ht, n), _ngrams(rt, n)
        totals[n - 1] += max(sum(hc.values()), 0)
        matches[n - 1] += sum((hc & rc).values())
    return matches, totals


def _fallback_corpus_bleu(hypos: List[str], refs: List[str]) -> float:
    matches = [0] * 4
    totals = [0] * 4
    hyp_len = ref_len = 0
    for h, r in zip(hypos, refs):
        ht, rt = h.split(), r.split()
        hyp_len += len(ht)
        ref_len += len(rt)
        m, t = _pair_counts(ht, rt)
        for n in range(4):
            matches[n] += m[n]
            totals[n] += t[n]
    if min(totals) == 0 or min(matches) == 0:
        return 0.0
    logp = sum(math.log(m / t) for m, t in zip(matches, totals)) / 4
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return 100.0 * bp * math.exp(logp)


def sentence_bleu(hypo: str, ref: str) -> float:
    """Sentence BLEU with +1 smoothing on the n-gram precisions — the
    reference's ``fairseq-score --sentence-bleu`` mode
    (fairseq/fairseq_cli/score.py, ``scorer.result_string`` with
    SmoothedBleu semantics)."""
    ht, rt = hypo.split(), ref.split()
    m, t = _pair_counts(ht, rt)
    logp = sum(math.log((mi + 1.0) / (ti + 1.0)) for mi, ti in zip(m, t)) / 4
    hyp_len, ref_len = len(ht), len(rt)
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return 100.0 * bp * math.exp(logp)


def corpus_bleu(hypos: List[str], refs: List[str]) -> float:
    try:
        import sacrebleu

        return float(sacrebleu.corpus_bleu(hypos, [refs]).score)
    except ImportError:
        return _fallback_corpus_bleu(hypos, refs)
