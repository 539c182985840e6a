"""Word error rate via Levenshtein distance.

A copy of the pure-Python path of ``wav2vec_s_tpu/eval/wer.py`` (the
reference's WER scoring, fairseq/fairseq/scoring/wer.py via editdistance,
without the optional dependency); the original's optional C++ helper is
left out, its results are the same.
"""

from __future__ import annotations

from typing import List

import numpy as np


def levenshtein(a: List[str], b: List[str]) -> int:
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = np.arange(len(b) + 1)
    for i, x in enumerate(a, 1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        for j, y in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (x != y))
        prev = cur
    return int(prev[-1])


def wer(hypo: str, ref: str) -> float:
    h, r = hypo.split(), ref.split()
    if not r:
        return 0.0 if not h else 1.0
    return levenshtein(h, r) / len(r)


def corpus_wer(hypos: List[str], refs: List[str]) -> float:
    errs = sum(levenshtein(h.split(), r.split())
               for h, r in zip(hypos, refs))
    n = sum(len(r.split()) for r in refs)
    return 100.0 * errs / max(n, 1)
