"""Latency metrics: AP / AL / DAL (+ computation-aware variants).

A copy of ``wav2vec_s_tpu/stream/latency.py`` (the port imports nothing of
that package): numpy twins of simuleval/simuleval/metrics/latency.py:67-189.
``delays[i]`` is the amount of source (ms or steps) consumed when target
token i was emitted.
"""

from __future__ import annotations

import numpy as np


def _prep(delays, src_len):
    d = np.asarray(delays, dtype=np.float64)
    return d, float(src_len), len(d)


def average_proportion(delays, src_len) -> float:
    d, x, y = _prep(delays, src_len)
    if y == 0 or x == 0:
        return 0.0
    return float(d.sum() / (x * y))


def average_lagging(delays, src_len, ref_len=None) -> float:
    d, x, y = _prep(delays, src_len)
    if y == 0:
        return 0.0
    tgt_len = float(ref_len) if ref_len is not None else float(y)
    # mask positions after the first delay that reached the full source;
    # shifted by one so at least that first saturated step counts
    saturated = d >= x
    mask = np.concatenate([[False], saturated[:-1]])
    oracle = np.arange(y, dtype=np.float64) * x / tgt_len
    lagging = np.where(mask, 0.0, d - oracle)
    tau = float((~mask).sum())
    return float(lagging.sum() / tau)


def differentiable_average_lagging(delays, src_len, ref_len=None) -> float:
    d, x, y = _prep(delays, src_len)
    if y == 0:
        return 0.0
    tgt_len = float(ref_len) if ref_len is not None else float(y)
    gamma = tgt_len / x
    new = np.zeros_like(d)
    for i in range(int(y)):
        new[i] = d[i] if i == 0 else max(new[i - 1] + 1.0 / gamma, d[i])
    dal = new - np.arange(y, dtype=np.float64) / gamma
    return float(dal.sum() / tgt_len)
