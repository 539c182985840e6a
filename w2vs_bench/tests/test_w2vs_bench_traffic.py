"""Every traffic generator is deterministic from the seed: the same seed
gives the same inputs, another seed the same sizes in another order."""

import time

import numpy as np
import torch

from w2vs_bench import harness
from w2vs_bench.tests.tiny import tiny_cell

BIG = 3_000_000_019          # the driver's seeds pass 32 bits


def _driver(cell: str, seed: int, **traffic):
    c = tiny_cell(cell, "float32", traffic)
    ctx = harness.Context(c, seed, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    return harness.driver_class(c.traffic)(ctx)


def _corpus_driver(seed):
    d = _driver("agent_ds2.base", seed, streams=4, pool_streams=8)
    d.pool = np.arange(8 * 3, dtype=np.int16).reshape(8, 3)
    return d


def test_corpora_are_a_function_of_the_seed():
    a, b, c = (_corpus_driver(s) for s in (BIG, BIG, BIG + 1))
    for k in (-1, 0, 5):
        assert (a._corpus(k)[0] == b._corpus(k)[0]).all()
    assert any((a._corpus(k)[0] != c._corpus(k)[0]).any() for k in range(4))
    assert len(set(a._corpus(0)[0])) == 4          # distinct rows


def test_the_audio_pool_is_a_function_of_the_seed():
    pools = []
    for s in (BIG, BIG, BIG + 1):
        d = _driver("agent_ds2.base", s, streams=2, pool_streams=2,
                    stream_seconds=0.5, t_cap=64)
        d.setup()
        pools.append(d.pool)
        d.stager.shutdown()
        d._unhook()
    assert (pools[0] == pools[1]).all() and (pools[0] != pools[2]).any()


def _serve_driver(seed):
    d = _driver("serve_backlog.base", seed, length_block=16,
                stall_share=0.25, stall_every=4)
    d.pool = np.zeros(16000 * 20, np.float32)
    d._blocks = {}
    return d


def test_streams_are_a_function_of_the_seed_with_the_same_mix():
    a, b, c = (_serve_driver(s) for s in (BIG, BIG, BIG + 1))
    for blk in (0, 3):
        la, sa, pa, oa = a._block(blk)
        lb, sb, pb, ob = b._block(blk)
        lc, sc, _, _ = c._block(blk)
        assert (la == lb).all() and (sa == sb).all() and (pa == pb).all()
        assert (oa == ob).all()
        # every seed serves the same lengths and stall count, reordered
        assert sorted(la) == sorted(lc) and (la != lc).any()
        assert sa.sum() == sc.sum() == 4
        assert la.min() == 2 * 16000 and la.max() == 10 * 16000
