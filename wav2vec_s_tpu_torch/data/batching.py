"""Length-aware batching with shape bucketing (own copy of the numpy code of
``wav2vec_s_tpu/data/batching.py``; it gives the same batches).

Re-provides fairseq's batching core (``batch_by_size`` in
fairseq/fairseq/data/data_utils_fast.pyx + ``EpochBatchIterator`` in
fairseq/fairseq/data/iterators.py): max_tokens batching over length-sorted
indices, shard-by-rank, seeded epoch shuffle, resumable position.

**Shape bucketing**: ``length_buckets`` quantizes lengths to a geometric
grid so the number of distinct padded shapes is bounded; every batch is
padded up to its bucket.  The JAX package needs that to bound its compiled
executables; the port keeps it so that both packages collate identical
batches (and the allocator sees few distinct shapes).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np


def length_buckets(max_len: int, min_len: int = 1024, factor: float = 1.3,
                   multiple: int = 64) -> List[int]:
    """Geometric grid of padded lengths, each a multiple of ``multiple``."""
    out, v = [], float(min_len)
    while v < max_len:
        out.append(int(-(-v // multiple) * multiple))
        v *= factor
    out.append(int(-(-max_len // multiple) * multiple))
    return sorted(set(out))


def bucket_for(size: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if size <= b:
            return b
    return buckets[-1]


def batch_by_size(sizes: np.ndarray, max_tokens: int,
                  max_sentences: Optional[int] = None,
                  required_batch_size_multiple: int = 1,
                  buckets: Optional[Sequence[int]] = None,
                  indices: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Greedy max_tokens batching over (given or length-sorted) indices.

    Cost of a batch = num_sentences * padded_len (fairseq semantics); with
    ``buckets`` the padded length is the bucket, so batches are shape-stable.
    """
    sizes = np.asarray(sizes)
    if indices is None:
        indices = np.argsort(sizes, kind="stable")
    batches, cur, cur_len = [], [], 0
    for idx in indices:
        sz = int(sizes[idx])
        padded = bucket_for(sz, buckets) if buckets else sz
        new_len = max(cur_len, padded)
        if cur and ((len(cur) + 1) * new_len > max_tokens or
                    (max_sentences and len(cur) >= max_sentences) or
                    (buckets and padded != cur_len)):
            batches.append(np.asarray(cur))
            cur, cur_len = [], 0
            new_len = padded
        cur.append(int(idx))
        cur_len = new_len
    if cur:
        batches.append(np.asarray(cur))
    if required_batch_size_multiple > 1:
        m = required_batch_size_multiple
        batches = [b[: max(len(b) // m * m, min(len(b), m))] for b in batches]
    return [b for b in batches if len(b)]


@dataclasses.dataclass
class IteratorState:
    epoch: int = 0
    batch_offset: int = 0


class EpochBatchIterator:
    """Seeded, shardable, resumable iterator over precomputed batches.

    Twin of fairseq ``EpochBatchIterator`` (iterators.py): per-epoch shuffle
    of batch order, shard-by-data-parallel-rank (``shard_by_rank``), and a
    state dict for checkpoint resume (trainer.py:394-533 restores it).
    """

    def __init__(self, batches: List[np.ndarray], seed: int = 1,
                 shard_id: int = 0, num_shards: int = 1, shuffle: bool = True):
        self._batches = batches
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.state = IteratorState()

    def __len__(self):
        return len(self._epoch_batches(self.state.epoch))

    def _epoch_batches(self, epoch: int) -> List[np.ndarray]:
        order = np.arange(len(self._batches))
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(order)
        sharded = order[self.shard_id::self.num_shards]
        return [self._batches[i] for i in sharded]

    def next_epoch_itr(self) -> Iterator[np.ndarray]:
        batches = self._epoch_batches(self.state.epoch)
        start = self.state.batch_offset

        def gen():
            for i in range(start, len(batches)):
                self.state.batch_offset = i + 1
                yield batches[i]
            self.state.epoch += 1
            self.state.batch_offset = 0

        return gen()

    def state_dict(self):
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d):
        self.state = IteratorState(**d)


def pad_to(arr: np.ndarray, length: int, value=0) -> np.ndarray:
    if arr.shape[0] >= length:
        return arr[:length]
    pad = [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=value)
