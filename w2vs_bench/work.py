"""The yardstick's arithmetic: the card's peaks, the least time a piece of
work could take, the union of device intervals, and the operations and
bytes of the model's parts computed from their shapes.

Frozen here so that no change to the program moves it: ``bound`` is the
arithmetic of ``chip_smoke._bound`` and ``busy_us`` the interval union of
``wav2vec_s_tpu_torch/tools/profile_train._busy_us``.  Operations count a
multiply-add as two; attention counts the allowed query-key pairs only.
Bytes count each input read once and each output written once.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, HBM3 bytes/s
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16, F32 = 2, 4


def bound_s(n_bytes: float, flops: float) -> float:
    """Least seconds for work that moves ``n_bytes`` and does ``flops``."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS_BF16)


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def gaps(intervals: Iterable[Tuple[float, float]]):
    """The idle (start, end) stretches between a union's pieces."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


# -- shapes of the blockwise encoder ------------------------------------------

def copy_rows(T: int, mc: int, rc: int) -> int:
    """Look-ahead copies the blockwise encoder appends to T frames."""
    return rc * (T // mc) if rc else 0


def block_pairs(T: int, mc: int, rc: int) -> int:
    """Allowed query-key pairs of the block mask over T frames and their
    copies: a row of block b (frame or copy) sees the frames of blocks <= b
    and the valid copies of block b."""
    nb_full = T // mc if rc else 0
    pairs = 0
    for b in range(-(-T // mc)):
        frames_b = min(mc, T - b * mc)
        seen = min((b + 1) * mc, T)
        copies_b = 0
        if b < nb_full:
            copies_b = sum(1 for r in range(rc) if (b + 1) * mc + r < T)
        rows = frames_b + (rc if b < nb_full else 0)
        pairs += rows * (seen + copies_b)
    return pairs


def chunk_pairs(t0: int, mc: int, rc: int, blocks: int) -> int:
    """Allowed pairs of one incremental step: its rows (blocks * (mc + rc))
    see the t0 committed frames, the main frames of their own and earlier
    blocks of the chunk and the copies of their own block."""
    rows = blocks * (mc + rc)
    pairs = rows * t0
    for b in range(blocks):
        pairs += (mc + rc) * ((b + 1) * mc + rc)
    return pairs


def receptive(convs: Sequence[Sequence[int]]) -> Tuple[int, int]:
    """(receptive field, hop) in samples of the conv front-end."""
    rf, hop = 1, 1
    for _, k, s in convs:
        rf += (k - 1) * hop
        hop *= s
    return rf, hop


def conv_flops(n_samples: int, convs: Sequence[Sequence[int]]) -> int:
    """The strided conv front-end over ``n_samples``."""
    flops, t, cin = 0, n_samples, 1
    for dim, k, s in convs:
        t = (t - k) // s + 1
        flops += 2 * t * dim * cin * k
        cin = dim
    return flops


def layer_row_flops(D: int, F: int, kdim: int = None) -> int:
    """Projections and FFN of one attention layer, per row."""
    kdim = kdim or D
    return 2 * D * D * 2 + 2 * kdim * D * 2 + 4 * D * F


def k1_call(B: int, R: int, t0: int, D: int, intra_pairs: int):
    """(bytes, flops) of one chunk-attention call (K1) in bf16: q and the
    chunk's K/V, the t0 cache rows it needs, the [R, R] f32 bias, out."""
    n_bytes = BF16 * B * D * (4 * R + 2 * t0) + F32 * R * R
    flops = 4 * D * B * (R * t0 + intra_pairs)
    return n_bytes, flops


def k2_call(B: int, S: int, D: int, pairs: int):
    """(bytes, flops) of one block-sparse flash forward (K2) in bf16:
    q, k, v and out [B, S, D], the [B, S] key mask; allowed pairs only."""
    return 2 * 4 * B * S * D + B * S, 4 * B * D * pairs
