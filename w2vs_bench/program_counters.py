"""The program's own counters (``wav2vec_s_tpu_torch.utils.debug``), which
count while a profiler runs: in a ``--trace 1`` run, summed over both
profiled slices (the device metrics' and the breakdown's; nothing resets
them in between, and a ratio of two counters is the same over one slice or
both).  A program without them (an older commit) gives nothing."""

from __future__ import annotations

from typing import Dict, Optional


def snapshot() -> Dict[str, int]:
    """The program's counters, or ``{}`` where it keeps none."""
    try:
        from wav2vec_s_tpu_torch.utils.debug import counters
    except ImportError:
        return {}
    return counters()


def share(part: str, base: str) -> Optional[float]:
    """100 x counter ``part`` over counter ``base``; None when ``base`` is
    0 (or absent)."""
    c = snapshot()
    if not c.get(base):
        return None
    return 100.0 * c.get(part, 0) / c[base]
