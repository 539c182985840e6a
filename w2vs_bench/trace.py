"""The benchmark's own spans and the profiled slice of a ``--trace 1`` run.

Spans are ``torch.profiler.record_function`` ranges named ``w2vs/<call>``
around each call the drivers make into a layer of the program; they cost
nothing in an untraced run (``Tracer.span`` is then a null context).  The
slice is read from the profiler's raw events: the device operations
(kernels, copies, sets) with their intervals, and the spans.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Tuple

from w2vs_bench.work import busy_us, gaps

SPAN = "w2vs/"


@dataclasses.dataclass
class Slice:
    """A profiled stretch of the window and what the driver did in it."""

    kernels: List[Tuple[str, float, float]]     # device ops, us
    spans: List[Tuple[str, float, float]]       # the drivers' spans, us
    host_ops: List[Tuple[str, float, float]]    # host operators, us
    wall_s: float
    work: dict                                  # the driver's counts

    @property
    def busy_s(self) -> float:
        return busy_us((s, e) for _, s, e in self.kernels) / 1e6

    def device_s(self, *patterns: str) -> float:
        """Device seconds of the operations whose name holds a pattern."""
        return sum(e - s for n, s, e in self.kernels
                   if any(p in n for p in patterns)) / 1e6


class Tracer:
    def __init__(self, active: bool):
        self.active = active

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(SPAN + name)

    @contextlib.contextmanager
    def profile(self, on_card: bool, host: bool):
        """Profile the body; yields a dict that holds ``kernels``,
        ``spans``, ``host_ops`` and ``wall_s`` once the body has run (and
        synchronized).  ``host`` adds the host's operators and the spans,
        which slows the host about twice over (a per-operator callback):
        the device metrics come from a slice without them, the breakdown
        of idle time from one with them."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if host or not on_card else []
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        out: Dict[str, object] = {}
        with profile(activities=acts) as prof:
            t = time.perf_counter()
            yield out
            if on_card:
                torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - t
        out["kernels"], out["spans"], out["host_ops"] = _events(prof)


def _events(prof):
    from torch.autograd import DeviceType

    kernels, spans, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append((e.name(), start, end))
        elif e.is_user_annotation():
            if e.name().startswith(SPAN):
                spans.append((e.name()[len(SPAN):], start, end))
        else:
            host.append((e.name(), start, end))
    host.sort(key=lambda t: t[1])
    return kernels, spans, host


def _innermost(items, starts, t, look=64):
    """Name of the shortest of ``items`` (sorted by start) that holds t."""
    i = bisect.bisect_right(starts, t)
    best = None
    for n, s, e in items[max(0, i - look):i]:
        if s <= t <= e and (best is None or e - s < best[0]):
            best = (e - s, n)
    return best[1] if best else None


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The device operations that took most time, and the idle stretches
    of the device summed by the innermost span the host was in."""
    by_op = defaultdict(float)
    for n, s, e in sl.kernels:
        by_op[n[:120]] += (e - s) / 1e6
    idle = defaultdict(float)
    spans = sorted(sl.spans, key=lambda t: t[1])
    span_starts = [s for _, s, _ in spans]
    op_starts = [s for _, s, _ in sl.host_ops]
    for a, b in gaps((s, e) for _, s, e in sl.kernels):
        mid = (a + b) / 2
        where = _innermost(spans, span_starts, mid, look=len(spans))
        op = _innermost(sl.host_ops, op_starts, mid)
        idle[f"{where or 'outside spans'} / {op or 'python'}"] += (
            (b - a) / 1e6)
    return {"device_ops": sorted(([k, v] for k, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:top]}
