"""Device timing shared by ``chip_smoke.py`` and the tools."""

from __future__ import annotations

import torch


def graph_ms(fn, launches: int, reps: int = 20) -> float:
    """Device time per kernel launch, in ms: ``fn`` (which puts ``launches``
    kernel launches on the current stream and reads nothing back) is
    captured once in a CUDA graph and the graph replayed ``reps`` times
    between two events, so no host dispatch lies between the launches."""
    fn()                                      # warm-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * launches)
