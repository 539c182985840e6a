"""Metrics aggregation and progress logging (port of
``wav2vec_s_tpu/utils/metrics.py``): smoothed meters, nested aggregation
contexts, an items-per-second meter and the json-lines progress records
of the training CLI, same keys as the JAX package's (fairseq
logging/{metrics,meters,progress_bar}.py); TensorBoard writing is
optional, gated on the package being installed.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from collections import defaultdict
from typing import Dict, Optional


class AverageMeter:
    def __init__(self, round: Optional[int] = 3):
        self.round = round
        self.reset()

    def reset(self):
        self.sum, self.count = 0.0, 0

    def update(self, val, n=1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0


class TimeMeter:
    """items/sec meter (logging/meters.py:200-243)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.start = time.perf_counter()
        self.n = 0

    def update(self, n=1):
        self.n += n

    @property
    def avg(self):
        dt = time.perf_counter() - self.start
        return self.n / dt if dt > 0 else 0.0


class MetricsAggregator:
    """Named scalar aggregation with nested contexts
    (``metrics.aggregate``, logging/metrics.py:30-140)."""

    def __init__(self):
        self._stack = [defaultdict(AverageMeter)]

    @contextlib.contextmanager
    def aggregate(self):
        self._stack.append(defaultdict(AverageMeter))
        try:
            yield self._stack[-1]
        finally:
            child = self._stack.pop()
            for k, m in child.items():
                self._stack[-1][k].update(m.avg, m.count)

    def log_scalar(self, key: str, value, weight: int = 1):
        for frame in self._stack:
            frame[key].update(value, weight)

    def values(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self._stack[-1].items()}

    def reset(self):
        self._stack = [defaultdict(AverageMeter)]


class JsonProgress:
    """json-lines progress output (log_format=json,
    logging/progress_bar.py:287-330)."""

    def __init__(self, stream=None, tensorboard_dir: Optional[str] = None):
        self.stream = stream or sys.stdout
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
            except Exception:
                self._tb = None

    def log(self, stats: Dict[str, float], step: int, tag: str = "train"):
        rec = {"tag": tag, "step": step}
        rec.update({k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in stats.items()})
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()
        if self._tb is not None:
            for k, v in stats.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{tag}/{k}", v, step)
