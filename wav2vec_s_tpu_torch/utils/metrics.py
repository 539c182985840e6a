"""Progress logging of the training CLI (port of
``wav2vec_s_tpu/utils/metrics.py``): an items-per-second meter and the
json-lines progress records, same keys as the JAX package's (fairseq
logging/{meters,progress_bar}.py); TensorBoard writing is optional, gated
on the package being installed.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional


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
