"""Observability and failure detection (port of
``wav2vec_s_tpu/utils/debug.py``):

- ``profile_trace`` — twin of ``--profile`` (fairseq_cli/hydra_train.py:
  40-43): ``torch.profiler`` over the CPU and CUDA activities of a region,
  written as a Chrome trace (``trace.json``) into ``logdir``, opened in
  Perfetto or ``chrome://tracing``.
- ``span`` and ``count`` — the program's own tracing: named ranges of the
  trace (``torch.profiler.record_function``, named ``w2vs/<name>``; the
  twin of trainer.py:754-795) and a table of named integer counters
  (``counters`` reads it, ``reset_counters`` empties it).  Both act only
  while a ``torch.profiler`` runs in the process (``tracing()``); else
  ``span`` returns a shared null context and ``count`` returns after that
  one test.  A counter is computed on the host from what the code already
  holds there: no device op, read or synchronize.
- ``NanDetector`` — twin of fairseq/fairseq/nan_detector.py: names every
  non-finite tensor of a mapping (a state dict, the logs, the gradients)
  by its key, the fairseq name, with its count.
- ``Watchdog`` — twin of ``DistributedTimeoutWrapper``
  (fairseq/fairseq/distributed/distributed_timeout_wrapper.py): a
  background thread that signals the process if ``ping()`` is not called
  within ``timeout`` seconds (a wedged kernel or collective).
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
from typing import Dict, Iterator, List, Mapping, Optional

import torch


class Profile:
    """A started ``torch.profiler`` trace of CPU and CUDA activity that
    ``stop`` writes to ``<logdir>/trace.json``."""

    def __init__(self, logdir: str):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.logdir = logdir
        self.prof = profile(activities=activities)
        self.prof.__enter__()

    def stop(self) -> str:
        """End the trace and write it; returns the file's path."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "trace.json")
        self.prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[Profile]:
    """Trace the region (CPU and, where there is a card, CUDA activity)
    into ``<logdir>/trace.json``."""
    prof = Profile(logdir)
    try:
        yield prof
    finally:
        prof.stop()


#: the prefix of every span of the program (the benchmark's breakdown reads
#: ranges under it as the innermost spans the host was in)
SPAN = "w2vs/"
#: True while a ``torch.profiler`` (any activity) runs in the process
tracing = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_counters: Dict[str, int] = {}


def span(name: str):
    """A named range ``w2vs/<name>`` of the trace while tracing, else the
    shared null context."""
    if not tracing():
        return _NULL
    return torch.profiler.record_function(SPAN + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing."""
    if not tracing():
        return
    _counters[name] = _counters.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()


class NanDetector:
    """Find non-finite values in mappings of named tensors."""

    @staticmethod
    def check(tensors: Mapping[str, torch.Tensor],
              name: str = "tensors") -> List[str]:
        """One entry ``"<name>[<key>]: <bad>/<size> non-finite"`` per
        floating tensor of ``tensors`` that holds a NaN or an infinity."""
        bad = []
        for key, t in tensors.items():
            if t is None:
                continue
            t = torch.as_tensor(t)
            if hasattr(t, "full_tensor"):           # an FSDP2 DTensor
                t = t.to_local()
            if not t.is_floating_point():
                continue
            n_bad = int((~torch.isfinite(t.detach())).sum())
            if n_bad:
                bad.append(f"{name}[{key!r}]: {n_bad}/{t.numel()} "
                           f"non-finite")
        return bad

    @staticmethod
    def assert_finite(tensors: Mapping[str, torch.Tensor],
                      name: str = "tensors") -> None:
        bad = NanDetector.check(tensors, name)
        if bad:
            raise FloatingPointError("; ".join(bad))


class Watchdog:
    """Signal the process if no heartbeat arrives within ``timeout`` seconds.

    Usage:
        wd = Watchdog(timeout=300); wd.start()
        for batch in data: wd.ping(); train_step(...)
        wd.stop()
    """

    def __init__(self, timeout: float, sig=signal.SIGUSR1):
        self.timeout = timeout
        self.sig = sig
        self._event = threading.Event()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    def _run(self):
        while not self._stopped.is_set():
            if not self._event.wait(self.timeout):
                if self._stopped.is_set():
                    return
                self.fired = True
                os.kill(os.getpid(), self.sig)
                return
            self._event.clear()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="Watchdog")
        self._thread.start()

    def ping(self):
        self._event.set()

    def stop(self):
        self._stopped.set()
        self._event.set()
        if self._thread:
            self._thread.join(timeout=1)
