"""The native batched WAV reader of the data loader, loaded with ctypes
(own copy of ``read_wav_batch`` of ``wav2vec_s_tpu/native/``; the JAX
package's Levenshtein, BLEU-count and batching helpers are not ported:
the port's pure-Python paths give the same results).

``src/speech_native.cpp`` is built with ``g++`` at first use, into
``wav2vec_s_tpu_torch/_build/`` (git-ignored), under a name that carries a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  The library is written under a
temporary name and renamed into place, so processes that build it at once
(test workers) never load half a file.  A failed build raises with the
compiler's output: there is no silent per-file path for the whole batch
(``data/audio.read_audio_batch`` reads per file only what the reader
reports it cannot read).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "src" / "speech_native.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
THREADS = 8

_lib: Optional[ctypes.CDLL] = None


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if done.returncode:
            raise RuntimeError(f"g++ failed ({done.returncode}) building "
                               f"{SOURCE.name}:\n{done.stdout}"
                               f"{done.stderr}")
        os.replace(tmp, target)        # atomic: a reader never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library() -> ctypes.CDLL:
    """The loaded reader library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    target = BUILD_DIR / f"libspeech_native_{h.hexdigest()[:16]}.so"
    if not target.exists():
        _build(target)
    lib = ctypes.CDLL(str(target))
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    pf32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.read_wav_batch.restype = i64
    lib.read_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i64, pf32, i64, p64, p64, i64]
    _lib = lib
    return lib


def read_wav_batch(paths: List[str], stride: int, threads: int = THREADS
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode PCM16 WAV files in parallel (a C++ thread pool) into a fresh
    zero-filled [n, stride] float32 buffer: (buffer, lens, rates), with
    ``lens[i] = -1`` for a file the reader cannot handle (not PCM16
    RIFF/WAVE, truncated, or longer than ``stride``)."""
    lib = library()
    n = len(paths)
    out = np.zeros((n, stride), np.float32)
    lens = np.zeros(n, np.int64)
    rates = np.zeros(n, np.int64)
    encoded = [os.fsencode(str(p)) for p in paths]   # alive for the call
    arr = (ctypes.c_char_p * n)(*encoded)
    lib.read_wav_batch(arr, n, out, stride, lens, rates, threads)
    return out, lens, rates
