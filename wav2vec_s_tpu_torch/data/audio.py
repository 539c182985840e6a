"""Audio IO without heavyweight deps (own copy of the readers of
``wav2vec_s_tpu/data/audio.py`` and of its log-mel ``logmel_fbank``, the
features of the fbank model family).

Re-provides the reference's waveform loading paths
(fairseq/fairseq/data/audio/raw_audio_dataset.py:54-71 via soundfile;
rain/data/st_raw_audio_triple_dataset.py:155-186 zip/flac/npy resolution):

- 16-bit PCM WAV via the stdlib ``wave`` module,
- ``.npy`` arrays,
- anything else through ``soundfile`` when installed (flac etc.),
- raw int16 little-endian with explicit ``.raw`` extension;

and a batch of them at once (``read_audio_batch``: the native reader of
``native/``, the batchers' path).

All readers return float32 in [-1, 1] at the file's native rate.
"""

from __future__ import annotations

import io
import wave
from pathlib import Path

import numpy as np


def _read_wav(path) -> tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, rate


def _read_bytes_blob(data: bytes, expected_rate) -> tuple[np.ndarray, int]:
    """Decode an in-memory npy / wav / flac blob
    (reference st_raw_audio_triple_dataset.py:110-147 magic-byte sniffing)."""
    f = io.BytesIO(data)
    if data[:2] == b"\x93N":                       # npy magic
        return np.load(f).astype(np.float32), expected_rate or 16000
    if data[:2] == b"RI":                          # RIFF/wav
        with wave.open(f, "rb") as w:
            rate = w.getframerate()
            raw = w.readframes(w.getnframes())
            width, channels = w.getsampwidth(), w.getnchannels()
        arr = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        if channels > 1:
            arr = arr.reshape(-1, channels).mean(axis=1)
        return arr, rate
    try:
        import soundfile as sf
    except ImportError as e:
        raise ImportError("decoding this embedded blob (flac?) needs the "
                          "optional 'soundfile' package") from e
    arr, rate = sf.read(f, dtype="float32")
    if arr.ndim > 1:
        arr = arr.mean(axis=1)
    return arr, rate


def _read_wav_segment(path, offset: int, length: int
                      ) -> tuple[np.ndarray, int]:
    """Sample segment [offset, offset+length) of a PCM wav (stdlib)."""
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        width = w.getsampwidth()
        channels = w.getnchannels()
        w.setpos(min(offset, w.getnframes()))
        raw = w.readframes(length)
    if width != 2:
        raise ValueError(f"segment reads support 16-bit PCM only: {path}")
    data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, rate


def read_audio(path, expected_rate: int | None = 16000) -> np.ndarray:
    """Load a waveform as float32 mono; checks the sample rate like the
    reference (raw_audio_dataset.py:236-241).

    Also accepts the reference's two segment syntaxes
    (``get_features_or_waveform``, st_raw_audio_triple_dataset.py:154-186):

    - ``<zip path>:<byte offset>:<byte length>`` — an audio blob embedded
      in an uncompressed zip container,
    - ``<wav/flac path>:<sample offset>:<n samples>`` — a sample segment
      of a long recording (the MuST-C *raw* manifests written by
      prep_mustc_data_raw.py; decoded via ``get_segment_waveform``,
      fairseq/fairseq/data/audio/audio_utils.py:38-54).
    """
    spath = str(path)
    if spath.count(":") == 2:
        base, off, size = spath.rsplit(":", 2)
        ext = Path(base).suffix.lower()
        if ext == ".wav":
            data, rate = _read_wav_segment(base, int(off), int(size))
        elif ext in (".flac", ".ogg"):
            try:
                import soundfile as sf
            except ImportError as e:
                raise ImportError(f"reading a segment of {base} needs the "
                                  "optional 'soundfile' package") from e
            data, rate = sf.read(base, dtype="float32", start=int(off),
                                 frames=int(size))
            if data.ndim > 1:
                data = data.mean(axis=1)
        else:       # .zip (reference) or any generic blob container (ours)
            with open(base, "rb") as f:
                f.seek(int(off))
                blob = f.read(int(size))
            data, rate = _read_bytes_blob(blob, expected_rate)
        if expected_rate is not None and rate != expected_rate:
            raise ValueError(f"{path}: sample rate {rate} != {expected_rate}")
        return np.ascontiguousarray(data, dtype=np.float32)
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix == ".wav":
        data, rate = _read_wav(p)
    elif suffix == ".npy":
        data = np.load(p).astype(np.float32)
        rate = expected_rate or 16000
    elif suffix == ".raw":
        data = np.fromfile(p, dtype="<i2").astype(np.float32) / 32768.0
        rate = expected_rate or 16000
    else:
        try:
            import soundfile as sf
        except ImportError as e:
            raise ImportError(
                f"reading {suffix} needs the optional 'soundfile' package"
            ) from e
        data, rate = sf.read(str(p), dtype="float32")
        if data.ndim > 1:
            data = data.mean(axis=1)
    if expected_rate is not None and rate != expected_rate:
        raise ValueError(f"{path}: sample rate {rate} != {expected_rate}")
    return np.ascontiguousarray(data, dtype=np.float32)


def read_audio_batch(paths, stride: int,
                     expected_rate: int | None = 16000) -> list:
    """Decode a batch of audio files: a list of float32 arrays.  Plain
    ``.wav`` paths go through the native parallel reader (a C++ thread
    pool, ``native/src/speech_native.cpp``) into one ``[n, stride]``
    buffer, each row a view of it; what the reader cannot read (not PCM16,
    longer than ``stride``, a segment path, ``.npy``, flac) and a file of
    another rate take ``read_audio``, which reads the rest or raises, as
    in the JAX package.  ``read_audio`` is the reader's twin: on mono
    PCM16 the two give the same bits."""
    paths = [str(p) for p in paths]
    outs: list = [None] * len(paths)
    wav_idx = [i for i, p in enumerate(paths) if p.endswith(".wav")]
    if wav_idx:
        from wav2vec_s_tpu_torch.native import read_wav_batch

        buf, lens, rates = read_wav_batch([paths[i] for i in wav_idx],
                                          stride)
        for j, i in enumerate(wav_idx):
            if lens[j] >= 0 and (expected_rate is None
                                 or rates[j] == expected_rate):
                outs[i] = buf[j, :lens[j]]
    for i, p in enumerate(paths):
        if outs[i] is None:
            outs[i] = read_audio(p, expected_rate)
    return outs


def write_wav(path, data: np.ndarray, rate: int = 16000) -> None:
    """Write float32 [-1, 1] mono as 16-bit PCM (test fixtures, demos)."""
    pcm = np.clip(data, -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def instance_normalize(wav: np.ndarray) -> np.ndarray:
    """Per-utterance layer-norm of the waveform (``normalize: true`` task
    option for large models, raw_audio_dataset.py:66-70)."""
    m = wav.mean()
    v = wav.var()
    return ((wav - m) / np.sqrt(v + 1e-5)).astype(np.float32)


FRAME = 400          # 25 ms window @ 16 kHz
SHIFT = 160          # 10 ms shift
N_FFT = 512


def _mel_fb(rate=16000, n_mels=80, n_fft=N_FFT):
    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz2mel(20), hz2mel(rate / 2), n_mels + 2)
    bins = np.floor((n_fft + 1) * mel2hz(mels) / rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, c, hi = bins[i], bins[i + 1], bins[i + 2]
        if c > lo:
            fb[i, lo:c] = (np.arange(lo, c) - lo) / (c - lo)
        if hi > c:
            fb[i, c:hi] = (hi - np.arange(c, hi)) / (hi - c)
    return fb


_MEL_FB = _mel_fb()


def fbank_frames(wav: np.ndarray, start: int, n: int) -> np.ndarray:
    """log-mel of frames [start/SHIFT, start/SHIFT + n) of the FULL
    signal ``wav`` (pre-emphasis over the whole signal, so a chunked
    extractor's frames equal the offline ones): float32 [n, 80]."""
    pe = np.empty_like(wav)
    pe[0] = wav[0]
    pe[1:] = wav[1:] - 0.97 * wav[:-1]
    idx = (np.arange(FRAME)[None, :] + start
           + SHIFT * np.arange(n)[:, None])
    frames = pe[idx] * np.hanning(FRAME)[None, :]
    spec = np.abs(np.fft.rfft(frames, N_FFT)) ** 2
    return np.log(np.maximum(spec @ _MEL_FB.T, 1e-10)).astype(np.float32)


def logmel_fbank(wav: np.ndarray) -> np.ndarray:
    """Kaldi-style log-mel filterbank (the fbank CAAT twin's features,
    rain/data/transforms/audio_encoder.py:11-17 via torchaudio): 80 mels,
    25 ms Hann windows every 10 ms at 16 kHz, pre-emphasis 0.97, float64
    inside, float32 [T_frames, 80] out (JAX ``data/audio.logmel_fbank`` at
    its defaults).  A signal shorter than one window is zero-padded to
    one frame."""
    if len(wav) < FRAME:
        wav = np.pad(wav, (0, FRAME - len(wav)))
    return fbank_frames(wav, 0, 1 + (len(wav) - FRAME) // SHIFT)
