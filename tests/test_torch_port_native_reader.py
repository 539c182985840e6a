"""The native batched WAV reader of the torch port
(``wav2vec_s_tpu_torch/native/``, ``data/audio.read_audio_batch``) against
the JAX package's ``read_audio_batch`` and the port's per-file
``read_audio`` (its twin).

- Mono PCM16 (a ``LIST`` chunk before ``data``, an odd-sized chunk, rows
  of several lengths): every row bit-equal to both, each a view of one
  ``[n, stride]`` buffer.
- What the reader hands back to ``read_audio`` (a file longer than the
  stride, ``.npy``, a segment path ``path:offset:length``, 8-bit PCM):
  the same values as JAX; a file of another rate raises as in JAX.
- Stereo: the reader sums the int16 channels and scales by 1/(32768 C),
  ``read_audio`` averages the float32 channels; with 2 channels both are
  exact and equal bit for bit, with 3 they differ by at most one unit in
  the last place (the product by a rounded 1/(3 * 32768)).
- The library: built by ``g++`` into ``_build/`` under a hash of its
  source, by several threads at once without a torn file; a source that
  does not compile raises with the compiler's output.
- Both batchers read their rows through the reader, at the stride of the
  longest row the manifest gives.
"""

import struct
import threading
from pathlib import Path

import numpy as np
import pytest

from wav2vec_s_tpu.data import audio as jax_audio
from wav2vec_s_tpu_torch import native
from wav2vec_s_tpu_torch.data import audio

RATE = 16000


def _wav(path: Path, pcm: np.ndarray, rate=RATE, channels=1, bits=16,
         extra_chunks=()):
    """A RIFF/WAVE file written by hand: ``extra_chunks`` ([(id, bytes)])
    before ``data``, each padded to an even size."""
    data = pcm.astype("<i2" if bits == 16 else np.uint8).tobytes()
    fmt = struct.pack("<HHIIHH", 1, channels, rate,
                      rate * channels * bits // 8, channels * bits // 8, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    for cid, payload in extra_chunks:
        body += cid + struct.pack("<I", len(payload)) + payload
        body += b"\0" * (len(payload) % 2)
    body += b"data" + struct.pack("<I", len(data)) + data
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return str(path)


def _pcm(rng, n, channels=1):
    return rng.integers(-32768, 32768, (n, channels) if channels > 1
                        else n).astype(np.int16)


@pytest.fixture
def files(tmp_path):
    rng = np.random.default_rng(0)
    out = {"plain": [_wav(tmp_path / f"m{i}.wav", _pcm(rng, n))
                     for i, n in enumerate((4000, 1, 9000, 2500))]}
    out["list"] = _wav(tmp_path / "list.wav", _pcm(rng, 3000),
                       extra_chunks=[(b"LIST", b"INFOISFT" + b"x" * 13),
                                     (b"junk", b"abc")])
    out["long"] = _wav(tmp_path / "long.wav", _pcm(rng, 12000))
    np.save(tmp_path / "a.npy", rng.standard_normal(2000).astype(np.float32))
    out["npy"] = str(tmp_path / "a.npy")
    out["segment"] = f"{out['long']}:100:5000"
    out["bytes8"] = _wav(tmp_path / "u8.wav",
                         rng.integers(0, 256, 1500), bits=8)
    out["rate8k"] = _wav(tmp_path / "r8k.wav", _pcm(rng, 800), rate=8000)
    out["stereo"] = _wav(tmp_path / "st.wav", _pcm(rng, 2000, 2).reshape(-1),
                         channels=2)
    out["three"] = _wav(tmp_path / "c3.wav", _pcm(rng, 2000, 3).reshape(-1),
                        channels=3)
    return out


STRIDE = 10000


def test_mono_pcm16_equals_jax_and_the_per_file_twin_bit_for_bit(files):
    paths = files["plain"] + [files["list"]]
    got = audio.read_audio_batch(paths, STRIDE)
    want = jax_audio.read_audio_batch(paths, STRIDE)
    base = got[0].base
    assert base is not None and base.shape == (len(paths), STRIDE)
    for p, a, b in zip(paths, got, want):
        assert a.dtype == np.float32 and a.base is base
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, audio.read_audio(p))
    assert [len(a) for a in got] == [4000, 1, 9000, 2500, 3000]


@pytest.mark.parametrize("case", ["long", "npy", "segment", "bytes8"])
def test_what_the_reader_hands_back_reads_as_in_jax(files, case):
    """Longer than the stride, not a plain ``.wav``, or not PCM16: the
    per-file reader, in both packages."""
    paths = [files["plain"][0], files[case]]
    buf, lens, _ = native.read_wav_batch([files["plain"][0], files["long"],
                                          files["bytes8"]], STRIDE)
    assert list(lens) == [4000, -1, -1]
    assert not buf[1:].any()
    got = audio.read_audio_batch(paths, STRIDE)
    want = jax_audio.read_audio_batch(paths, STRIDE)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], audio.read_audio(files[case]))


def test_another_rate_raises_as_in_jax(files):
    paths = [files["plain"][0], files["rate8k"]]
    for read in (audio.read_audio_batch, jax_audio.read_audio_batch):
        with pytest.raises(ValueError, match="sample rate 8000 != 16000"):
            read(paths, STRIDE)
    got = audio.read_audio_batch(paths, STRIDE, expected_rate=None)
    np.testing.assert_array_equal(got[1], audio.read_audio(
        files["rate8k"], None))


def test_multichannel_sums_then_scales(files):
    """2 channels: both paths exact, equal bits; 3 channels: the reader's
    product by the rounded 1/(3 * 32768) is at most one unit in the last
    place from the twin's mean."""
    got = audio.read_audio_batch([files["stereo"], files["three"]], STRIDE)
    want = jax_audio.read_audio_batch([files["stereo"], files["three"]],
                                      STRIDE)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], audio.read_audio(files["stereo"]))
    twin = audio.read_audio(files["three"])
    ulps = np.abs(got[1].view(np.int32) - twin.view(np.int32))
    assert ulps.max() <= 1 and ulps.any()


def test_the_library_builds_into_the_build_dir_by_its_hash(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    errors = []

    def load():
        try:
            native.library()
        except Exception as e:          # noqa: BLE001 - collected for assert
            errors.append(e)

    threads = [threading.Thread(target=load) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    (built,) = (tmp_path / "_build").iterdir()     # no temporary left
    assert built.name.startswith("libspeech_native_")
    assert built.suffix == ".so"
    assert Path(native.__file__).parent.joinpath(
        "src", "speech_native.cpp") == native.SOURCE


def test_a_source_that_does_not_compile_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int read_wav_batch( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.library()
    assert "broken.cpp" in str(err.value) and "error" in str(err.value)
    assert list((tmp_path / "_build").iterdir()) == []


def test_both_batchers_read_through_the_reader(tmp_path, monkeypatch):
    """``PretrainBatcher`` and ``CaatBatcher`` call the reader once per
    collate, with their rows' paths and the longest manifest size as the
    stride."""
    from wav2vec_s_tpu_torch.data import dataset
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary
    from wav2vec_s_tpu_torch.data.manifests import (
        read_audio_manifest, read_s2t_manifest)
    from wav2vec_s_tpu_torch.data.tokenizer import build_tokenizer

    rng = np.random.default_rng(1)
    sizes = (32000, 52000, 41000, 60000)
    rows, s2t = [str(tmp_path)], ["id\taudio\tn_frames\ttgt_text"]
    for i, n in enumerate(sizes):
        _wav(tmp_path / f"u{i}.wav", _pcm(rng, n))
        rows.append(f"u{i}.wav\t{n}")
        s2t.append(f"u{i}\t{tmp_path}/u{i}.wav\t{n}\thallo welt")
    (tmp_path / "pre.tsv").write_text("\n".join(rows) + "\n")
    (tmp_path / "s2t.tsv").write_text("\n".join(s2t) + "\n")
    (tmp_path / "dict.txt").write_text("hallo 1\nwelt 1\n")
    calls = []
    real = native.read_wav_batch

    def spy(paths, stride, *args):
        calls.append(([Path(p).name for p in paths], stride))
        return real(paths, stride, *args)

    monkeypatch.setattr(native, "read_wav_batch", spy)
    pre = dataset.PretrainBatcher(read_audio_manifest(tmp_path / "pre.tsv"),
                                  buckets=(32000,))
    pre.collate(np.arange(4), rows=slice(2, 4))
    caat = dataset.CaatBatcher(
        read_s2t_manifest(tmp_path / "s2t.tsv"),
        Dictionary.load(tmp_path / "dict.txt"), build_tokenizer("word"),
        audio_buckets=(64000,))
    out = caat.collate(np.arange(3))
    assert calls == [(["u2.wav", "u3.wav"], 60000),
                     (["u0.wav", "u1.wav", "u2.wav"], 52000)]
    np.testing.assert_array_equal(out["source"][1, :52000],
                                  audio.read_audio(tmp_path / "u1.wav"))
