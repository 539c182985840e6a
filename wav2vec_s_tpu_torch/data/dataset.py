"""Batch assembly for the two training recipes (host-side, numpy; port of
``wav2vec_s_tpu/data/dataset.py``).

- ``PretrainBatcher`` ~ ``RawAudioDataset.collater``
  (raw_audio_dataset.py:116-226): random-crop every utterance to the
  length bucket at or below the batch's shortest, plus the host-side span
  mask with one count of masked frames per row (``mask_positions``).
  Unlike the JAX batcher, whose one generator advances in the prefetch
  thread, each batch draws its crops and masks from a generator keyed on
  ``(seed, epoch, batch offset)``: a resumed run collates exactly the
  batches an uninterrupted one does (same distribution as the JAX one).
- ``CaatBatcher`` ~ ``SpeechToTextDataset.collater``
  (rain/data/st_raw_audio_triple_dataset.py:298-387): pad waveforms to the
  audio bucket, tokenize and pad targets to the text bucket; emits
  source / padding_mask / targets, identical to the JAX package's on the
  same manifest; ``features="fbank"`` collates log-mel frames [B, S, 80]
  after its ``transforms``;
- ``TextBatcher``: source and target token ids of a parallel-text
  manifest (the text CAAT family).

Under data parallelism each rank collates its ``rows`` of the global
batch (``parallel.mesh.process_local_rows``): it reads only their audio,
and every shape and draw is the global batch's (the crop bucket from the
size hint, the target bucket from every row's tokens, the crops and masks
drawn for every row, the manifest's sizes standing in for the audio it
does not read), so the ranks' rows are the rows one process collates.

``to_device`` moves a batch to the card in one pinned, non-blocking copy
per array.

Both audio batchers read their rows with ``data/audio.read_audio_batch``
(the native reader) at the stride of the longest row the manifest gives,
as the JAX batchers do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wav2vec_s_tpu_torch.data.audio import (
    instance_normalize, logmel_fbank, read_audio_batch)
from wav2vec_s_tpu_torch.data.batching import bucket_for
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.data.manifests import AudioManifest, S2TManifest
from wav2vec_s_tpu_torch.data.tokenizer import Tokenizer
from wav2vec_s_tpu_torch.models.feature_extractor import (
    DEFAULT_CONV_LAYERS, conv_output_length)
from wav2vec_s_tpu_torch.utils.masking import (
    compute_span_mask_np, expected_mask_count)


@dataclasses.dataclass
class PretrainBatcher:
    manifest: AudioManifest
    buckets: Sequence[int]
    mask_prob: float = 0.65
    mask_length: int = 10
    normalize: bool = False
    seed: int = 1
    conv_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS

    def collate(self, indices: np.ndarray, size_hint: Optional[int] = None,
                key: Tuple[int, int] = (0, 0),
                rows: Optional[slice] = None) -> Dict[str, np.ndarray]:
        """``size_hint``: the batch's shortest sample size according to the
        manifest (clipped to the largest bucket); ``key``: (epoch, batch
        offset) of the batch, which with ``seed`` keys its generator;
        ``rows``: the rows of the batch to return (module docstring).
        -> {source [B, T] float32, mask_positions [B, M] int32}."""
        rng = np.random.default_rng((self.seed, *key))
        rows = rows or slice(0, len(indices))
        mine = indices[rows]
        wavs = read_audio_batch(
            [self.manifest.full_path(i) for i in mine],
            int(max(self.manifest.sizes[i] for i in mine)))
        if self.normalize:
            wavs = [instance_normalize(w) for w in wavs]
        shortest = min(len(w) for w in wavs)
        if size_hint is not None:
            shortest = min(shortest, size_hint)
        # crop to the bucket at/below the batch's shortest (no padding in
        # pre-training: crop-only, like pad_audio=False in the reference)
        usable = [b for b in self.buckets if b <= shortest]
        T = usable[-1] if usable else self.buckets[0]
        out = np.zeros((len(wavs), T), np.float32)
        for r, i in enumerate(indices):
            mine = rows.start <= r < rows.stop
            n = (len(wavs[r - rows.start]) if mine
                 else int(self.manifest.sizes[i]))
            start = rng.integers(0, n - T + 1) if n > T else 0
            if mine:
                w = wavs[r - rows.start]
                out[r - rows.start, :min(T, len(w))] = w[start:start + T]

        frames = conv_output_length(T, self.conv_layers)
        M = expected_mask_count(frames, self.mask_prob, self.mask_length)
        mask = compute_span_mask_np(
            (len(indices), frames), None, self.mask_prob, self.mask_length,
            rng, exact_count=M)[rows]
        positions = np.zeros((len(wavs), M), np.int32)
        for r in range(len(wavs)):
            positions[r] = np.flatnonzero(mask[r])[:M]
        return {"source": out, "mask_positions": positions}


@dataclasses.dataclass
class CaatBatcher:
    manifest: S2TManifest
    tgt_dict: Dictionary
    tokenizer: Tokenizer
    audio_buckets: Sequence[int]
    target_buckets: Sequence[int] = (16, 32, 64, 128)
    task_type: str = "st"              # "st" -> tgt_text, "asr" -> src_text
    normalize: bool = False
    features: str = "raw"              # "raw" waveform | "fbank" log-mel
    transforms: Sequence = ()          # fbank feature transforms (Whiten,
    # TFMask), applied in order after the log-mel; a validation batcher
    # leaves TFMask out

    def encode_target(self, idx: int) -> List[int]:
        text = (self.manifest.tgt_texts[idx] if self.task_type != "asr"
                else (self.manifest.src_texts[idx]
                      or self.manifest.tgt_texts[idx]))
        pieces = self.tokenizer.encode(text)
        return self.tgt_dict.encode(pieces, append_eos=True)

    def collate(self, indices: np.ndarray,
                size_hint: Optional[int] = None,
                rows: Optional[slice] = None) -> Dict[str, np.ndarray]:
        """``size_hint``: the batch's longest audio according to the
        manifest (samples; log-mel frames for fbank); the pad bucket covers
        it even where a file is shorter than its manifest row says.
        ``rows``: the rows of the batch to return (module docstring).
        -> {source [B, S] float32 ([B, S, 80] for fbank), padding_mask
        [B, S], targets [B, U] int32}."""
        rows = rows or slice(0, len(indices))
        targets = [np.asarray(self.encode_target(i), np.int64)
                   for i in indices]
        U = bucket_for(max(len(t) for t in targets), self.target_buckets)
        mine = indices[rows]
        wavs = []
        for wav in read_audio_batch(
                [self.manifest.audio_paths[i] for i in mine],
                int(max(self.manifest.n_frames[i] for i in mine))):
            if self.normalize:
                wav = instance_normalize(wav)
            if self.features == "fbank":
                wav = logmel_fbank(wav)               # [T_frames, 80]
                for t in self.transforms:
                    wav = t(wav)
            wavs.append(wav)
        targets = targets[rows]

        S = bucket_for(max([len(w) for w in wavs] + [size_hint or 0]),
                       self.audio_buckets)
        B = len(wavs)
        src = np.zeros((B, S) + wavs[0].shape[1:], np.float32)
        pad_mask = np.ones((B, S), bool)
        tgt = np.full((B, U), self.tgt_dict.pad(), np.int32)
        for r, (w, t) in enumerate(zip(wavs, targets)):
            w = w[:S]
            src[r, :len(w)] = w
            pad_mask[r, :len(w)] = False
            t = t[:U]
            tgt[r, :len(t)] = t
        return {"source": src, "padding_mask": pad_mask, "targets": tgt}


@dataclasses.dataclass
class TextBatcher:
    """Parallel-text collater of the text-source CAAT family (port of the
    JAX ``TextBatcher``; the reference's bitext path,
    rain/tasks/dropout_translation.py over ``TranslationTask`` +
    ``BpeDropoutDataset``): tokenize both sides (the source with BPE
    dropout when its tokenizer carries it), append eos, pad to static
    buckets.  Emits {source [B, S] int32 tokens, targets [B, U] int32},
    the batch contract of ``CaatBatcher`` with token ids in place of
    waveforms; ``rows`` as there (the buckets from every row)."""

    manifest: S2TManifest
    tgt_dict: Dictionary
    tokenizer: Tokenizer                     # target side
    src_buckets: Sequence[int] = (16, 32, 64, 128, 256, 512)
    target_buckets: Sequence[int] = (16, 32, 64, 128)
    src_dict: Optional[Dictionary] = None    # None -> shared with target
    src_tokenizer: Optional[Tokenizer] = None  # None -> shared

    def _encode(self, text: str, src: bool) -> List[int]:
        tok = (self.src_tokenizer or self.tokenizer) if src \
            else self.tokenizer
        d = (self.src_dict or self.tgt_dict) if src else self.tgt_dict
        return d.encode(tok.encode(text), append_eos=True)

    def collate(self, indices: np.ndarray, size_hint: Optional[int] = None,
                rows: Optional[slice] = None) -> Dict[str, np.ndarray]:
        rows = rows or slice(0, len(indices))
        srcs = [np.asarray(self._encode(self.manifest.src_texts[i], True),
                           np.int64) for i in indices]
        tgts = [np.asarray(self._encode(self.manifest.tgt_texts[i], False),
                           np.int64) for i in indices]
        S = bucket_for(max([len(s) for s in srcs] + [size_hint or 0]),
                       self.src_buckets)
        U = bucket_for(max(len(t) for t in tgts), self.target_buckets)
        srcs, tgts = srcs[rows], tgts[rows]
        B = len(srcs)
        src = np.full((B, S), (self.src_dict or self.tgt_dict).pad(),
                      np.int32)
        tgt = np.full((B, U), self.tgt_dict.pad(), np.int32)
        for r, (s, t) in enumerate(zip(srcs, tgts)):
            src[r, :len(s[:S])] = s[:S]
            tgt[r, :len(t[:U])] = t[:U]
        return {"source": src, "targets": tgt}


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: one pinned, non-blocking copy
    per array on a CUDA device (integer targets as int64, the dtype the
    embedding and the loss index with)."""
    out = {}
    for name, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if t.dtype == torch.int32:
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[name] = t
    return out
