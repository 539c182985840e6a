"""Batch assembly for CAAT fine-tuning (host-side, numpy; port of
``CaatBatcher`` of ``wav2vec_s_tpu/data/dataset.py``, raw-waveform features).

Twin of ``SpeechToTextDataset.collater``
(rain/data/st_raw_audio_triple_dataset.py:298-387): pad waveforms to the
audio bucket, tokenize and pad targets to the text bucket; emits
source / padding_mask / targets as numpy arrays, identical to the JAX
package's on the same manifest.  ``to_device`` moves a batch to the card in
one pinned, non-blocking copy per array.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from wav2vec_s_tpu_torch.data.audio import instance_normalize, read_audio
from wav2vec_s_tpu_torch.data.batching import bucket_for
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.data.manifests import S2TManifest
from wav2vec_s_tpu_torch.data.tokenizer import Tokenizer


@dataclasses.dataclass
class CaatBatcher:
    manifest: S2TManifest
    tgt_dict: Dictionary
    tokenizer: Tokenizer
    audio_buckets: Sequence[int]
    target_buckets: Sequence[int] = (16, 32, 64, 128)
    task_type: str = "st"              # "st" -> tgt_text, "asr" -> src_text
    normalize: bool = False

    def encode_target(self, idx: int) -> List[int]:
        text = (self.manifest.tgt_texts[idx] if self.task_type != "asr"
                else (self.manifest.src_texts[idx]
                      or self.manifest.tgt_texts[idx]))
        pieces = self.tokenizer.encode(text)
        return self.tgt_dict.encode(pieces, append_eos=True)

    def collate(self, indices: np.ndarray,
                size_hint: Optional[int] = None) -> Dict[str, np.ndarray]:
        """``size_hint``: the batch's longest audio in samples according to
        the manifest; the pad bucket covers it even where a file is
        shorter than its manifest row says."""
        wavs, targets = [], []
        for i in indices:
            wav = read_audio(self.manifest.audio_paths[i])
            wavs.append(instance_normalize(wav) if self.normalize else wav)
            targets.append(np.asarray(self.encode_target(i), np.int64))

        S = bucket_for(max([len(w) for w in wavs] + [size_hint or 0]),
                       self.audio_buckets)
        U = bucket_for(max(len(t) for t in targets), self.target_buckets)
        B = len(wavs)
        src = np.zeros((B, S), np.float32)
        pad_mask = np.ones((B, S), bool)
        tgt = np.full((B, U), self.tgt_dict.pad(), np.int32)
        for r, (w, t) in enumerate(zip(wavs, targets)):
            w = w[:S]
            src[r, :len(w)] = w
            pad_mask[r, :len(w)] = False
            t = t[:U]
            tgt[r, :len(t)] = t
        return {"source": src, "padding_mask": pad_mask, "targets": tgt}


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
