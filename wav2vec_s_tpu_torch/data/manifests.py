"""Manifest reader for the fine-tuning S2T tsv (port of the S2T parts of
``wav2vec_s_tpu/data/manifests.py``).

``SpeechToTextDatasetCreator.from_tsv``
(rain/data/st_raw_audio_triple_dataset.py:422-527): csv.DictReader tsv with
mandatory columns id/audio/n_frames/tgt_text, optional src_text/speaker;
audio paths relative to ``audio_root``.  The pre-training and parallel-text
manifests come with their tasks.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import List


@dataclasses.dataclass
class S2TManifest:
    ids: List[str]
    audio_paths: List[str]
    n_frames: List[int]
    tgt_texts: List[str]
    src_texts: List[str]
    speakers: List[str]

    def __len__(self):
        return len(self.ids)


def read_s2t_manifest(path, audio_root: str = "") -> S2TManifest:
    root = Path(audio_root) if audio_root else None
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(
            f, delimiter="\t", quotechar=None, doublequote=False,
            lineterminator="\n", quoting=csv.QUOTE_NONE)
        rows = list(reader)
    return S2TManifest(
        ids=[r["id"] for r in rows],
        audio_paths=[str(root / r["audio"]) if root else r["audio"]
                     for r in rows],
        n_frames=[int(r["n_frames"]) for r in rows],
        tgt_texts=[r["tgt_text"] for r in rows],
        src_texts=[r.get("src_text", "") for r in rows],
        speakers=[r.get("speaker", "") for r in rows],
    )
