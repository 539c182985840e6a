"""Manifest readers for pre-training and fine-tuning (port of the audio
and S2T parts of ``wav2vec_s_tpu/data/manifests.py``).

- Pre-training manifests (``FileAudioDataset``,
  fairseq/fairseq/data/audio/raw_audio_dataset.py:227-262): first line is the
  audio root, then ``relpath\tnum_samples`` rows.
- Fine-tuning S2T tsv (``SpeechToTextDatasetCreator.from_tsv``,
  rain/data/st_raw_audio_triple_dataset.py:422-527): csv.DictReader tsv with
  mandatory columns id/audio/n_frames/tgt_text, optional src_text/speaker;
  audio paths relative to ``audio_root``.

The parallel-text manifests come with their task (ROADMAP item 12).
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import List, Optional


@dataclasses.dataclass
class AudioManifest:
    root: Path
    paths: List[str]
    sizes: List[int]

    def __len__(self):
        return len(self.paths)

    def full_path(self, i: int) -> Path:
        return self.root / self.paths[i]


def read_audio_manifest(path, min_sample_size: int = 0,
                        max_sample_size: Optional[int] = None
                        ) -> AudioManifest:
    """Rows shorter than ``min_sample_size`` are dropped; sizes are clipped
    to ``max_sample_size`` when it is given."""
    lines = Path(path).read_text(encoding="utf-8").splitlines()
    root = Path(lines[0].strip())
    paths, sizes = [], []
    for line in lines[1:]:
        if not line.strip():
            continue
        rel, sz = line.split("\t")
        sz = int(sz)
        if sz < min_sample_size:
            continue
        paths.append(rel)
        sizes.append(min(sz, max_sample_size) if max_sample_size else sz)
    return AudioManifest(root, paths, sizes)


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
