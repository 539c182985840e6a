"""Manifest readers for pre-training and fine-tuning (port of the audio,
S2T and parallel-text parts of ``wav2vec_s_tpu/data/manifests.py``).

- Pre-training manifests (``FileAudioDataset``,
  fairseq/fairseq/data/audio/raw_audio_dataset.py:227-262): first line is the
  audio root, then ``relpath\tnum_samples`` rows.
- Fine-tuning S2T tsv (``SpeechToTextDatasetCreator.from_tsv``,
  rain/data/st_raw_audio_triple_dataset.py:422-527): csv.DictReader tsv with
  mandatory columns id/audio/n_frames/tgt_text, optional src_text/speaker;
  audio paths relative to ``audio_root``.

- Parallel-text manifests of the text CAAT family (``read_text_manifest``):
  a tsv with src_text/tgt_text columns, or a ``src.txt,tgt.txt`` pair.
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


def read_text_manifest(path) -> S2TManifest:
    """Parallel-text manifest for the text-source CAAT family (the
    reference trains those via fairseq bitext tasks —
    rain/tasks/dropout_translation.py over ``TranslationTask`` data).

    Accepts either a tsv with ``src_text``/``tgt_text`` columns (id
    optional) or a pair of plain text files ``src.txt,tgt.txt``.  Returns
    an ``S2TManifest`` whose ``n_frames`` is the whitespace token count of
    the source side (the batching size key), so the train CLI's manifest
    plumbing is shared with the speech tasks.
    """
    if "," in str(path):
        src_p, tgt_p = str(path).split(",", 1)
        src = Path(src_p).read_text(encoding="utf-8").splitlines()
        tgt = Path(tgt_p).read_text(encoding="utf-8").splitlines()
        if len(src) != len(tgt):
            raise ValueError(
                f"parallel text length mismatch: {len(src)} vs {len(tgt)}")
        ids = [str(i) for i in range(len(src))]
    else:
        with open(path, newline="", encoding="utf-8") as f:
            reader = csv.DictReader(
                f, delimiter="\t", quotechar=None, doublequote=False,
                lineterminator="\n", quoting=csv.QUOTE_NONE)
            rows = list(reader)
        src = [r["src_text"] for r in rows]
        tgt = [r["tgt_text"] for r in rows]
        ids = [r.get("id", str(i)) for i, r in enumerate(rows)]
    return S2TManifest(
        ids=ids, audio_paths=[""] * len(src),
        n_frames=[len(s.split()) + 1 for s in src],
        tgt_texts=tgt, src_texts=src, speakers=[""] * len(src))
