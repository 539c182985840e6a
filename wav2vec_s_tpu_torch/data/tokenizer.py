"""Text tokenizers (own copy of ``wav2vec_s_tpu/data/tokenizer.py``).

Re-provides the reference's text pipeline (sentencepiece via
``TextEncoder``, rain/data/transforms/text_encoder.py:59-150, incl. BPE
dropout ``--bpe-dropout 0.1``):

- ``SentencePieceTokenizer`` — thin wrapper, used when the optional
  ``sentencepiece`` package is installed (the published vocabs are spm).
- ``WordTokenizer`` / ``CharTokenizer`` — dependency-free fallbacks for
  training from scratch and for tests.

All tokenizers map text -> list[str] pieces; Dictionary maps pieces -> ids.
"""

from __future__ import annotations

from typing import List, Optional, Protocol


class Tokenizer(Protocol):
    def encode(self, text: str) -> List[str]: ...
    def decode(self, pieces: List[str]) -> str: ...


class WordTokenizer:
    def encode(self, text: str) -> List[str]:
        return text.strip().split()

    def decode(self, pieces: List[str]) -> str:
        return " ".join(pieces)


class CharTokenizer:
    """Characters with '▁' word boundaries (spm-compatible surface form)."""

    def encode(self, text: str) -> List[str]:
        return [c for w in text.strip().split() for c in ("▁" + w)]

    def decode(self, pieces: List[str]) -> str:
        return "".join(pieces).replace("▁", " ").strip()


class SentencePieceTokenizer:
    def __init__(self, model_path: str, bpe_dropout: float = 0.0):
        try:
            import sentencepiece as spm
        except ImportError as e:
            raise ImportError(
                "sentencepiece is not installed; use WordTokenizer/"
                "CharTokenizer or install the optional dependency") from e
        self.sp = spm.SentencePieceProcessor()
        self.sp.Load(model_path)
        self.bpe_dropout = bpe_dropout

    def encode(self, text: str) -> List[str]:
        if self.bpe_dropout > 0:
            return self.sp.SampleEncodeAsPieces(text, -1, self.bpe_dropout)
        return self.sp.EncodeAsPieces(text)

    def decode(self, pieces: List[str]) -> str:
        return self.sp.DecodePieces(pieces)


def build_tokenizer(kind: str = "word", model_path: Optional[str] = None,
                    bpe_dropout: float = 0.0) -> Tokenizer:
    if kind == "word":
        return WordTokenizer()
    if kind == "char":
        return CharTokenizer()
    if kind in ("spm", "sentencepiece"):
        return SentencePieceTokenizer(model_path, bpe_dropout)
    raise ValueError(f"unknown tokenizer {kind}")


def is_word_end(piece_stream: List[str], next_piece: Optional[str]) -> bool:
    """Word-boundary check for safe partial emission in streaming agents
    (rain/simul/waitk_agent.py:21-46 ``WordEndChecker``): a word is complete
    when the *next* piece starts a new word ('▁' prefix) or the stream ends.
    """
    if next_piece is None:
        return True
    return next_piece.startswith("▁")
