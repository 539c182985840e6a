"""Scoring (WER, BLEU) and the evaluation entry point ``eval.cli``."""

from wav2vec_s_tpu_torch.eval.bleu import corpus_bleu
from wav2vec_s_tpu_torch.eval.wer import corpus_wer, wer

__all__ = ["corpus_bleu", "corpus_wer", "wer"]
