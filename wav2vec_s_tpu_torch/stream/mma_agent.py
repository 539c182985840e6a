"""Streaming READ/WRITE agent for the MMA baseline (torch port of
``wav2vec_s_tpu/stream/mma_agent.py``).

Twin of ``MMAAgent`` / ``MMASearcher`` (rain/simul/mma_agent.py): READ until
``main_context + right_context`` frames of audio have arrived, then on every
policy step (``main_context`` more frames, or the end) re-encode the
revealed prefix (``StreamingEngine.encode_prefix``) and run the monotonic
decoder over it; emit greedy tokens while the hard monotonic heads can stop
within the revealed source, and READ when a head is stuck
(``outputs.action`` in the reference).  eos is banned while the stream is
open (mma_agent.py:63-66, unless ``stop_early``); words are released
through the transducer agents' word-boundary gate (``lcp_emit``).

Each emission recomputes the decoder at the JAX agent's bucketed shapes
(the token prefix padded to ``token_buckets``, the frames to the
encoder's frames of ``audio_buckets``): the padding changes the rounding,
so the port keeps it and with it the emitted words.  Drop-in for
``SimulEvaluator`` (``push`` / ``pop_word`` / ``finished``).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from wav2vec_s_tpu_torch.data.batching import bucket_for
from wav2vec_s_tpu_torch.models.feature_extractor import (
    conv_output_length, conv_receptive_stride)
from wav2vec_s_tpu_torch.stream.engine import StreamingEngine
from wav2vec_s_tpu_torch.stream.searcher import lcp_emit, spm_style_vocab


class MMAStreamingAgent:
    def __init__(self, model, vocab, tokenizer=None,
                 main_context: int = 16, right_context: int = 8,
                 step_read_blocks: int = 1, eager: bool = False,
                 stop_early: bool = False, max_len: int = 100,
                 max_emit_per_step: int = 20, audio_buckets=None,
                 token_buckets=(8, 16, 32, 64, 128)):
        self.model = model
        self.vocab = vocab
        self.tokenizer = tokenizer
        self.mc, self.rc = main_context, right_context
        self.step_read_blocks = step_read_blocks
        self.eager = eager
        self.stop_early = stop_early
        self.max_len = max_len
        self.max_emit = max_emit_per_step
        self._spm_style = spm_style_vocab(vocab)
        self.token_buckets = list(token_buckets)
        self.conv_layers = model.w2v_cfg.conv_feature_layers
        _, self.hop = conv_receptive_stride(self.conv_layers)
        self.engine = StreamingEngine(model, main_context, right_context,
                                      audio_buckets=audio_buckets,
                                      token_buckets=token_buckets)
        self.device = self.engine.device
        self.reset()

    def reset(self):
        self.samples = np.zeros(0, np.float32)
        self.tokens = [self.vocab.eos()]   # fairseq decoding starts at eos
        self.out_pos = 1
        self.processed_frames = 0
        self.hypo_queue: deque = deque()
        self.finished = False
        self._decode_done = False

    @property
    def init_frames(self):
        return self.mc + self.rc

    @property
    def step_frames(self):
        return self.mc

    def push(self, samples: np.ndarray, is_end: bool):
        self.samples = np.concatenate(
            [self.samples, np.asarray(samples, np.float32)])
        current_frames = len(self.samples) // self.hop
        if self.processed_frames == 0:
            fire = current_frames >= self.init_frames
        else:
            step = self.step_frames * self.step_read_blocks
            fire = (current_frames - self.processed_frames) >= step
        if (is_end or fire) and not self._decode_done:
            self._infer(is_end)
            self.processed_frames = current_frames
        if is_end:
            self.finished = True

    def _score(self, enc: np.ndarray, visible: int, is_end: bool):
        """(float32 logits [V] at the last position, need_more) of the hard
        monotonic decoder over ``enc`` [T, D] with ``visible`` frames."""
        U = len(self.tokens)
        U_pad = bucket_for(U, self.token_buckets)
        prev = np.full((1, U_pad), self.model.cfg.pad, np.int64)
        prev[0, :U] = self.tokens
        T = enc.shape[0]
        S = bucket_for(max(T, 1),
                       [conv_output_length(b, self.conv_layers)
                        for b in self.engine.audio_buckets])
        enc_buf = np.zeros((1, S, enc.shape[1]), np.float32)
        enc_buf[0, :T] = enc
        pad = np.ones((1, S), bool)
        pad[0, :T] = False
        dev = self.device
        logits, need_more = self.model.hard_decode_step(
            torch.from_numpy(prev).to(dev), torch.tensor([U], device=dev),
            torch.from_numpy(enc_buf).to(dev, self.model.w2v_cfg
                                         .compute_dtype),
            torch.from_numpy(pad).to(dev), torch.tensor([visible],
                                                        device=dev),
            torch.tensor([is_end], device=dev))
        return logits[0].cpu().numpy(), bool(need_more[0])

    @torch.no_grad()
    def _infer(self, is_end: bool):
        enc, t_eff = self.engine.encode_prefix(self.samples, is_end)
        if t_eff <= 0:
            return
        eos = self.vocab.eos()
        for _ in range(self.max_emit):
            logits, need_more = self._score(enc, t_eff, is_end)
            if need_more and not is_end:
                break                                  # READ
            if not self.stop_early and not is_end:
                logits[eos] = -1e10                    # mma_agent.py:63-66
            logits[self.vocab.pad()] = -1e10
            tok = int(logits.argmax())
            self.tokens.append(tok)
            if tok == eos or len(self.tokens) - 1 >= self.max_len:
                self._decode_done = True
                break

        toks = [t for t in self.tokens[1:] if t != eos]   # drop lead eos
        row = np.asarray([[eos] + toks], np.int64)
        words, self.out_pos = lcp_emit(
            self.vocab, self.tokenizer, self._spm_style, self.eager, row,
            self.out_pos, is_end or self._decode_done)
        self.hypo_queue.extend(words)

    def pop_word(self) -> Optional[str]:
        return self.hypo_queue.popleft() if self.hypo_queue else None
