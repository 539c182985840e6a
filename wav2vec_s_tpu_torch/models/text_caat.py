"""Text-source CAAT: simultaneous text translation with the attention
transducer (torch port of ``wav2vec_s_tpu/models/text_caat.py``).

Twin of ``caat_transformer`` with a text encoder
(rain/models/caat_transformer.py:104-133; the text side feeds the rain
text agents ``text_transducer_agent.py`` / ``text_waitk.py``): the
unidirectional text encoder runs the blockwise bounded-context layers with
(mc, rc) counted in token positions, under the dense block bias; the LM,
the MHA jointer, ``caat_loss`` and ``decode_step`` are the speech CAAT
models'.  Parameter names: ``encoder.embed_tokens``, ``encoder.layers.{i}``,
``encoder.layer_norm``, ``decoder.lm.*``, ``decoder.jointer.*``
(``checkpoint/convert.text_caat_state_dict_from_jax``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from wav2vec_s_tpu_torch.data.batching import bucket_for
from wav2vec_s_tpu_torch.models.caat.config import CaatConfig
from wav2vec_s_tpu_torch.models.caat.transducer_model import CaatModelBase
from wav2vec_s_tpu_torch.models.fbank import JointDecoder, dense_blockwise
from wav2vec_s_tpu_torch.models.modules import TransformerEncoderLayer
from wav2vec_s_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext


class TextBlockwiseEncoder(nn.Module):
    """Token embedding + sinusoidal positions + blockwise encoder stack
    (the unidirectional text encoder of ``caat_transformer``)."""

    def __init__(self, cfg: Wav2Vec2Config, vocab_size: int, pad: int = 1):
        super().__init__()
        self.cfg = cfg
        self.pad = pad
        D = cfg.encoder_embed_dim
        self.embed_tokens = nn.Embedding(vocab_size, D)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(D, cfg.encoder_ffn_embed_dim,
                                    cfg.encoder_attention_heads)
            for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(D)

    def forward(self, tokens: torch.Tensor,
                main_context: Optional[int] = None,
                right_context: Optional[int] = None,
                ctx: Optional[DropoutContext] = None):
        """tokens [B, S] -> ([B, S, D] in the compute dtype, [B, S] pad
        mask ``tokens == pad``; the pad rows are not zeroed)."""
        c = self.cfg
        # cast, then scale (the JAX order: in bfloat16 it rounds twice)
        x = (self.embed_tokens.weight.to(c.compute_dtype)[tokens]
             * c.encoder_embed_dim ** 0.5)
        pm = tokens == self.pad
        return dense_blockwise(self, x, pm, main_context, right_context,
                               ctx), pm


class TextCaatModel(CaatModelBase):
    """Text encoder + IsolatedDecoder LM + MHA jointer (arch
    ``caat_transformer`` on text); ``src_vocab_size`` 0 shares the target
    vocabulary's size.  ``padding_mask`` is ignored: the pad mask is the
    source's pad tokens."""

    def __init__(self, enc_cfg: Wav2Vec2Config, cfg: CaatConfig,
                 src_vocab_size: int = 0):
        super().__init__()
        self.enc_cfg = enc_cfg
        self.cfg = cfg
        self.encoder = TextBlockwiseEncoder(
            enc_cfg, src_vocab_size or cfg.vocab_size, cfg.pad)
        self.decoder = JointDecoder(cfg, enc_cfg.encoder_embed_dim, "mha")

    def _encode(self, source, padding_mask, main_context, right_context,
                ctx: Optional[DropoutContext] = None):
        return self.encoder(source, main_context, right_context, ctx)


class TextTransducerAgent:
    """Greedy simultaneous text-translation agent, twin of
    ``text_transducer_agent.py``: read one source token per policy step,
    emit while the transducer picks non-blank.

    push(token_id, is_end) / pop_token() / finished: a token-level
    interface (word gating belongs to the caller's detokenizer).  The
    source and the prefix are padded to ``src_buckets``, as the JAX agent
    pads them for its compiled shapes (the padding changes the rounding,
    so the port keeps it)."""

    def __init__(self, model: TextCaatModel, vocab, max_len: int = 100,
                 max_emit_per_step: int = 8,
                 src_buckets: Sequence[int] = (8, 16, 32, 64, 128)):
        self.model = model
        self.vocab = vocab
        self.max_len = max_len
        self.max_emit = max_emit_per_step
        self.src_buckets = list(src_buckets)
        self.device = model.token_embedding().device
        self.reset()

    def reset(self):
        self.src = []
        self.tokens = [self.vocab.bos()]
        self.queue = []
        self.finished = False

    def push(self, token_id: int, is_end: bool):
        self.src.append(int(token_id))
        self._infer(is_end)
        if is_end:
            self.finished = True

    def _tensor(self, ids, size: int) -> torch.Tensor:
        buf = np.full((1, size), self.vocab.pad(), np.int64)
        buf[0, :len(ids)] = ids
        return torch.from_numpy(buf).to(self.device)

    def _infer(self, is_end: bool):
        enc, _ = self.model.encode(self._tensor(
            self.src, bucket_for(len(self.src), self.src_buckets)))
        # reveal only the received source positions (rc look-ahead within
        # the revealed prefix is the blockwise mask's business)
        mask = torch.ones((1, enc.shape[1]), dtype=torch.bool,
                          device=self.device)
        mask[0, :len(self.src)] = False
        blank = self.vocab.bos()
        for _ in range(self.max_emit):
            if len(self.tokens) >= self.max_len:
                break
            prev = self._tensor(self.tokens, bucket_for(len(self.tokens),
                                                        self.src_buckets))
            lens = torch.tensor([len(self.tokens)], device=self.device)
            lp = self.model.decode_step(prev, lens, enc, mask)[0].cpu()
            lp[self.vocab.pad()] = float("-inf")
            if not is_end:
                lp[self.vocab.eos()] = float("-inf")
            tok = int(lp.argmax())
            if tok == blank and not is_end:
                break                                   # read
            if tok in (blank, self.vocab.eos()) and is_end:
                break
            self.tokens.append(tok)
            self.queue.append(tok)
            if len(self.tokens) >= self.max_len:
                break

    def pop_token(self):
        return self.queue.pop(0) if self.queue else None
