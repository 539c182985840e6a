"""The fbank and text CAAT families on a device against the same on the
CPU, at tiny widths: the CAAT recipe's loss and every gradient for each
fbank front-end x jointer and for the text model (with the recipe's
dropouts on: K4 draws the same masks on both devices), and the fbank
agent's texts and delays through ``SimulEvaluator``.  ``chip_smoke.py``
(phase 18a) and the card tests (``tests/test_torch_port_gpu.py``) run them
on ``cuda``; the caller turns TF32 off (cuDNN convs default to it).

float32, the same seeded weights, inputs and step generator on both
devices, so the two compute one function.  Tolerances: ``asr_parity``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from wav2vec_s_tpu_torch.models.fbank import (
    CONV_FRONTENDS, JOINTERS, FbankCaatModel)
from wav2vec_s_tpu_torch.models.modules import random_init_
from wav2vec_s_tpu_torch.models.text_caat import TextCaatModel
from wav2vec_s_tpu_torch.tools.asr_parity import (
    CAAT, GRAD_TOL, LOSS_RTOL, W2V, gap, vocab)
from wav2vec_s_tpu_torch.train.recipes import make_caat_loss_fn

__all__ = ["CASES", "GRAD_TOL", "LOSS_RTOL", "agent", "dropout_sites",
           "gap", "loss_and_grads"]

#: the recipes' dropouts, a decision step that splits the 11 frames in 2
ENC = dataclasses.replace(W2V, dropout=0.1, attention_dropout=0.1,
                          activation_dropout=0.1)
DEC = dataclasses.replace(CAAT, dropout=0.1, attention_dropout=0.1,
                          activation_dropout=0.1, transducer_downsample=8,
                          step_mode="constant")
#: (family, frontend, jointer): every fbank pair, then text
CASES = ([("fbank", f, j) for f in CONV_FRONTENDS for j in JOINTERS]
         + [("text", None, None)])


def model(family: str, frontend, jointer, dev, enc=ENC, dec=DEC):
    made = (FbankCaatModel(enc, dataclasses.replace(
        dec, frontend=frontend, jointer_type=jointer)) if family == "fbank"
            else TextCaatModel(enc, dec))
    return random_init_(made, torch.Generator().manual_seed(0)).to(dev)


def batch(family: str) -> Dict[str, torch.Tensor]:
    """3 rows: 41 log-mel frames (row 2 padded from 32) or 19 source tokens
    (row 1 padded from 11, row 2 from 6); 5 targets ending in eos (row 1
    two shorter)."""
    g = torch.Generator().manual_seed(0)
    tgt = torch.randint(4, DEC.vocab_size, (3, 5), generator=g)
    tgt[:, -1] = DEC.eos
    tgt[1, 3:] = DEC.pad
    tgt[1, 2] = DEC.eos
    if family == "text":
        src = torch.randint(4, DEC.vocab_size, (3, 19), generator=g)
        src[1, 11:] = DEC.pad
        src[2, 6:] = DEC.pad
        return {"source": src, "targets": tgt}
    pad = torch.zeros((3, 41), dtype=torch.bool)
    pad[2, 32:] = True
    return {"source": torch.randn((3, 41, 80), generator=g),
            "padding_mask": pad, "targets": tgt}


def loss_and_grads(family: str, frontend, jointer, dev
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, {parameter: gradient on the host}) of one training forward
    and backward of the CAAT recipe, dropouts drawn from seed 0."""
    m = model(family, frontend, jointer, dev)
    b = {k: v.to(dev) for k, v in batch(family).items()}
    loss, _, _ = make_caat_loss_fn(m, DEC)(
        b, torch.Generator().manual_seed(0), 0)
    loss.backward()
    return loss.item(), {k: p.grad.cpu() for k, p in m.named_parameters()
                         if p.grad is not None}


def dropout_sites(family: str, frontend, jointer) -> set:
    """{(shape, rate)} of the dropout sites of one ``loss_and_grads``
    forward, recorded on the CPU (K4's shapes on this path)."""
    from unittest import mock

    from wav2vec_s_tpu_torch.tools.dropout_sites import recording_context
    from wav2vec_s_tpu_torch.train import recipes

    sites = set()
    with mock.patch.object(recipes, "DropoutContext",
                           recording_context(sites)):
        loss_and_grads(family, frontend, jointer, "cpu")
    return {(shape, rate) for shape, _, rate in sites}


def agent(dev) -> List[Tuple[str, List[float]]]:
    """(text, delays in ms) per clip of the shallow2d / MHA fbank agent
    (``FbankStreamingEngine`` under the host searcher, beam 2) on two
    seeded-noise clips of 0.56 and 0.875 s, the blank row scaled by 0.25
    so that it emits."""
    from wav2vec_s_tpu_torch.stream.agent import (
        AgentConfig, SimulEvaluator, SpeechTransducerAgent)
    from wav2vec_s_tpu_torch.stream.fbank_engine import FbankStreamingEngine
    from wav2vec_s_tpu_torch.stream.searcher import (
        StreamingTransducerSearcher)

    enc = dataclasses.replace(W2V, layer_norm_first=True)
    m = model("fbank", "shallow2d", "mha", "cpu", enc, DEC).eval()
    with torch.no_grad():
        m.decoder.lm.embed_tokens.weight[DEC.bos] *= 0.25
    m.to(dev)
    mc, rc = enc.main_context, enc.right_context
    engine = FbankStreamingEngine(m, mc, rc, feature_buckets=[32, 64, 128],
                                  token_buckets=[8, 16, 32])
    cfg = AgentConfig(main_context=mc, right_context=rc, frame_samples=640,
                      step_read_blocks=1, intra_beam=2, inter_beam=1,
                      decoder_step_read=4, eager=True, max_len_a=0.3,
                      max_len_b=-1.0, len_scale=0.7)
    ev = SimulEvaluator(lambda: SpeechTransducerAgent(
        StreamingTransducerSearcher(engine, vocab(), eager=True,
                                    len_scale=0.7), cfg),
        segment_size_ms=25)
    rng = np.random.default_rng(20)
    out = []
    for n in (9000, 14000):
        r = ev.run_instance(
            (rng.standard_normal(n) * 0.3).astype(np.float32), "w1 w2")
        out.append((r.hypo, list(r.delays_ms)))
    return out
