"""The offline-ASR heads on a device against the same on the CPU, at tiny
widths: the CTC and seq2seq recipes' loss and every gradient (dense or
flash attention; CTC also on a batch with a row whose labels cannot fit
its frames), the three batched greedy decoders and the seq2seq beam
generator.  ``chip_smoke.py`` (phase 17a) and the card tests
(``tests/test_torch_port_gpu.py``) run them on ``cuda``.

float32, every dropout off and the same seeded weights and inputs on both
devices, so the two compute one function.  ``F.ctc_loss``'s backward is
not deterministic on the card (atomics): gradients are held within
``GRAD_TOL``, not bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.eval import generator
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.models.asr import Wav2Vec2Seq2Seq, Wav2VecCtc
from wav2vec_s_tpu_torch.models.caat import CaatConfig, W2V2CaatModel
from wav2vec_s_tpu_torch.models.modules import random_init_
from wav2vec_s_tpu_torch.train.recipes import (
    make_ctc_loss_fn, make_s2s_loss_fn)

W2V = Wav2Vec2Config(
    conv_feature_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)),
    encoder_layers=2, encoder_embed_dim=24, encoder_ffn_embed_dim=48,
    encoder_attention_heads=4, main_context=4, right_context=2,
    dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
    encoder_layerdrop=0.0)
CAAT = CaatConfig(
    vocab_size=30, decoder_layers=2, decoder_embed_dim=24,
    decoder_ffn_embed_dim=48, decoder_attention_heads=4, jointer_layers=2,
    jointer_embed_dim=24, jointer_ffn_embed_dim=48,
    jointer_attention_heads=4, dropout=0.0, attention_dropout=0.0,
    activation_dropout=0.0)
#: loss: |diff| <= LOSS_RTOL |loss_cpu|; every gradient: |diff| <= rtol
#: |g_cpu| + atol max |g_cpu| over all parameters
LOSS_RTOL = 1e-5
GRAD_TOL = (1e-4, 1e-5)
#: the infeasible row's loss: optax's floor (1e5) plus its best path
FLOOR = (1e5, 4e5)


def model(kind: str, impl: str, dev) -> torch.nn.Module:
    """The tiny CTC (``"ctc"``), seq2seq (``"s2s"``) or CAAT
    (``"transducer"``) model, weights from seed 0, on ``dev``."""
    import dataclasses

    w2v = dataclasses.replace(W2V, attention_impl=impl)
    made = {"ctc": lambda: Wav2VecCtc(w2v, CAAT.vocab_size),
            "s2s": lambda: Wav2Vec2Seq2Seq(w2v, CAAT),
            "transducer": lambda: W2V2CaatModel(w2v, CAAT)}[kind]()
    return random_init_(made, torch.Generator().manual_seed(0)).to(dev)


def batch(infeasible: bool = False) -> Dict[str, torch.Tensor]:
    """3 rows of 2400 samples (row 2 padded from 1800), 6 targets ending in
    eos (row 1 three shorter); ``infeasible``: row 0's source padded from
    sample 120 (6 frames) under five equal labels, which need 9."""
    g = torch.Generator().manual_seed(0)
    src = torch.randn((3, 2400), generator=g) * 0.3
    tgt = torch.randint(4, CAAT.vocab_size, (3, 6), generator=g)
    tgt[:, -1] = CAAT.eos
    tgt[1, 3:] = CAAT.pad
    tgt[1, 2] = CAAT.eos
    pad = torch.zeros((3, 2400), dtype=torch.bool)
    pad[2, 1800:] = True
    if infeasible:
        pad[0, 120:] = True
        tgt[0, :5] = 7
    return {"source": src, "targets": tgt, "padding_mask": pad}


def vocab() -> Dictionary:
    v = Dictionary()
    for i in range(CAAT.vocab_size - v.nspecial):
        v.add_symbol(f"w{i}")
    return v


def loss_and_grads(kind: str, impl: str, infeasible: bool, dev
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, {parameter: gradient on the host}) of the ``kind`` recipe
    (``"ctc"`` or ``"s2s"``) on ``batch(infeasible)``."""
    m = model(kind, impl, dev)
    fn = (make_ctc_loss_fn(m, CAAT.pad, CAAT.eos, blank=CAAT.bos)
          if kind == "ctc" else make_s2s_loss_fn(m, CAAT))
    b = {k: v.to(dev) for k, v in batch(infeasible).items()}
    loss, _, _ = fn(b, torch.Generator().manual_seed(0), 0)
    loss.backward()
    return loss.item(), {k: p.grad.cpu() for k, p in m.named_parameters()
                         if p.grad is not None}


def gap(cpu, other) -> Tuple[float, float]:
    """(relative loss difference, the worst gradient difference over its
    bound ``GRAD_TOL``) of two ``loss_and_grads`` results; the gradients
    must be finite and of the same parameters."""
    (lc, gc), (lo, go) = cpu, other
    assert gc.keys() == go.keys()
    assert all(torch.isfinite(v).all() for v in go.values())
    rtol, atol = GRAD_TOL
    scale = max(v.abs().max().item() for v in gc.values())
    worst = max(((go[k] - v).abs() / (rtol * v.abs() + atol * scale))
                .max().item() for k, v in gc.items())
    return abs(lc - lo) / abs(lc), worst


def greedy(kind: str, dev):
    """(prefixes, lens) of the ``kind`` batched greedy decoder (flash
    encode) on ``batch()``."""
    m = model(kind, "flash", dev)
    make = {"ctc": generator.make_ctc_greedy_decoder,
            "s2s": generator.make_s2s_greedy_decoder,
            "transducer": generator.make_offline_greedy_decoder}[kind]
    kw = {} if kind == "ctc" else {"max_len": 16}
    b = batch()
    return make(m, vocab(), 4, 2, **kw)(b["source"], b["padding_mask"])


def beam(dev):
    """``Seq2SeqBeamGenerator`` (beam 4, flash encode) on row 0 of
    ``batch()`` -> its hypotheses."""
    return generator.Seq2SeqBeamGenerator(
        model("s2s", "flash", dev), vocab(), beam_size=4,
        max_len_b=10).generate(batch()["source"][:1].numpy())
