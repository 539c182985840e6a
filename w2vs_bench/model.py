"""Weights from the seed, and the program's model built from a config file.

The weights are the benchmark's own: one bfloat16 normal draw on the device
from a ``torch.Generator`` seeded with the run's seed, cut into the tensors
of ``reference.param_spec`` and scaled by their initialiser.  The program
gets a copy (``load_state_dict``); the reference draws them again after the
window, so it takes nothing the program holds.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict

import torch

SEED_MASK = (1 << 63) - 1


def reference_module(cfg: dict):
    return importlib.import_module(f"w2vs_bench.reference.{cfg['reference']}")


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> bfloat16 tensor on ``device``, drawn from ``seed``."""
    spec = reference_module(cfg).param_spec(cfg["w2v"], cfg["caat"])
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed & SEED_MASK)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.bfloat16)
    out, at = {}, 0
    for name, shape, kind, std in spec:
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if kind == "normal":
            out[name] = z * std
        elif kind == "one":
            out[name] = 1.0 + z * std
        elif kind == "zero":
            out[name] = torch.zeros_like(z)
        else:
            out[name] = torch.full_like(z, std)
    return out


def build_program_model(cfg: dict, seed: int, device, overrides=None):
    """``W2V2CaatModel`` on ``device`` holding the seed's weights, and the
    program's (Wav2Vec2Config, CaatConfig) of the config file, with
    ``overrides`` (program options such as ``attention_impl``)."""
    from wav2vec_s_tpu_torch.models import wav2vec_s_base_config
    from wav2vec_s_tpu_torch.models.caat import (
        W2V2CaatModel, caat_base_config)

    w2v = dict(cfg["w2v"], **(overrides or {}))
    w2v["conv_feature_layers"] = tuple(map(tuple, w2v["conv_feature_layers"]))
    w2v, caat = wav2vec_s_base_config(**w2v), caat_base_config(**cfg["caat"])
    with torch.device("meta"):
        model = W2V2CaatModel(w2v, caat)
    model = model.to_empty(device=device)
    weights = make_weights(cfg, seed, device)
    weights["decoder.transducer_out.output_proj.weight"] = weights[
        "decoder.lm.embed_tokens.weight"]
    model.load_state_dict(weights, strict=True)
    model.eval()
    return model, w2v, caat


def make_vocab(vocab_size: int):
    """The program's ``Dictionary`` with ``vocab_size`` entries: the four
    fairseq specials and the words ``w0``, ``w1``, ...  Only the blank is
    marked special, so every id the jointer can emit (pad is masked)
    shows in the served text: ``</s>`` and ``<unk>`` included."""
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary

    vocab = Dictionary()
    for i in range(vocab_size - vocab.nspecial):
        vocab.add_symbol(f"▁w{i}")
    vocab.nspecial = 1
    return vocab


def text_ids(text: str, vocab) -> list:
    """The ids of a served text (inverse of the decoders' assembly)."""
    import re

    out = []
    for tok in re.findall(r"w\d+|</s>|<unk>|<pad>|<s>", text):
        out.append(vocab.index("▁" + tok if tok[0] == "w" else tok))
    return out
