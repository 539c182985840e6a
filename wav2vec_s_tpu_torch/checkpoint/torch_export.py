"""Export the port's models as fairseq / rain ``.pt`` checkpoints (port of
``wav2vec_s_tpu/checkpoint/torch_export.py``).

The inverse of ``torch_import``: a model trained with the port is handed
back to the reference stack (fairseq ``Wav2Vec2Model`` / wav2vec-S, rain's
``w2v2_caat``) for its own evaluation.  The port's state dicts already
carry the reference names, so export is a float32 CPU copy, an optional
key prefix and the ``torch.save`` dict that fairseq's trainer writes
(trainer.py:345-379, minus the optimizer history).  A full-context
model's folded conv-position weight is split back into fairseq's weight
norm, ``v = w`` and ``g = ||w||`` (JAX ``_weight_normed_conv1d``), so that
the export equals the JAX package's export of the same model key for key
and value for value.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn

from wav2vec_s_tpu_torch.checkpoint.torch_import import (
    POS_CONV, weight_norm_of)

StateDict = Mapping[str, torch.Tensor]


def _cpu_float(src: Union[nn.Module, StateDict]) -> Dict[str, torch.Tensor]:
    sd = src.state_dict() if isinstance(src, nn.Module) else src
    out = {}
    for k, v in sd.items():
        v = v.detach().to("cpu", torch.float32).clone()
        if k.endswith(POS_CONV + "weight"):
            base = k[:-len("weight")]
            g, w = split_weight_norm(v)
            out[base + "weight_g"], out[base + "weight_v"] = g, w
        else:
            out[k] = v
    return out


def split_weight_norm(w: torch.Tensor):
    """(weight_g [1, 1, k], weight_v) of a plain [out, in / groups, k]
    conv weight: ``g = ||w||`` over dims (0, 1), ``v = w``."""
    return torch.from_numpy(weight_norm_of(w.numpy())), w


def export_wav2vec2_state_dict(src: Union[nn.Module, StateDict],
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """A port ``Wav2Vec2Model`` (or its state dict) -> the fairseq
    ``model`` state dict; ``prefix`` prepends a path (e.g.
    ``"encoder.w2v2_model."`` for the rain fine-tuned-encoder naming)."""
    return {prefix + k: v for k, v in _cpu_float(src).items()}


def export_caat_state_dict(src: Union[nn.Module, StateDict]
                           ) -> Dict[str, torch.Tensor]:
    """A port ``W2V2CaatModel`` (or its state dict) -> the rain
    ``w2v2_caat`` state dict: the output projection (tied to the embedding
    when shared) and the decoder's ``version`` buffer included, as the
    reference loads it."""
    return _cpu_float(src)


def save_fairseq_checkpoint(path, model_sd: StateDict,
                            cfg: Optional[Dict[str, Any]] = None) -> None:
    """Write a fairseq-loadable ``torch.save`` checkpoint: the dict shape
    of the JAX package's ``save_fairseq_checkpoint``."""
    torch.save({"args": None, "cfg": cfg or {},
                "model": {k: v.detach().to("cpu").contiguous()
                          for k, v in model_sd.items()},
                "optimizer_history": [], "extra_state": {},
                "last_optimizer_state": None}, path)
