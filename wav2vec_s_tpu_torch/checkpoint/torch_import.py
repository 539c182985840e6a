"""Import fairseq / rain ``.pt`` checkpoints into the port's models (port of
``wav2vec_s_tpu/checkpoint/torch_import.py``).

The published wav2vec-S checkpoints are fairseq ``torch.save`` dicts
(``{args/cfg, model, optimizer_history, extra_state, ...}``,
fairseq/fairseq/trainer.py:345-379).  The port's modules already carry the
fairseq / rain parameter names (``Wav2Vec2Model``, ``W2V2CaatModel``), so
import is key handling and a strict load, no layout change:

- strip a leading path (``encoder.w2v2_model.`` for rain's
  OnlineW2V2TransformerEncoder, ``w2v_encoder.w2v_model.`` for fairseq's
  fine-tuned heads);
- drop what the model has no place for: ``encoder.pos_conv.*`` in a
  blockwise model (it adds sinusoidal positions), the quantizer and the
  two projections in a model without pre-training heads (the CAAT
  encoder), the conv-extractor norms the model's mode does not hold (in
  ``layer_norm`` mode those of blocks at or past ``layer_norm_num``, the
  fork's quirk, wav2vec2.py:317; in ``default`` mode all but block 0's
  group norm), fairseq's ``_float_tensor`` position buffers;
- fold a full-context model's weight-normed conv positions
  (``encoder.pos_conv.0.weight_g`` / ``weight_v``) into the one plain
  weight that the port trains (``fold_weight_norm``);
- ``mask_emb`` is optional (as in the JAX import): a checkpoint without it
  leaves the model's own;
- any other missing or unknown key, or a shape that differs, raises
  (``assert_shapes_match`` says which) before a tensor is copied.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

#: module prefixes of the pre-training heads (quantizer, projections)
HEADS = ("quantizer.", "project_q.", "final_proj.")
_CONV_NORM = re.compile(r"feature_extractor\.conv_layers\.\d+\.2\.")
_W2V2 = "encoder.w2v2_model."
#: the conv positions of a full-context model (fairseq's weight norm)
POS_CONV = "encoder.pos_conv.0."


def load_torch_checkpoint(path) -> Dict[str, Any]:
    """The raw dict of a fairseq checkpoint, tensors on the CPU.  fairseq
    pickles its ``args`` namespace, so this is a full unpickle
    (``weights_only=False``, as the JAX package loads it): read only files
    you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _float(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to("cpu", torch.float32)


def weight_norm_of(w: np.ndarray) -> np.ndarray:
    """[1, 1, k] norm over dims (0, 1) of a [out, in / groups, k] conv
    weight (``nn.utils.weight_norm(..., dim=2)``, wav2vec2.py:802), summed
    over the [k, in / groups, out] layout in which the JAX package holds
    the kernel, as its export sums it: a norm that an export wrote and the
    one an import computes of the same values agree bit for bit."""
    kernel = np.ascontiguousarray(np.transpose(w, (2, 1, 0)))
    return np.sqrt((np.transpose(kernel, (2, 1, 0)) ** 2).sum(
        axis=(0, 1), keepdims=True))


def fold_weight_norm(g, v) -> torch.Tensor:
    """The plain conv weight ``g * v / ||v||`` of a weight-normed one (JAX
    ``_weight_normed_conv1d``), computed as ``v * (g / ||v||)``: for a pair
    that ``split_weight_norm`` wrote (``g == ||v||`` to the bit) that is
    ``v`` itself, so import after export returns the weight exactly (the
    JAX order rounds twice and does not).  On any other pair the two
    differ by about one ulp."""
    g = _float(g).numpy()
    v = _float(v).numpy()
    return torch.from_numpy(v * (g / np.maximum(weight_norm_of(v), 1e-12)))


def wav2vec2_state_dict(state_dict: Dict[str, Any], model: nn.Module,
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """A fairseq Wav2Vec2 / wav2vec-S ``model`` state dict -> the state
    dict that ``model`` (a port ``Wav2Vec2Model``) loads: keys under
    ``prefix`` with it stripped, float32, what the model has no place for
    dropped, a missing ``mask_emb`` taken from the model."""
    own = model.state_dict()
    full = model.encoder_type == "full"
    out: Dict[str, torch.Tensor] = {}
    for k, v in state_dict.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if (k.endswith("._float_tensor")
                or (k.startswith("encoder.pos_conv.") and not full)
                or (not model.pretraining and k.startswith(HEADS))
                or (_CONV_NORM.match(k) and k not in own)):
            continue
        out[k] = _float(v)
    if full and POS_CONV + "weight_g" in out:
        out[POS_CONV + "weight"] = fold_weight_norm(
            out.pop(POS_CONV + "weight_g"), out.pop(POS_CONV + "weight_v"))
    out.setdefault("mask_emb", model.mask_emb.detach().to("cpu").clone())
    return out


def caat_state_dict(state_dict: Dict[str, Any], model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """A rain ``w2v2_caat`` state dict -> the state dict that ``model`` (a
    port ``W2V2CaatModel``) loads: the ``encoder.w2v2_model.*`` entries by
    the rules of ``wav2vec2_state_dict``, the rest as it is (float32).  With
    a shared embedding the output projection is the embedding, as the JAX
    import reads it."""
    out = {_W2V2 + k: v for k, v in wav2vec2_state_dict(
        state_dict, model.encoder.w2v2_model, _W2V2).items()}
    for k, v in state_dict.items():
        if not k.startswith(_W2V2) and not k.endswith("._float_tensor"):
            out[k] = _float(v)
    embed = "decoder.lm.embed_tokens.weight"
    if model.cfg.share_input_output_embed and embed in out:
        out["decoder.transducer_out.output_proj.weight"] = out[embed]
    return out


def assert_shapes_match(state_dict: Dict[str, torch.Tensor],
                        model: nn.Module) -> None:
    """Raise ``ValueError`` naming the missing and unknown keys and the
    first shape that differs from ``model``'s own state dict (the JAX
    ``assert_tree_shapes_match``)."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state_dict))
    extra = sorted(set(state_dict) - set(own))
    if missing or extra:
        raise ValueError(f"checkpoint keys do not match the model: missing "
                         f"{missing}, unknown {extra}")
    for k, v in own.items():
        if tuple(state_dict[k].shape) != tuple(v.shape):
            raise ValueError(f"at {k}: shape {tuple(state_dict[k].shape)} "
                             f"!= expected {tuple(v.shape)}")


def _load(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    assert_shapes_match(sd, model)
    own = model.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(v)


def load_wav2vec2_(model: nn.Module, state_dict: Dict[str, Any],
                   prefix: str = "") -> nn.Module:
    """Load a fairseq wav2vec2 / wav2vec-S state dict into the port's
    ``Wav2Vec2Model`` in place; returns it."""
    _load(model, wav2vec2_state_dict(state_dict, model, prefix))
    return model


def load_caat_(model: nn.Module, state_dict: Dict[str, Any]) -> nn.Module:
    """Load a rain ``w2v2_caat`` state dict into the port's
    ``W2V2CaatModel`` in place; returns it."""
    _load(model, caat_state_dict(state_dict, model))
    return model

