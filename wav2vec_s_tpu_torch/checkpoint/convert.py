"""JAX ``W2V2CaatModel`` parameter tree -> the port's state dict.

Follows ``wav2vec_s_tpu/checkpoint/torch_export.export_caat_params``
exactly (the port must not import the JAX package, so the mapping is
repeated here), producing rain ``w2v2_caat`` names:

- dense ``kernel [in, out]``       -> ``weight [out, in]``
- conv ``kernel [k, in, out]``     -> ``weight [out, in, k]``
- norm ``scale`` / ``bias``        -> ``weight`` / ``bias``

The tree is given as nested dicts of numpy arrays (``jax.device_get`` of
the flax params); the result is a dict of float32 CPU tensors that
``W2V2CaatModel.load_state_dict(..., strict=True)`` accepts.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(out, prefix, p):
    out[prefix + ".weight"] = _a(p["kernel"]).T
    if "bias" in p:
        out[prefix + ".bias"] = _a(p["bias"])


def _norm(out, prefix, p):
    out[prefix + ".weight"] = _a(p["scale"])
    out[prefix + ".bias"] = _a(p["bias"])


def _layer(out, base, p, attn="self_attn", norm="self_attn_layer_norm"):
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(out, f"{base}.{attn}.{proj}", p[attn][proj])
    _norm(out, f"{base}.{norm}", p[norm])
    _linear(out, base + ".fc1", p["fc1"])
    _linear(out, base + ".fc2", p["fc2"])
    _norm(out, base + ".final_layer_norm", p["final_layer_norm"])


def _wav2vec2(out, p, prefix):
    fe = p["feature_extractor"]
    i = 0
    while f"conv_{i}" in fe:
        base = f"{prefix}feature_extractor.conv_layers.{i}"
        conv = fe[f"conv_{i}"]
        out[base + ".0.weight"] = np.transpose(_a(conv["kernel"]), (2, 1, 0))
        if "bias" in conv:
            out[base + ".0.bias"] = _a(conv["bias"])
        if f"ln_{i}" in fe:
            _norm(out, base + ".2.1", fe[f"ln_{i}"])
        i += 1
    _norm(out, prefix + "layer_norm", p["layer_norm"])
    if "post_extract_proj" in p:
        _linear(out, prefix + "post_extract_proj", p["post_extract_proj"])
    if "mask_emb" in p:
        out[prefix + "mask_emb"] = _a(p["mask_emb"])
    enc = p["encoder"]
    _norm(out, prefix + "encoder.layer_norm", enc["layer_norm"])
    for name, layer in enc["layers"].items():
        _layer(out, f"{prefix}encoder.layers.{int(name.split('_')[1])}", layer)


def caat_state_dict_from_jax(params: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    out: Dict[str, np.ndarray] = {}
    _wav2vec2(out, params["encoder"], "encoder.w2v2_model.")
    if "encoder_proj" in params:
        _linear(out, "encoder.encoder_proj", params["encoder_proj"])
    out["decoder.lm.embed_tokens.weight"] = _a(params["embed_tokens"])
    lm = params["decoder_lm"]
    for name, layer in lm.items():
        if name != "layer_norm":
            _layer(out, f"decoder.lm.layers.{int(name.split('_')[1])}", layer)
    if "layer_norm" in lm:
        _norm(out, "decoder.lm.layer_norm", lm["layer_norm"])
    for name, layer in params["jointer"].items():
        _layer(out, f"decoder.jointer.layers.{int(name.split('_')[1])}",
               layer, attn="enc_attn", norm="attn_layer_norm")
    # tied to embed_tokens unless the model has its own out_proj
    out["decoder.transducer_out.output_proj.weight"] = (
        _a(params["out_proj"]["kernel"]).T if "out_proj" in params
        else out["decoder.lm.embed_tokens.weight"])
    out["decoder.lm.version"] = np.asarray([3.0], np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}
