"""JAX parameter trees -> the port's state dicts.

``caat_state_dict_from_jax`` (a ``W2V2CaatModel``) and
``wav2vec2_state_dict_from_jax`` (the standalone pre-training
``Wav2Vec2Model``, quantizer and projections included) follow
``wav2vec_s_tpu/checkpoint/torch_export.export_caat_params`` /
``export_wav2vec2_params`` exactly (the port must not import the JAX
package, so the mapping is repeated here), producing rain ``w2v2_caat`` and
fairseq wav2vec2 names; ``ctc_state_dict_from_jax`` and
``s2s_state_dict_from_jax`` give the fairseq names of the offline-ASR
heads (``models/asr.py``), ``fbank_state_dict_from_jax`` and
``text_caat_state_dict_from_jax`` those of the fbank and text CAAT models
(``models/fbank.py``, ``models/text_caat.py``), and
``waitk_state_dict_from_jax`` / ``mma_state_dict_from_jax`` those of the
simultaneous baselines (``models/waitk.py``, ``models/mma.py``):

- dense ``kernel [in, out]``       -> ``weight [out, in]``
- conv ``kernel [k, in, out]``     -> ``weight [out, in, k]`` (the
  full-context encoder's conv positions stay folded: ``pos_conv.conv`` ->
  ``encoder.pos_conv.0.weight``)
- 2-D conv ``kernel [kh, kw, in, out]`` -> ``weight [out, in, kh, kw]``
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
        elif f"gn_{i}" in fe:
            _norm(out, base + ".2", fe[f"gn_{i}"])
        i += 1
    _norm(out, prefix + "layer_norm", p["layer_norm"])
    if "post_extract_proj" in p:
        _linear(out, prefix + "post_extract_proj", p["post_extract_proj"])
    if "mask_emb" in p:
        out[prefix + "mask_emb"] = _a(p["mask_emb"])
    enc = p["encoder"]
    if "pos_conv" in enc:
        # the full-context encoder's folded conv positions, [k, in/g, out]
        conv = enc["pos_conv"]["conv"]
        out[prefix + "encoder.pos_conv.0.weight"] = np.transpose(
            _a(conv["kernel"]), (2, 1, 0))
        out[prefix + "encoder.pos_conv.0.bias"] = _a(conv["bias"])
    _norm(out, prefix + "encoder.layer_norm", enc["layer_norm"])
    for name, layer in enc["layers"].items():
        _layer(out, f"{prefix}encoder.layers.{int(name.split('_')[1])}", layer)


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def wav2vec2_state_dict_from_jax(params: Dict[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """The JAX pre-training ``Wav2Vec2Model`` tree -> the state dict of
    ``Wav2Vec2Model(cfg, pretraining=True)``."""
    out: Dict[str, np.ndarray] = {}
    _wav2vec2(out, params, "")
    if "quantizer" in params:
        out["quantizer.vars"] = _a(params["quantizer"]["vars"])
        _linear(out, "quantizer.weight_proj",
                params["quantizer"]["weight_proj"])
    for name in ("project_q", "final_proj"):
        if name in params:
            _linear(out, name, params[name])
    return _tensors(out)


def caat_state_dict_from_jax(params: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    out: Dict[str, np.ndarray] = {}
    _wav2vec2(out, params["encoder"], "encoder.w2v2_model.")
    if "encoder_proj" in params:
        _linear(out, "encoder.encoder_proj", params["encoder_proj"])
    _caat_decoder(out, params)
    # tied to embed_tokens unless the model has its own out_proj
    out["decoder.transducer_out.output_proj.weight"] = (
        _a(params["out_proj"]["kernel"]).T if "out_proj" in params
        else out["decoder.lm.embed_tokens.weight"])
    return _tensors(out)


def _caat_decoder(out, params):
    """``decoder.lm.*`` (the embedding included) and ``decoder.jointer.*``
    of a JAX CAAT tree: the MHA jointer's layers, or a single-layer
    jointer's projections (the fbank family's ``concat`` / ``attention``)."""
    out["decoder.lm.embed_tokens.weight"] = _a(params["embed_tokens"])
    lm = params["decoder_lm"]
    for name, layer in lm.items():
        if name != "layer_norm":
            _layer(out, f"decoder.lm.layers.{int(name.split('_')[1])}", layer)
    if "layer_norm" in lm:
        _norm(out, "decoder.lm.layer_norm", lm["layer_norm"])
    for name, layer in params["jointer"].items():
        if name.startswith("layer_"):
            _layer(out, f"decoder.jointer.layers.{int(name.split('_')[1])}",
                   layer, attn="enc_attn", norm="attn_layer_norm")
        else:
            _linear(out, f"decoder.jointer.{name}", layer)
    out["decoder.lm.version"] = np.asarray([3.0], np.float32)


def _blockwise_encoder(out, enc):
    """``encoder.layers.{i}`` and ``encoder.layer_norm`` of the fbank and
    text encoders."""
    _norm(out, "encoder.layer_norm", enc["layer_norm"])
    for name, layer in enc["layers"].items():
        _layer(out, f"encoder.layers.{int(name.split('_')[1])}", layer)


def _frontend(out, prefix, p):
    """A conv front-end's tree, names kept: conv ``kernel [kh, kw, in,
    out]`` -> ``weight [out, in, kh, kw]``, dense ``kernel`` -> ``weight``
    transposed, GroupNorm ``scale`` -> ``weight``."""
    for name, v in p.items():
        if isinstance(v, dict):
            _frontend(out, f"{prefix}.{name}", v)
        elif name == "kernel":
            k = _a(v)
            out[prefix + ".weight"] = (np.transpose(k, (3, 2, 0, 1))
                                       if k.ndim == 4 else k.T)
        else:
            out[f"{prefix}.{'weight' if name == 'scale' else name}"] = _a(v)


def fbank_state_dict_from_jax(params: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX ``FbankCaatModel`` tree (any front-end and jointer) -> the
    state dict of the port's ``models/fbank.FbankCaatModel``."""
    out: Dict[str, np.ndarray] = {}
    _frontend(out, "encoder.subsample", params["encoder"]["subsample"])
    _blockwise_encoder(out, params["encoder"])
    _caat_decoder(out, params)
    return _tensors(out)


def text_caat_state_dict_from_jax(params: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX ``TextCaatModel`` tree -> the state dict of the port's
    ``models/text_caat.TextCaatModel``."""
    out: Dict[str, np.ndarray] = {
        "encoder.embed_tokens.weight": _a(params["encoder"]["embed_tokens"])}
    _blockwise_encoder(out, params["encoder"])
    _caat_decoder(out, params)
    return _tensors(out)


def ctc_state_dict_from_jax(params: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX ``Wav2VecCtc`` tree -> the state dict of the port's
    ``models/asr.Wav2VecCtc`` (fairseq names: ``w2v_encoder.w2v_model.*``,
    ``w2v_encoder.proj``)."""
    out: Dict[str, np.ndarray] = {}
    _wav2vec2(out, params["encoder"], "w2v_encoder.w2v_model.")
    _linear(out, "w2v_encoder.proj", params["proj"])
    return _tensors(out)


def s2s_state_dict_from_jax(params: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX ``Wav2Vec2Seq2Seq`` tree -> the state dict of the port's
    ``models/asr.Wav2Vec2Seq2Seq`` (``encoder.w2v2_model.*``, fairseq
    ``TransformerDecoder`` names under ``decoder.``)."""
    out: Dict[str, np.ndarray] = {}
    _wav2vec2(out, params["encoder"], "encoder.w2v2_model.")
    dec = params["decoder"]
    out["decoder.embed_tokens.weight"] = _a(dec["embed_tokens"])
    for name, layer in dec.items():
        if name.startswith("layer_") and name != "layer_norm":
            _decoder_layer(out, f"decoder.layers.{int(name.split('_')[1])}",
                           layer)
    if "layer_norm" in dec:
        _norm(out, "decoder.layer_norm", dec["layer_norm"])
    return _tensors(out)


def _decoder_layer(out, base, layer, mono=False):
    """A fairseq ``TransformerDecoderLayer``'s names; ``mono``: the MMA
    layer's encoder attention, which adds the monotonic heads."""
    _layer(out, base, layer)
    att = layer["encoder_attn"]
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj") + (
            ("mono_q_proj", "mono_k_proj") if mono else ()):
        _linear(out, f"{base}.encoder_attn.{proj}", att[proj])
    if mono:
        out[base + ".encoder_attn.energy_bias"] = _a(att["energy_bias"])
    _norm(out, base + ".encoder_attn_layer_norm",
          layer["encoder_attn_layer_norm"])


#: the JAX ``WaitkModel`` tree is the JAX seq2seq model's, and the port's
#: ``models/waitk.WaitkModel`` carries the seq2seq names
waitk_state_dict_from_jax = s2s_state_dict_from_jax


def mma_state_dict_from_jax(params: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX ``MMAModel`` tree -> the state dict of the port's
    ``models/mma.MMAModel``: ``embed_tokens`` -> ``decoder.embed_tokens``,
    ``layer_{i}`` -> ``decoder.layers.{i}`` (the monotonic heads under
    their JAX leaf names), ``final_ln`` -> ``decoder.layer_norm``."""
    out: Dict[str, np.ndarray] = {}
    _wav2vec2(out, params["encoder"], "encoder.w2v2_model.")
    out["decoder.embed_tokens.weight"] = _a(params["embed_tokens"])
    for name, layer in params.items():
        if name.startswith("layer_"):
            _decoder_layer(out, f"decoder.layers.{int(name.split('_')[1])}",
                           layer, mono=True)
    _norm(out, "decoder.layer_norm", params["final_ln"])
    return _tensors(out)
