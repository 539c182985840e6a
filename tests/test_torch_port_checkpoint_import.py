"""fairseq ``.pt`` import and export in the torch port against the JAX
package, ``convert_cli`` and the ``.pt`` warm start.

- round trips, exact and key for key, both directions, for the
  pre-training wav2vec-S model and for CAAT: JAX params -> JAX
  ``export_*_params`` + ``save_fairseq_checkpoint`` -> the port's
  ``load_torch_checkpoint`` + import (its state dict equals
  ``checkpoint.convert``'s of the same params) -> the port's export and
  ``save_fairseq_checkpoint`` -> the JAX ``load_torch_checkpoint`` +
  ``import_*_params`` -> the JAX params again; the port's export equals the
  JAX export key for key;
- key handling: prefixes, what the blockwise model drops
  (``encoder.pos_conv.*``, conv norms past ``layer_norm_num``, the heads of
  a model without them), an optional ``mask_emb``, and the raises on an
  unknown key, a missing key and a wrong shape;
- ``python -m wav2vec_s_tpu_torch.checkpoint.convert_cli``: import to a
  checkpoint directory, export back, for w2v2 and caat, and again with
  ``--encoder-type full`` (a full-context w2v2 model; caat ignores it);
- ``warm_start.apply_pretrained_encoder`` from a ``.pt`` under each of the
  three prefixes the JAX package tries.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_checkpoint_import import fairseq_style_state_dict
from tests.test_torch_port_import import jax_caat, port_caat, port_cfg
from tests.test_torch_port_pretrain import jax_w2v
from wav2vec_s_tpu.checkpoint import torch_export as jax_export
from wav2vec_s_tpu.checkpoint import torch_import as jax_import
from wav2vec_s_tpu_torch.checkpoint import convert_cli, torch_export
from wav2vec_s_tpu_torch.checkpoint import torch_import
from wav2vec_s_tpu_torch.checkpoint.convert import (
    caat_state_dict_from_jax, wav2vec2_state_dict_from_jax)
from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager, load_params
from wav2vec_s_tpu_torch.checkpoint.warm_start import (
    TORCH_PREFIXES, apply_pretrained_encoder)
from wav2vec_s_tpu_torch.models import Wav2Vec2Config, Wav2Vec2Model
from wav2vec_s_tpu_torch.models.caat import CaatConfig, W2V2CaatModel

torch.set_num_threads(1)

W2V = dataclasses.replace(W2V_TINY, latent_vars=4, n_negatives=10)


def _trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def _dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)


def test_wav2vec2_round_trip_is_exact(tmp_path):
    _, params = jax_w2v()
    jax_sd = jax_export.export_wav2vec2_params(params)
    jax_export.save_fairseq_checkpoint(tmp_path / "jax.pt", jax_sd)
    model = Wav2Vec2Model(port_cfg(Wav2Vec2Config, W2V), pretraining=True)
    torch_import.load_wav2vec2_(model, torch_import.load_torch_checkpoint(
        tmp_path / "jax.pt")["model"])
    _dicts_equal(model.state_dict(), wav2vec2_state_dict_from_jax(params))
    out = torch_export.export_wav2vec2_state_dict(model)
    _dicts_equal(out, jax_sd)
    torch_export.save_fairseq_checkpoint(tmp_path / "port.pt", out)
    state = jax_import.load_torch_checkpoint(str(tmp_path / "port.pt"))
    assert sorted(state) == sorted(torch.load(tmp_path / "jax.pt",
                                              weights_only=False))
    _trees_equal(jax_import.import_wav2vec2_params(state["model"], W2V),
                 jax.device_get(params))


CAAT_CASES = {
    "default": CAAT_TINY,
    "untied_out_proj": dataclasses.replace(CAAT_TINY,
                                           share_input_output_embed=False),
    "encoder_proj": dataclasses.replace(CAAT_TINY, encoder_proj=True),
}


@pytest.mark.parametrize("case", sorted(CAAT_CASES))
def test_caat_round_trip_is_exact(tmp_path, case):
    caat = CAAT_CASES[case]
    _, params = jax_caat(W2V_TINY, caat)
    if not caat.share_input_output_embed:   # the JAX init builds none
        params = dict(params, out_proj={"kernel": np.random.default_rng(
            0).standard_normal((caat.decoder_embed_dim, caat.vocab_size)
                               ).astype(np.float32)})
    jax_sd = jax_export.export_caat_params(params)
    jax_export.save_fairseq_checkpoint(tmp_path / "jax.pt", jax_sd)
    model = W2V2CaatModel(port_cfg(Wav2Vec2Config, W2V_TINY),
                          port_cfg(CaatConfig, caat))
    torch_import.load_caat_(model, torch_import.load_torch_checkpoint(
        tmp_path / "jax.pt")["model"])
    _dicts_equal(model.state_dict(), caat_state_dict_from_jax(params))
    out = torch_export.export_caat_state_dict(model)
    _dicts_equal(out, jax_sd)
    torch_export.save_fairseq_checkpoint(tmp_path / "port.pt", out)
    state = jax_import.load_torch_checkpoint(str(tmp_path / "port.pt"))
    _trees_equal(jax_import.import_caat_params(state["model"], W2V_TINY,
                                               caat),
                 jax.device_get(params))


def test_key_handling_drops_what_the_model_has_no_place_for():
    cfg = dataclasses.replace(W2V_TINY, latent_vars=8, final_dim=16)
    full = fairseq_style_state_dict(cfg, encoder_type="full")
    # a conv norm in every block (fairseq's layer_norm mode) and a
    # position buffer: both dropped; mask_emb absent: the model's own
    for i in range(1, len(cfg.conv_feature_layers)):
        full[f"feature_extractor.conv_layers.{i}.2.1.weight"] = torch.ones(16)
        full[f"feature_extractor.conv_layers.{i}.2.1.bias"] = torch.ones(16)
    full["encoder.embed_positions._float_tensor"] = torch.zeros(1)
    mask_emb = full.pop("mask_emb")
    port = Wav2Vec2Model(port_cfg(Wav2Vec2Config, cfg), pretraining=True)
    own_mask = port.mask_emb.detach().clone()
    torch_import.load_wav2vec2_(port, full)
    assert torch.equal(port.mask_emb.detach(), own_mask)
    for k, v in port.state_dict().items():
        assert k == "mask_emb" or torch.equal(v, full[k].float()), k
    # the CAAT encoder has no heads: they are dropped too
    enc = Wav2Vec2Model(port_cfg(Wav2Vec2Config, cfg))
    prefixed = {"encoder.w2v2_model." + k: v for k, v in full.items()}
    prefixed["encoder.w2v2_model.mask_emb"] = mask_emb
    torch_import.load_wav2vec2_(enc, prefixed, "encoder.w2v2_model.")
    assert torch.equal(enc.mask_emb.detach(), mask_emb)
    assert not any(k.startswith(torch_import.HEADS)
                   for k in enc.state_dict())
    # what is neither dropped nor known raises, naming it
    with pytest.raises(ValueError, match="label_embs"):
        torch_import.load_wav2vec2_(port, dict(full, label_embs=torch.ones(2)))
    with pytest.raises(ValueError, match="final_proj.bias"):
        bad = dict(full)
        del bad["final_proj.bias"]
        torch_import.load_wav2vec2_(port, bad)
    with pytest.raises(ValueError, match="final_proj.weight"):
        torch_import.load_wav2vec2_(port, dict(
            full, **{"final_proj.weight": torch.ones(3, 3)}))


@pytest.mark.parametrize("model", ["w2v2", "caat"])
def test_convert_cli_imports_and_exports(tmp_path, model):
    if model == "w2v2":
        _, params = jax_w2v()
        jax_sd = jax_export.export_wav2vec2_params(params)
        want = wav2vec2_state_dict_from_jax(params)
        cfg_kw = [f"{k}={getattr(W2V, k)!r}".replace(" ", "") for k in (
            "conv_feature_layers", "encoder_layers", "encoder_embed_dim",
            "encoder_ffn_embed_dim", "encoder_attention_heads", "final_dim",
            "latent_vars")]
    else:
        _, params = jax_caat()
        jax_sd = jax_export.export_caat_params(params)
        want = caat_state_dict_from_jax(params)
        cfg_kw = [f"{k}={getattr(W2V_TINY, k)!r}".replace(" ", "") for k in (
            "conv_feature_layers", "encoder_layers", "encoder_embed_dim",
            "encoder_ffn_embed_dim", "encoder_attention_heads")] + [
            f"caat.{k}={getattr(CAAT_TINY, k)!r}" for k in (
                "decoder_layers", "decoder_embed_dim",
                "decoder_ffn_embed_dim", "decoder_attention_heads",
                "jointer_layers", "jointer_embed_dim",
                "jointer_ffn_embed_dim", "jointer_attention_heads")]
    jax_export.save_fairseq_checkpoint(tmp_path / "in.pt", jax_sd)
    convert_cli.main(["--pt", str(tmp_path / "in.pt"), "--out",
                      str(tmp_path / "ck"), "--model", model] + cfg_kw)
    payload, meta = CheckpointManager(tmp_path / "ck", keep_last=0).restore()
    assert payload["opt"] is None and meta["step"] == 0
    _dicts_equal(load_params(tmp_path / "ck"), want)
    convert_cli.main(["--export-from", str(tmp_path / "ck"), "--out",
                      str(tmp_path / "out.pt"), "--model", model])
    back = torch_import.load_torch_checkpoint(tmp_path / "out.pt")
    _dicts_equal(back["model"], jax_sd)
    # --encoder-type full: a w2v2 model on the full-context encoder (its
    # folded conv positions) goes round the same way; a CAAT import takes
    # the blockwise encoder whatever it says, as in JAX
    if model == "w2v2":
        from tests.test_torch_port_full_context import jax_full

        full = dataclasses.replace(W2V, conv_pos=16, conv_pos_groups=4)
        _, params = jax_full(full, "full")
        jax_sd = jax_export.export_wav2vec2_params(params)
        want = wav2vec2_state_dict_from_jax(params)
        jax_export.save_fairseq_checkpoint(tmp_path / "in.pt", jax_sd)
        cfg_kw += ["conv_pos=16", "conv_pos_groups=4"]
    convert_cli.main(["--pt", str(tmp_path / "in.pt"), "--out",
                      str(tmp_path / "full"), "--model", model,
                      "--encoder-type", "full"] + cfg_kw)
    _dicts_equal(load_params(tmp_path / "full"), want)
    convert_cli.main(["--export-from", str(tmp_path / "full"), "--out",
                      str(tmp_path / "full.pt"), "--model", model])
    back = torch_import.load_torch_checkpoint(tmp_path / "full.pt")
    _dicts_equal(back["model"], jax_sd)
    assert ("encoder.pos_conv.0.weight_g" in back["model"]) == (
        model == "w2v2")


@pytest.mark.parametrize("prefix", TORCH_PREFIXES)
def test_pretrained_encoder_from_a_pt_file(tmp_path, prefix):
    _, params = jax_w2v()
    # the pre-trained model under one of the three prefixes, beside a
    # decoder key that the warm start leaves alone
    sd = jax_export.export_wav2vec2_params(params, prefix=prefix)
    sd["decoder.lm.layers.0.fc1.weight"] = np.zeros((1,), np.float32)
    jax_export.save_fairseq_checkpoint(tmp_path / "enc.pt", sd)
    _, cparams = jax_caat()
    model = port_caat(cparams)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    apply_pretrained_encoder(model, tmp_path / "enc.pt")
    enc = wav2vec2_state_dict_from_jax(params)
    for k, v in model.state_dict().items():
        if k.startswith("encoder.w2v2_model."):
            assert torch.equal(v, enc[k[len("encoder.w2v2_model."):]]), k
        else:
            assert torch.equal(v, before[k]), k
    torch.save({"model": {"x": torch.ones(1)}}, tmp_path / "none.pt")
    with pytest.raises(ValueError, match="no wav2vec2 encoder weights"):
        apply_pretrained_encoder(model, tmp_path / "none.pt")
