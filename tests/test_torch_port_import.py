"""The torch port's package boundary and weight conversion.

- ``import wav2vec_s_tpu_torch`` (every module of it) leaves JAX and flax
  out of ``sys.modules``;
- ``checkpoint.convert.caat_state_dict_from_jax`` loads into the port's
  ``W2V2CaatModel`` with ``strict=True`` and agrees key for key, value for
  value, with the JAX package's ``torch_export.export_caat_params``;
- the host pieces the port copies (dictionary, sinusoidal table, conv
  geometry) equal their JAX-package originals.

Also the shared helpers of the ``test_torch_port_*`` files: a tiny JAX
CAAT model with seeded numpy weights and its port twin.
"""

import dataclasses
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY, _rngs
from wav2vec_s_tpu.checkpoint.torch_export import export_caat_params
from wav2vec_s_tpu.models.caat import W2V2CaatModel as JaxCaatModel
from wav2vec_s_tpu_torch.checkpoint.convert import caat_state_dict_from_jax
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.models.caat import CaatConfig, W2V2CaatModel

# The suite runs under several xdist workers, each with a JAX thread pool;
# a full torch intra-op pool per worker oversubscribes the cores, and the
# port's tiny ops then run ~20x slower than on one thread.
torch.set_num_threads(1)


def port_cfg(cls, jax_cfg):
    """The port's config with the JAX config's values for its fields."""
    return cls(**{f.name: getattr(jax_cfg, f.name)
                  for f in dataclasses.fields(cls)})


@functools.lru_cache(maxsize=None)
def jax_caat(w2v=W2V_TINY, caat=CAAT_TINY, seed=1):
    """(flax model, numpy params) with seeded numpy weights in the tree
    that the flax init would build (traced, not run): matrices normal with
    std fan_in ** -0.5, norm scales 1 + 0.2 noise, other vectors 0.2
    noise, so no parameter sits at a special value."""
    model = JaxCaatModel(w2v, caat)
    shapes = jax.eval_shape(lambda: model.init(
        _rngs(), jnp.zeros((1, 2400)), jnp.zeros((1, 5), jnp.int32),
        train=False))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:
            return n * float(np.prod(leaf.shape[:-1])) ** -0.5
        scale = getattr(path[-1], "key", None) == "scale"
        return (1.0 if scale else 0.0) + 0.2 * n

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def port_caat(params, w2v=W2V_TINY, caat=CAAT_TINY) -> W2V2CaatModel:
    model = W2V2CaatModel(port_cfg(Wav2Vec2Config, w2v),
                          port_cfg(CaatConfig, caat))
    model.load_state_dict(caat_state_dict_from_jax(params), strict=True)
    return model


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import wav2vec_s_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'wav2vec_s_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('wav2vec_s_tpu_torch.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert int(out.stdout) >= 15       # every port module was imported


CONVERT_CASES = {
    "default": (W2V_TINY, CAAT_TINY),
    "post_ln_decoder": (W2V_TINY, dataclasses.replace(
        CAAT_TINY, decoder_normalize_before=False)),
    "untied_out_proj": (W2V_TINY, dataclasses.replace(
        CAAT_TINY, share_input_output_embed=False)),
    "encoder_proj": (W2V_TINY, dataclasses.replace(
        CAAT_TINY, encoder_proj=True)),
}


@pytest.mark.parametrize("case", sorted(CONVERT_CASES))
def test_convert_matches_export_key_for_key(case):
    w2v, caat = CONVERT_CASES[case]
    _, params = jax_caat(w2v, caat)
    want = export_caat_params(params)
    model = port_caat(params, w2v, caat)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    tied = (model.decoder.transducer_out.output_proj.weight
            is model.decoder.lm.embed_tokens.weight)
    assert tied == caat.share_input_output_embed


def test_dictionary_copy_matches():
    from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary

    a, b = JaxDictionary(), Dictionary()
    for w in ("▁the", "cat", "▁sat", "cat"):
        assert a.add_symbol(w) == b.add_symbol(w)
    assert (a.bos(), a.pad(), a.eos(), a.unk(), a.nspecial) == (
        b.bos(), b.pad(), b.eos(), b.unk(), b.nspecial)
    assert a.symbols == b.symbols and a.count == b.count
    assert a.decode([0, 4, 5, 99]) == b.decode([0, 4, 5, 99])


@pytest.mark.parametrize("n,dim", [(10, 8), (37, 24), (1055, 768), (9, 7)])
def test_sinusoidal_table_copy_matches(n, dim):
    from wav2vec_s_tpu.utils.positional import sinusoidal_table as jax_table
    from wav2vec_s_tpu_torch.utils.positional import sinusoidal_table

    np.testing.assert_array_equal(sinusoidal_table(n, dim).numpy(),
                                  np.asarray(jax_table(n, dim)))


@pytest.mark.parametrize("layers", [W2V_TINY.conv_feature_layers, None])
def test_conv_geometry_matches(layers):
    from wav2vec_s_tpu.models import feature_extractor as jfe
    from wav2vec_s_tpu_torch.models import feature_extractor as tfe

    layers = layers or tfe.DEFAULT_CONV_LAYERS
    assert tfe.DEFAULT_CONV_LAYERS == jfe.DEFAULT_CONV_LAYERS
    assert (tfe.conv_receptive_stride(layers)
            == jfe.conv_receptive_stride(layers))
    for t in (400, 6400, 160000):
        assert (tfe.conv_output_length(t, layers)
                == jfe.conv_output_length(t, layers))


def test_random_init_is_seeded():
    from wav2vec_s_tpu_torch.models.modules import random_init_

    cfgs = (port_cfg(Wav2Vec2Config, W2V_TINY), port_cfg(CaatConfig,
                                                         CAAT_TINY))

    def make(seed):
        return random_init_(W2V2CaatModel(*cfgs),
                            torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.lm.layers.0.fc1.weight"],
                           c["decoder.lm.layers.0.fc1.weight"])
    assert torch.all(a["decoder.lm.layers.0.final_layer_norm.weight"] == 1)
    std = a["decoder.lm.layers.0.fc1.weight"].std().item()
    assert abs(std - CAAT_TINY.decoder_embed_dim ** -0.5) < 0.05


def test_compute_copy_casts_matmul_weights_only():
    from wav2vec_s_tpu_torch.models.modules import compute_copy

    model = port_caat(jax_caat()[1])
    cp = compute_copy(model, torch.bfloat16)
    lm = cp.decoder.lm
    assert lm.layers[0].fc1.weight.dtype == torch.bfloat16
    assert lm.embed_tokens.weight.dtype == torch.bfloat16
    assert lm.layers[0].final_layer_norm.weight.dtype == torch.float32
    out_proj = cp.decoder.transducer_out.output_proj
    assert out_proj.weight is lm.embed_tokens.weight
    # the original is untouched
    assert model.decoder.lm.layers[0].fc1.weight.dtype == torch.float32
