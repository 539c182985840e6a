"""IncrementalBlockwiseEncoder: the port against the JAX package.

Both packages get the same seeded weights (JAX tree -> port state dict via
``checkpoint/convert.py``) and the same audio; the JAX encoder is built
with ``fused_attention=True`` so its Pallas chunk-attention kernel (interpret
mode off the TPU) is in the comparison.  Three steps and a flush, post-LN
and pre-LN, one and two blocks per step; the committed encoder outputs and
every layer's K/V cache agree to atol 1e-4 in float32.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import W2V_TINY
from tests.test_torch_port_import import jax_caat, port_caat, port_cfg
from wav2vec_s_tpu.models.feature_extractor import (
    ConvFeatureExtractor as JaxConvFeatureExtractor)
from wav2vec_s_tpu.stream.incremental import (
    IncrementalBlockwiseEncoder as JaxEncoder)
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.stream.incremental import IncrementalBlockwiseEncoder

T_CAP, N, STEPS = 64, 2, 3


def _windows(enc, seed):
    """STEPS + 1 windows of one continuous seeded stream."""
    stride = enc.n_main * enc.hop
    audio = np.random.default_rng(seed).standard_normal(
        (N, STEPS * stride + enc.window)).astype(np.float32) * 0.3
    return [audio[:, k * stride:k * stride + enc.window]
            for k in range(STEPS + 1)]


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("layer_norm_first", [False, True])
def test_steps_and_flush_match_jax(layer_norm_first, blocks):
    w2v = dataclasses.replace(W2V_TINY, layer_norm_first=layer_norm_first)
    _, params = jax_caat(w2v)
    ref = JaxEncoder(w2v, params["encoder"], N, t_cap=T_CAP,
                     blocks_per_step=blocks, fused_attention=True)
    port = IncrementalBlockwiseEncoder(
        port_cfg(Wav2Vec2Config, w2v),
        port_caat(params, w2v).encoder.w2v2_model, N, t_cap=T_CAP,
        blocks_per_step=blocks)
    assert (port.window, port.n_main) == (ref.window, ref.n_main)

    a, b = ref.init(), port.init()
    for k, win in enumerate(_windows(port, seed=blocks)):
        flush = k == STEPS
        a = ref.step(a, win, flush=flush)
        b = port.step(b, torch.from_numpy(win), flush=flush)
        assert b.t_main == int(a.t_main)
    t = b.t_main
    assert t == STEPS * port.n_main + port.n_main + port.rc
    np.testing.assert_allclose(b.out_cache[:t].numpy(),
                               np.asarray(a.out_cache)[:t], atol=1e-4, rtol=0)
    for i in range(w2v.encoder_layers):
        for got, want in ((b.k_cache[i], a.k_cache[i]),
                          (b.v_cache[i], a.v_cache[i])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)


@pytest.mark.parametrize("encoder_layers", [2, 12])
def test_conv_front_end_matches_jax(encoder_layers):
    """layer_norm_num: LN in every conv block at 2 layers, only in block 0
    at 12 (the fork quirk)."""
    w2v = dataclasses.replace(W2V_TINY, encoder_layers=encoder_layers)
    _, params = jax_caat(w2v)
    fe = params["encoder"]["feature_extractor"]
    assert ("ln_1" in fe) == (encoder_layers != 12)
    conv = port_caat(params, w2v).encoder.w2v2_model.feature_extractor
    audio = np.random.default_rng(0).standard_normal((2, 800)).astype(
        np.float32)
    want = JaxConvFeatureExtractor(
        conv_layers=w2v.conv_feature_layers, mode="layer_norm",
        layer_norm_num=w2v.layer_norm_num).apply({"params": fe},
                                                 jnp.asarray(audio))
    with torch.no_grad():
        got = conv(torch.from_numpy(audio))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_step_past_capacity_raises():
    _, params = jax_caat()
    enc = IncrementalBlockwiseEncoder(
        port_cfg(Wav2Vec2Config, W2V_TINY),
        port_caat(params).encoder.w2v2_model, 1, t_cap=8)
    state = enc.init()
    win = torch.zeros(1, enc.window)
    state = enc.step(state, win)                # rows [0, 4)
    with pytest.raises(ValueError):
        enc.step(enc.step(state, win), win)     # rows [8, 12) do not fit
