"""CUDA checks of the torch port: the hand-written kernels (chunk attention,
block-sparse flash attention) against their plain twins, and the tiny
cached and one-shot decodes on the card against the same decodes on the
CPU.  They skip without a CUDA device.  On a card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_port_gpu.py

(``--noconftest``: tests/conftest.py imports JAX, which the port does not
need.)  This file imports torch and the port only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.models.caat import CaatConfig, W2V2CaatModel
from wav2vec_s_tpu_torch.models.modules import random_init_
from wav2vec_s_tpu_torch.ops.block_mask import block_layout
from wav2vec_s_tpu_torch.ops.chunk_attention import (
    chunk_cache_attention, chunk_cache_attention_ref)
from wav2vec_s_tpu_torch.ops.flash_attention import (
    blockwise_flash_attention_packed, blockwise_flash_attention_ref)
from wav2vec_s_tpu_torch.stream.batched import (
    CachedFusedGreedyDecoder, OneShotCorpusDecoder)
from wav2vec_s_tpu_torch.stream.incremental import chunk_layout

pytestmark = pytest.mark.gpu

# the tiny dims of tests/test_caat.py (W2V_TINY, CAAT_TINY)
W2V_TINY = Wav2Vec2Config(
    conv_feature_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)),
    encoder_layers=2, encoder_embed_dim=24, encoder_ffn_embed_dim=48,
    encoder_attention_heads=4, main_context=4, right_context=2)
CAAT_TINY = CaatConfig(
    vocab_size=30, decoder_layers=2, decoder_embed_dim=24,
    decoder_ffn_embed_dim=48, decoder_attention_heads=4, jointer_layers=2,
    jointer_embed_dim=24, jointer_ffn_embed_dim=48, jointer_attention_heads=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # full-precision f32 references (cuDNN convs default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D,H,layout,t0", [
    (768, 12, (16, 8, 2), 0), (768, 12, (16, 8, 2), 480),
    (768, 12, (80, 8, 10), 256), (24, 4, (4, 2, 2), 37),
    (1024, 8, (4, 2, 1), 100)])
def test_kernel_matches_twin(cuda, dtype, atol, D, H, layout, t0):
    """Main-path shapes (Dh 64, R 48 and 240), the tiny dims (Dh 6) and the
    widest head the kernel takes (Dh 128); B = 4 streams, kv_cap 512."""
    B, kv_cap = 4, 512
    _, bias = chunk_layout(*layout)
    R = bias.shape[0]
    g = torch.Generator(device=cuda).manual_seed(R + t0)

    def n(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    args = (n(B, R, D) * (D // H) ** -0.5, n(kv_cap, B, D), n(kv_cap, B, D),
            n(B, R, D), n(B, R, D), torch.as_tensor(bias, device=cuda))
    before = chunk_cache_attention.launches
    got = chunk_cache_attention(*args, t0, H)
    torch.cuda.synchronize()
    assert chunk_cache_attention.launches == before + 1
    want = chunk_cache_attention_ref(*args, t0, H)
    assert got.dtype == dtype and got.shape == (B, R, D)
    assert (got.float() - want.float()).abs().max().item() < atol


def test_kernel_rejects_strided_views(cuda):
    _, bias = chunk_layout(4, 2, 1)
    q = torch.zeros(2, 6, 48, device=cuda)
    cache = torch.zeros(8, 2, 96, device=cuda)[:, :, :48]   # not contiguous
    with pytest.raises(ValueError):
        chunk_cache_attention(q, cache, cache, q, q,
                              torch.as_tensor(bias, device=cuda), 4, 4)


def _tiny(w2v):
    vocab = Dictionary()
    for i in range(CAAT_TINY.vocab_size - vocab.nspecial):
        vocab.add_symbol(f"w{i}")
    model = random_init_(W2V2CaatModel(w2v, CAAT_TINY),
                         torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.1
            for n in (6400, 9600, 12800)]
    return vocab, model, wavs


def test_tiny_decode_on_cuda_equals_cpu(cuda):
    vocab, model, wavs = _tiny(W2V_TINY)
    out = {}
    for dev in ("cpu", "cuda"):
        dec = CachedFusedGreedyDecoder(
            model.to(dev), vocab, W2V_TINY, max_len=256,
            max_emit_per_chunk=4, t_cap=640, blocks_per_step=2)
        before = chunk_cache_attention.launches
        out[dev] = dec.decode_corpus(wavs)
        launched = chunk_cache_attention.launches - before
        assert launched == (0 if dev == "cpu" else
                            W2V_TINY.encoder_layers * 79)   # 79 chunks
    assert out["cuda"] == out["cpu"]


def _flash_inputs(dev, dtype, B, T, mc, rc, D, seed=0):
    S = block_layout(T, mc, rc).total_len
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, S, D), generator=g, device=dev).to(dtype)
               for _ in range(3))
    # non-contiguous key padding of the last stream: a frame tail and the
    # last rc copies (tests/test_pallas_attention.py)
    pad = torch.zeros((B, S), dtype=torch.bool, device=dev)
    pad[-1, T - 10:T] = True
    pad[-1, S - 3:] = True
    return q, k, v, pad


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D,H,T,mc,rc", [
    (24, 4, 97, 4, 2), (24, 4, 96, 4, 0),          # dh 6, the tiny dims
    (768, 12, 488, 16, 8), (768, 12, 488, 16, 0),  # dh 64, the full width
    (256, 2, 200, 16, 8), (256, 2, 64, 8, 0)])     # dh 128, the widest head
def test_flash_kernel_matches_twin(cuda, dtype, atol, D, H, T, mc, rc):
    """Output on valid rows and the row stats m/l (atol and rtol 1e-4: l is
    a sum of up to S terms), B = 2 streams, the second padded."""
    q, k, v, pad = _flash_inputs(cuda, dtype, 2, T, mc, rc, D)
    before = blockwise_flash_attention_packed.launches
    out, m, l = blockwise_flash_attention_packed(q, k, v, pad, H, T, mc, rc,
                                                 return_stats=True)
    torch.cuda.synchronize()
    assert blockwise_flash_attention_packed.launches == before + 1
    want, m_want, l_want = blockwise_flash_attention_ref(q, k, v, pad, H, T,
                                                         mc, rc)
    assert out.dtype == dtype and out.shape == q.shape
    valid = ~pad
    err = (out[valid].float() - want[valid].float()).abs().max().item()
    assert err < atol
    rows = valid[:, None, :].expand_as(m)
    torch.testing.assert_close(m[rows], m_want[rows], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l[rows], l_want[rows], atol=1e-4, rtol=1e-4)
    # without the stats the kernel writes the same output
    again = blockwise_flash_attention_packed(q, k, v, pad, H, T, mc, rc)
    assert torch.equal(again, out)


@pytest.mark.parametrize("bad", ["strided", "mistyped", "cpu_mask"])
def test_flash_kernel_rejects(cuda, bad):
    q, k, v, pad = _flash_inputs(cuda, torch.float32, 2, 96, 16, 8, 64)
    if bad == "strided":
        k = torch.cat([k, k], dim=-1)[..., :64]    # a view, not contiguous
    elif bad == "mistyped":
        v = v.half()
    else:
        pad = pad.cpu()
    with pytest.raises(ValueError):
        blockwise_flash_attention_packed(q, k, v, pad, 4, 96, 16, 8)


def test_tiny_oneshot_on_cuda_equals_cpu(cuda):
    """Flash attention at dh 6: the one-shot decode on the card equals the
    one on the CPU and the cached decode on the card; one kernel launch per
    layer and encode sub-batch (3 streams: one sub-batch)."""
    w2v = dataclasses.replace(W2V_TINY, attention_impl="flash")
    vocab, model, wavs = _tiny(w2v)
    kw = dict(max_len=256, max_emit_per_chunk=4, t_cap=640,
              blocks_per_step=2)
    out = {}
    for dev in ("cpu", "cuda"):
        dec = OneShotCorpusDecoder(model.to(dev), vocab, w2v, **kw)
        before = blockwise_flash_attention_packed.launches
        out[dev] = dec.decode_corpus(wavs)
        launched = blockwise_flash_attention_packed.launches - before
        assert launched == (0 if dev == "cpu" else w2v.encoder_layers)
    cached = CachedFusedGreedyDecoder(model, vocab, w2v, **kw)
    assert out["cuda"] == out["cpu"] == cached.decode_corpus(wavs)
    assert sum(len(d) for d in out["cuda"][1]) > 0
