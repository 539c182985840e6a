"""CUDA checks of the torch port: the hand-written chunk-attention kernel
against its plain twin, and the tiny decode on the card against the same
decode on the CPU.  They skip without a CUDA device.  On a card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_port_gpu.py

(``--noconftest``: tests/conftest.py imports JAX, which the port does not
need.)  This file imports torch and the port only.
"""

import numpy as np
import pytest
import torch

from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.models.caat import CaatConfig, W2V2CaatModel
from wav2vec_s_tpu_torch.models.modules import random_init_
from wav2vec_s_tpu_torch.ops.chunk_attention import (
    chunk_cache_attention, chunk_cache_attention_ref)
from wav2vec_s_tpu_torch.stream.batched import CachedFusedGreedyDecoder
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


def test_tiny_decode_on_cuda_equals_cpu(cuda):
    vocab = Dictionary()
    for i in range(CAAT_TINY.vocab_size - vocab.nspecial):
        vocab.add_symbol(f"w{i}")
    model = random_init_(W2V2CaatModel(W2V_TINY, CAAT_TINY),
                         torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.1
            for n in (6400, 9600, 12800)]
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
