"""CUDA checks of the torch port: the hand-written kernels (chunk attention,
the emission loop's one-query attention, block-sparse flash attention
forward and backward with its in-kernel
dropout, dropout, the transducer lattices and affine rows) against their
plain twins, the tiny cached and one-shot decodes (and the kernel
launches of a profiled cached decode inside its ``w2vs/decoder.*``
spans), the four tiny beam
decodes, the tiny training step and a tiny run of the training CLI on the
card against the same on the CPU, the flash kernels at the pre-training
call under each context bucket and two tiny pre-training updates on the
card against the CPU, the offline-ASR heads (CTC and seq2seq loss and
gradients, the greedy decoders, the beam generator) on the card against
the CPU, and the fbank and text CAAT families (loss and gradients of every
front-end x jointer and of the text model, the fbank agent) on the card
against the CPU with K4 at their dropout sites, and the group-norm
wav2vec 2.0 model (full-context and blockwise), the wait-k and MMA
baselines (loss and gradients, ``hard_decode_step``, the two agents) on
the card against the CPU with K4 at the baselines' dropout sites, each
rematerialization policy and the flat optimizer on the card against the
plain update, and the native wav reader built and read on the card's
machine.  They skip without a CUDA device.  On a card:

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
from wav2vec_s_tpu_torch.ops.chunk_attention import (
    kernel_path as chunk_kernel_path)
from wav2vec_s_tpu_torch.ops.flash_attention import (
    CUDA_CORE, TENSOR_CORE, blockwise_flash_attention_bwd,
    blockwise_flash_attention_bwd_ref, blockwise_flash_attention_packed,
    blockwise_flash_attention_ref, kernel_path)
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


K1_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (B, D, H, layout, t0): main-path shapes (Dh 64, R 48 and 240), the tiny
# dims (Dh 6) and the widest head the kernels take (Dh 128), in both dtypes
K1_BOTH = [(4, 768, 12, (16, 8, 2), 0), (4, 768, 12, (16, 8, 2), 480),
           (4, 768, 12, (80, 8, 10), 256), (4, 24, 4, (4, 2, 2), 37),
           (4, 1024, 8, (4, 2, 1), 100)]
# bfloat16 on the tensor-core kernel: heads of 32 and 128, R 24 (ds1), one
# stream, and t0 at the edges of its 64-key tiles and of the cache
K1_BF16 = ([(4, 256, 8, (16, 8, 2), t0) for t0 in (0, 1, 65, 512)]
           + [(4, 512, 4, (16, 8, 2), t0) for t0 in (0, 1, 65, 512)]
           + [(4, 768, 12, (16, 8, 1), t0) for t0 in (0, 1, 65, 512)]
           + [(1, 768, 12, (16, 8, 2), t0) for t0 in (0, 1, 63, 64, 65, 512)]
           + [(1, 512, 4, (80, 8, 10), 65), (3, 768, 12, (80, 8, 10), 512)])


@pytest.mark.parametrize("dtype,B,D,H,layout,t0", [
    (dtype, *case) for dtype in (torch.float32, torch.bfloat16)
    for case in K1_BOTH] + [(torch.bfloat16, *case) for case in K1_BF16])
def test_kernel_matches_twin(cuda, dtype, B, D, H, layout, t0):
    """Each kernel against the twin, kv_cap 512, and the count of the set
    that ``kernel_path`` names: float32 and odd head widths on the CUDA
    cores, bfloat16 at heads of 32, 64 or 128 on the tensor cores."""
    kv_cap = 512
    _, bias = chunk_layout(*layout)
    R = bias.shape[0]
    g = torch.Generator(device=cuda).manual_seed(R + t0)

    def n(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    args = (n(B, R, D) * (D // H) ** -0.5, n(kv_cap, B, D), n(kv_cap, B, D),
            n(B, R, D), n(B, R, D), torch.as_tensor(bias, device=cuda))
    path = chunk_kernel_path(dtype, D // H)
    assert path == (TENSOR_CORE if dtype == torch.bfloat16
                    and D // H in (32, 64, 128) else CUDA_CORE)
    before = chunk_cache_attention.launches
    before_sets = dict(chunk_cache_attention.path_launches)
    got = chunk_cache_attention(*args, t0, H)
    torch.cuda.synchronize()
    assert chunk_cache_attention.launches == before + 1
    before_sets[path] += 1
    assert chunk_cache_attention.path_launches == before_sets
    want = chunk_cache_attention_ref(*args, t0, H)
    assert got.dtype == dtype and got.shape == (B, R, D)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() < K1_ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t0", [0, 65, 448])
def test_kernel_never_reads_cache_rows_past_t0(cuda, dtype, t0):
    """Uncommitted cache rows may hold anything, NaN included: the output
    is finite and equals the twin's on clean rows."""
    B, D, H, kv_cap = 3, 768, 12, 512
    _, bias = chunk_layout(16, 8, 2)
    R = bias.shape[0]
    g = torch.Generator(device=cuda).manual_seed(t0)

    def n(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    q, kc, vc, kn, vn = (n(B, R, D) * 0.125, n(kv_cap, B, D),
                         n(kv_cap, B, D), n(B, R, D), n(B, R, D))
    bias = torch.as_tensor(bias, device=cuda)
    want = chunk_cache_attention_ref(q, kc, vc, kn, vn, bias, t0, H)
    kc[t0:] = float("nan")
    vc[t0:] = float("nan")
    got = chunk_cache_attention(q, kc, vc, kn, vn, bias, t0, H)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() < K1_ATOL[dtype]


def test_tensor_core_kernel_refuses_a_misaligned_view(cuda):
    """A contiguous bfloat16 view that starts 2 bytes off a 16-byte
    boundary raises before any launch; the same values in float32 (the
    CUDA-core kernel) run."""
    B, R, D, H, kv_cap = 2, 48, 768, 12, 64
    bias = torch.as_tensor(chunk_layout(16, 8, 2)[1], device=cuda)

    def pair(*shape):
        n = int(np.prod(shape))
        flat = torch.randn(n + 8, device=cuda).bfloat16()
        return flat[:n].view(*shape), flat[1:n + 1].view(*shape)

    q, kc, vc, kn, vn = (pair(B, R, D), pair(kv_cap, B, D),
                         pair(kv_cap, B, D), pair(B, R, D), pair(B, R, D))
    ok = [t[0] for t in (q, kc, vc, kn, vn)]
    chunk_cache_attention(*ok, bias, 10, H)
    before = chunk_cache_attention.launches
    for i, t in enumerate((q, kc, vc, kn, vn)):
        bad = list(ok)
        bad[i] = t[1]
        assert bad[i].is_contiguous() and bad[i].data_ptr() % 16 == 2
        with pytest.raises(ValueError, match="16-byte aligned"):
            chunk_cache_attention(*bad, bias, 10, H)
    assert chunk_cache_attention.launches == before
    off = [t[1].float() for t in (q, kc, vc, kn, vn)]
    got = chunk_cache_attention(*off, bias, 10, H)
    want = chunk_cache_attention_ref(*off, bias, 10, H)
    assert (got - want).abs().max().item() < 1e-4


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


# (T, N, D, heads, dtype): the serving jointer's and the LM's widths in
# both dtypes (16-byte loads), the widest head, the tiny heads of 6 (one
# element at a time)
K7_CASES = [(T, N, D, H, dtype) for dtype in (torch.float32, torch.bfloat16)
            for T, N, D, H in ((96, 6, 768, 12), (40, 5, 1024, 16),
                               (33, 3, 256, 2), (24, 4, 24, 4))]


@pytest.mark.parametrize("T,N,D,H,dtype", K7_CASES)
def test_decode_attention_kernel_matches_plain(cuda, T, N, D, H, dtype):
    """K7 against its plain version under every bound form (none, [N], 0-d
    and lo) and a plane of either stride order; a stream with no loaded
    row, or none the plane shows, gets zeros."""
    from wav2vec_s_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_ref)

    g = torch.Generator(device=cuda).manual_seed(T + D)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((N, D), (T, N, D), (T, N, D)))
    hi = torch.randint(0, T + 3, (N,), generator=g, device=cuda)
    hi[0] = 0
    lo = torch.randint(0, T, (N,), generator=g, device=cuda)
    plane = torch.rand((T, N), generator=g, device=cuda) < 0.5
    plane[:, 1] = False
    for kw in ({}, {"hi": hi}, {"hi": torch.tensor(T - 2, device=cuda)},
               {"lo": lo, "hi": hi, "plane": plane.T},
               {"hi": hi, "plane": plane.T.contiguous()}):
        launches = decode_attention.launches
        got = decode_attention(q, k, v, H, **kw)
        torch.cuda.synchronize()
        assert decode_attention.launches == launches + 1
        want = decode_attention_ref(q, k, v, H, **kw)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max().item() <= tol, kw
        if "hi" in kw and kw["hi"].dim():
            assert (got[0] == 0).all()
        if "plane" in kw:
            assert (got[1] == 0).all()


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
    (256, 2, 200, 16, 8), (256, 2, 64, 8, 0),      # dh 128, the widest head
    # the edges of the tensor-core kernels (bfloat16): dh 32 at S 145 (S % 64
    # and S % 4 not 0), dh 64 with a padded stream at S 144, dh 128 at S 145
    (64, 2, 97, 16, 8), (128, 2, 96, 16, 8), (256, 2, 97, 16, 8)])
def test_flash_kernel_matches_twin(cuda, dtype, atol, D, H, T, mc, rc):
    """Output on valid rows and the row stats m/l (atol and rtol 1e-4: l is
    a sum of up to S terms), B = 2 streams, the second padded.  bfloat16
    with heads of 32, 64 or 128 runs the tensor-core kernel (it rounds the
    probabilities to bfloat16; the tolerance covers one ulp of an output of
    size 2-4), everything else the CUDA-core kernel."""
    q, k, v, pad = _flash_inputs(cuda, dtype, 2, T, mc, rc, D)
    path = kernel_path(dtype, D // H)
    assert path == (TENSOR_CORE if dtype == torch.bfloat16
                    and D // H in (32, 64, 128) else CUDA_CORE)
    before = blockwise_flash_attention_packed.launches
    on_path = blockwise_flash_attention_packed.path_launches[path]
    out, m, l = blockwise_flash_attention_packed(q, k, v, pad, H, T, mc, rc,
                                                 return_stats=True)
    torch.cuda.synchronize()
    assert blockwise_flash_attention_packed.launches == before + 1
    assert blockwise_flash_attention_packed.path_launches[path] == on_path + 1
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


def _spanned_launches(prof):
    """(kernel launches and CUDA graph replays on the host, those inside a
    ``w2vs/decoder.*`` span of their thread)."""
    spans, launches = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.start_ns(), e.start_ns() + e.duration_ns(),
                e.start_thread_id())
        if e.is_user_annotation() and e.name().startswith("w2vs/decoder."):
            spans.append(item)
        elif e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel",
                                  "cudaGraphLaunch")):
            launches.append(item)
    inside = [x for x in launches
              if any(s[0] <= x[0] and x[1] <= s[1] and s[2] == x[2]
                     for s in spans)]
    return launches, inside


def test_decoder_spans_hold_the_launches_and_counters_count(cuda):
    """Under CPU + CUDA profiling of one tiny agent corpus, at least 99%
    of the host's kernel launches lie inside a ``w2vs/decoder.*`` span and
    the counters count; under CUDA-only profiling the counters count
    exactly when ``debug.tracing()`` reads true there (printed)."""
    from torch.profiler import ProfilerActivity, profile

    from wav2vec_s_tpu_torch.utils import debug

    vocab, model, wavs = _tiny(W2V_TINY)
    dec = CachedFusedGreedyDecoder(
        model.to("cuda"), vocab, W2V_TINY, max_len=256,
        max_emit_per_chunk=4, t_cap=640, blocks_per_step=2)
    handle = dec.stage(wavs)
    dec.decode_corpus(handle)
    torch.cuda.synchronize()
    debug.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec.decode_corpus(handle)
        torch.cuda.synchronize()
    launches, inside = _spanned_launches(prof)
    print(f"launches {len(launches)}, inside decoder spans {len(inside)}")
    assert launches and len(inside) >= 0.99 * len(launches)
    assert debug.counters()["decoder.emit_iters"] == 79 * 4   # 79 chunks
    debug.reset_counters()
    with profile(activities=[ProfilerActivity.CUDA]):
        on = debug.tracing()
        dec.decode_corpus(handle)
        torch.cuda.synchronize()
    counted = debug.counters()
    debug.reset_counters()
    print(f"CUDA-only profiling: tracing() {on}, counters {counted}")
    assert bool(counted) == on


def test_emission_loop_replays_cuda_graphs(cuda):
    """Both tiny decoders on the card run each chunk's emission loop as a
    CUDA graph: one graph per distinct cache capacity the chunks use; texts
    and delays equal the CPU's on the first corpus (captures), a second
    (replays only), a corpus of half the length (the same graphs replayed)
    and corpora of another width (N 2, then N 3 again: the graphs are
    dropped and captured anew).  Under CPU + CUDA profiling of the second
    corpus every chunk's iterations are replayed
    (``decoder.emit_iters_graphed == decoder.emit_iters``), and every
    kernel launch and graph replay lies inside a ``w2vs/decoder.*`` span."""
    from torch.profiler import ProfilerActivity, profile

    from wav2vec_s_tpu_torch.utils import debug

    w2v = dataclasses.replace(W2V_TINY, attention_impl="flash")
    vocab, model, wavs = _tiny(w2v)
    kw = dict(max_len=256, max_emit_per_chunk=4, t_cap=640,
              blocks_per_step=2)
    for cls in (CachedFusedGreedyDecoder, OneShotCorpusDecoder):
        cpu = cls(model.to("cpu"), vocab, w2v, **kw)
        caps = []
        greedy = cpu._greedy
        cpu._greedy = lambda loop, cap: (caps.append(cap), greedy(loop, cap))
        half = [w[:len(w) // 2] for w in wavs]
        want = [cpu.decode_corpus(w) for w in (wavs, wavs[1:], half)]
        dec = cls(model.to("cuda"), vocab, w2v, **kw)
        handle = dec.stage(wavs)
        assert dec.decode_corpus(handle) == want[0]
        graphs = dict(dec._loop.graphs)
        assert sorted(graphs) == sorted(set(caps))
        debug.reset_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = dec.decode_corpus(handle)
            torch.cuda.synchronize()
        counted = debug.counters()
        debug.reset_counters()
        assert out == want[0]
        assert dec._loop.graphs == graphs            # replayed, not captured
        assert counted["decoder.emit_iters"] == 79 * 4          # 79 chunks
        assert counted["decoder.emit_iters_graphed"] == 79 * 4
        replays = sum(e.name().startswith("cudaGraphLaunch")
                      for e in prof.profiler.kineto_results.events())
        launches, inside = _spanned_launches(prof)
        print(f"{cls.__name__}: graphs at caps {sorted(graphs)}, graph "
              f"replays {replays}, launches {len(launches)}, inside "
              f"decoder spans {len(inside)}, counters {counted}")
        assert replays == 79
        assert launches and len(inside) == len(launches)
        assert dec.decode_corpus(half) == want[2]
        assert dec._loop.graphs == graphs            # kept across lengths
        assert dec.decode_corpus(wavs[1:]) == want[1]
        assert dec._loop.key[0] == 2
        assert dec.decode_corpus(wavs) == want[0]


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


# --- training kernels: K4 dropout, K5a/K5b lattices, K6 affine rows ---

from wav2vec_s_tpu_torch.ops.dropout import (  # noqa: E402
    dropout_ref, hw_dropout, keep_mask)
from wav2vec_s_tpu_torch.ops.transducer import (  # noqa: E402
    analytic, kernels, lattice)

# the full-width step's encoder rows (8 x 748 with the rc copies) at the
# model and FFN widths, the attention probabilities, and an odd size
DROPOUT_SHAPES = [(8 * 748, 768), (8 * 748, 3072), (8 * 12 * 748, 748),
                  (7, 13)]


@pytest.mark.parametrize("p", [0.1, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DROPOUT_SHAPES)
def test_dropout_kernel_bit_equal_to_twin(cuda, shape, dtype, p):
    g = torch.Generator(device=cuda).manual_seed(len(shape) + shape[-1])
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    seed, offset = 0xDEADBEEF12345, 41
    before = hw_dropout.launches
    got = hw_dropout(x, p, seed, offset)
    torch.cuda.synchronize()
    assert hw_dropout.launches == before + 1
    assert torch.equal(got, dropout_ref(x, p, seed, offset))
    mask = hw_dropout(torch.ones_like(x), p, seed, offset) != 0
    assert torch.equal(mask.reshape(-1),
                       keep_mask(x.numel(), p, seed, offset, cuda))


@pytest.mark.parametrize("shape,axis", [((6, 10, 12), 1), ((6, 9, 7), 1),
                                        ((6, 3, 10, 9), 2)])
@pytest.mark.parametrize("rows,seq", [((2, 5), None), ((0, 6), (3, 8)),
                                      ((3, 6), (1, 6))])
def test_dropout_kernel_on_shards(cuda, shape, axis, rows, seq):
    """K4 on a data-parallel rank's rows and / or a context-parallel
    rank's time block (the index map of ops/dropout.py; grouped and
    per-element Philox paths): bit-equal to the twin under the same map
    and to the matching part of the whole tensor's mask."""
    from wav2vec_s_tpu_torch.ops.dropout import DropoutContext, dropout_ref
    from wav2vec_s_tpu_torch.parallel.mesh import Shard

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    whole = hw_dropout(x, 0.3, 11, 7)
    ctx = DropoutContext(torch.Generator(),
                         None if rows == (0, shape[0])
                         else Shard(rows[0], rows[1], shape[0]))
    part, want = x[rows[0]:rows[1]], whole[rows[0]:rows[1]]
    split = None
    if seq is not None:
        part = part.narrow(axis, seq[0], seq[1] - seq[0])
        want = want.narrow(axis, seq[0], seq[1] - seq[0])
        split = (axis, seq[0], shape[axis])
    part = part.contiguous()
    index = ctx.index(tuple(part.shape), split)
    got = hw_dropout(part, 0.3, 11, 7, index)
    assert torch.equal(got, dropout_ref(part, 0.3, 11, 7, index))
    assert torch.equal(got, want)


def test_dropout_kernel_backward_regenerates_the_mask(cuda):
    x = torch.rand((333, 257), device=cuda).add_(0.5).requires_grad_(True)
    y = hw_dropout(x, 0.3, 7, 9)
    dy = torch.randn_like(y)
    before = hw_dropout.launches
    y.backward(dy)
    assert hw_dropout.launches == before + 1
    keep = y.detach() != 0
    torch.testing.assert_close(x.grad, torch.where(keep, dy / 0.7, 0.0))
    for s, o in ((8, 9), (7, 10)):
        other = hw_dropout(torch.ones_like(x), 0.3, s, o) != 0
        assert (other != keep).float().mean() > 0.3 * 0.7


LATTICE = [(8, 8, 41, 10000), (16, 32, 65, 512), (4, 512, 129, 512),
           (2, 6, 1100, 64)]          # U past one block of 1024 threads


def _lattice_problem(dev, B, T, U, V, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    acts = torch.randn((B, T, U, V), generator=g, device=dev)
    labels = torch.randint(1, V, (B, U - 1), generator=g, device=dev)
    al = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev)
    ll = torch.randint(U // 2, U, (B,), generator=g, device=dev)
    al[0], ll[0] = T, U - 1
    dv = lattice.delay_cost_diag_positive((B, T, U), al, ll)
    return acts, labels, al, ll, dv


@pytest.mark.parametrize("B,T,U,V", LATTICE)
def test_lattice_kernels_match_twins(cuda, B, T, U, V):
    """alphas everywhere, betas and the reverse rows on the valid cells,
    err / (1 + |x|) <= 2e-5 (5e-5 for betas): the twins' prefix sums lose
    ~1e-6 relative at T 512."""
    acts, labels, al, ll, dv = _lattice_problem(cuda, B, T, U, V)
    lpb, lpe, _ = lattice.lattice_log_probs_lse(acts, labels, 0)
    lpb = lpb.contiguous()
    valid = ((torch.arange(T, device=cuda)[None, :, None] < al[:, None, None])
             & (torch.arange(U, device=cuda)[None, None, :]
                <= ll[:, None, None]))

    def rel(a, b, where=None):
        e = (a - b).abs() / (1 + b.abs())
        return (e if where is None else e[where]).max().item()

    n = (kernels.alphas.launches, kernels.betas.launches,
         kernels.affine_rows.launches)
    a = kernels.alphas(lpb, lpe)
    assert rel(a, lattice.alphas(lpb, lpe)) <= 2e-5
    be = kernels.betas(lpb, lpe, al, ll)
    assert rel(be, lattice.betas(lpb, lpe, al, ll)[0], valid) <= 5e-5
    rows = [lattice.expected_delay(lpb, lpe, a, dv, rows=r)
            for r in (kernels.affine_rows, lattice.affine_rows)]
    assert rel(*rows) <= 2e-5
    t_valid, emit_ok = lattice.lattice_masks((B, T, U), al, ll)
    down, up = lattice.beta_shifts(be, ll)
    rows = [lattice.expected_delay_bwd(lpb, lpe, be, down, up, dv, t_valid,
                                       emit_ok, rows=r)[0]
            for r in (kernels.affine_rows, lattice.affine_rows)]
    assert rel(*rows, valid) <= 2e-5
    torch.cuda.synchronize()
    assert (kernels.alphas.launches, kernels.betas.launches,
            kernels.affine_rows.launches) == (n[0] + 1, n[1] + 1, n[2] + 2)


@pytest.mark.parametrize("B,T,U,V", LATTICE[:3])
def test_loss_and_grad_kernels_match_float64_twins(cuda, B, T, U, V):
    """The loss through the kernels (f32) against the twins in float64 on
    the CPU: total err/(1+|x|) 1e-5, delay 5e-4, grad max|diff| / max|g|
    1e-3, or the f32 twins' own error where that is larger (at T 512 f32
    posteriors exp(alpha + beta - ll) carry ~2e-3 of rounding, |alpha| ~
    2400), capped at 1e-5, 2e-3 and 5e-3, which the f32 twins must meet
    too (they showed 1.3e-6, 9.0e-4 and 2.9e-3 at T 512)."""
    acts, labels, al, ll, dv = _lattice_problem(cuda, B, T, U, V, seed=1)

    def run(a):
        a = a.detach().clone().requires_grad_(True)
        total, _, delay = analytic.delay_transducer_loss(
            a, labels.to(a.device), al.to(a.device), ll.to(a.device),
            dv.to(a.device))
        total.sum().backward()
        return [x.detach().cpu().double() for x in (total, delay, a.grad)]

    want = run(acts.cpu().double())

    def errs(got):
        return [((got[0] - want[0]).abs() / (1 + want[0].abs())).max(),
                ((got[1] - want[1]).abs() / (1 + want[1].abs())).max(),
                (got[2] - want[2]).abs().max() / want[2].abs().max()]

    ceiling = (1e-5, 2e-3, 5e-3)
    twin = errs(run(acts.cpu()))
    assert all(t <= c for t, c in zip(twin, ceiling))
    bound = [min(c, max(b, t)) for b, t, c in zip((1e-5, 5e-4, 1e-3), twin,
                                                  ceiling)]
    assert all(e <= b for e, b in zip(errs(run(acts)), bound))


# the lattice widths at the edges of the warp set's lanes (1, 2, 8
# columns per lane) and past it, and depths from one row to T 512
WALK_U = (1, 2, 31, 32, 33, 64, 65, 255, 256, 257)
WALK_T = (1, 2, 8, 512)
# err/(1+|x|) of the block set's fused walks' delays against float64
# (chip_smoke.py BLOCK_WALK_F64_TOL, where phase 5 prints them: 4.6e-7 to
# 8.7e-7 at U 300); the unfused sequence they replace read 5.0e-4
BLOCK_WALK_F64_TOL = 1e-5


def _walk_problem(dev, T, U, seed=0):
    """Three lattices of [T, U]: full, ragged (one frame fewer, half the
    labels) and the shortest (one frame, no label); int64 lengths; the
    delay values of "zero" at T 1 and 8 (a broadcast view, stride 0 along
    U), else of the training default."""
    g = torch.Generator(device=dev).manual_seed(seed + 1000 * U + T)
    lpb = -torch.rand((3, T, U), generator=g, device=dev) * 3
    lpe = -torch.rand((3, T, U), generator=g, device=dev) * 3
    al = torch.tensor([T, max(T - 1, 1), 1], device=dev)
    ll = torch.tensor([U - 1, (U - 1) // 2, 0], device=dev)
    dv = (lattice.delay_cost_zero if T in (1, 8)
          else lattice.delay_cost_diag_positive)((3, T, U), al, ll)
    valid = ((torch.arange(T, device=dev)[None, :, None] < al[:, None, None])
             & (torch.arange(U, device=dev)[None, None, :]
                <= ll[:, None, None]))
    return lpb, lpe, al, ll, dv, valid


def _rel(a, b, where=None):
    e = (a - b).abs() / (1 + b.abs())
    return (e if where is None else e[where]).max().item()


@pytest.mark.parametrize("T", WALK_T)
@pytest.mark.parametrize("U", WALK_U)
def test_lattice_walks_match_twins(cuda, T, U):
    """Every mode on the set ``lattice_path(U)`` picks (warp set up to U
    256, block set past it) against its twin: alphas and the forward rows
    everywhere, betas, the reverse rows and the reverse fused walk on the
    valid cells; err / (1 + |x|) 2e-5, 5e-5 for betas.  The warp set's
    fused walks' expected delays against the twin rows on the walk's own
    alphas (betas): the twins' alphas differ by rounding that grows with T.
    The block set's fused walks form each cell's transition probabilities
    normalised from its log-add-exp (csrc/transducer.cu), not from the
    stored alpha as the twins do: their expected delays are held to the
    float64 twins, at BLOCK_WALK_F64_TOL and within twice the f32 twins'
    own error (or 1e-6)."""
    lpb, lpe, al, ll, dv, valid = _walk_problem(cuda, T, U)
    path = kernels.lattice_path(U)
    wrappers = (kernels.alphas, kernels.betas, kernels.affine_rows,
                kernels.alphas_and_expected_delay,
                kernels.betas_and_expected_delay_bwd)
    before = {fn: dict(fn.path_launches) for fn in wrappers}
    a_t = lattice.alphas(lpb, lpe)
    b_t, _, t_valid, emit_ok = lattice.betas(lpb, lpe, al, ll)
    assert _rel(kernels.alphas(lpb, lpe), a_t) <= 2e-5
    be = kernels.betas(lpb, lpe, al, ll)
    assert _rel(be, b_t, valid) <= 5e-5
    c = [torch.rand((3, T, U), device=cuda) for _ in range(3)]
    for rev in (False, True):
        assert _rel(kernels.affine_rows(*c, reverse=rev),
                    lattice.affine_rows(*c, reverse=rev)) <= 2e-5
    a, ad = kernels.alphas_and_expected_delay(lpb, lpe, dv)
    assert _rel(a, a_t) <= 2e-5
    be, bd = kernels.betas_and_expected_delay_bwd(lpb, lpe, al, ll, dv)
    assert _rel(be, b_t, valid) <= 5e-5
    if path == kernels.WARP:
        assert _rel(ad, lattice.expected_delay(lpb, lpe, a, dv)) <= 2e-5
        down, up = lattice.beta_shifts(be, ll)
        want = lattice.expected_delay_bwd(lpb, lpe, be, down, up, dv,
                                          t_valid, emit_ok)[0]
        assert _rel(bd, want, valid) <= 2e-5
    else:
        f64 = [x.double() for x in (lpb, lpe, dv)]
        ad64 = lattice.alphas_and_expected_delay(*f64)[1]
        bd64 = lattice.betas_and_expected_delay_bwd(f64[0], f64[1], al, ll,
                                                    f64[2])[1]
        ad32 = lattice.alphas_and_expected_delay(lpb, lpe, dv)[1]
        bd32 = lattice.betas_and_expected_delay_bwd(lpb, lpe, al, ll, dv)[1]
        assert _rel(ad, ad64) <= BLOCK_WALK_F64_TOL
        assert _rel(bd, bd64, valid) <= BLOCK_WALK_F64_TOL
        assert _rel(ad, ad64) <= max(2 * _rel(ad32, ad64), 1e-6)
        assert _rel(bd, bd64, valid) <= max(2 * _rel(bd32, bd64, valid),
                                            1e-6)
    torch.cuda.synchronize()
    for fn, n in ((kernels.alphas, 1), (kernels.betas, 1),
                  (kernels.affine_rows, 2),
                  (kernels.alphas_and_expected_delay, 1),
                  (kernels.betas_and_expected_delay_bwd, 1)):
        want = dict(before[fn])
        want[path] += n
        assert fn.path_launches == want, (fn.__name__, fn.path_launches)


@pytest.mark.parametrize("T", WALK_T)
@pytest.mark.parametrize("U", [u for u in WALK_U if u <= 256])
def test_warp_set_equals_block_set(cuda, T, U):
    """Through the C entry points: the warp set's alphas and betas equal
    the block set's bit for bit (the same precise expf/log1pf in the same
    order), the affine rows to the last place (the multiply-adds may
    contract otherwise); int32 and int64 lengths read the same."""
    from wav2vec_s_tpu_torch.ops import native

    lib = native.library()
    lpb, lpe, al, ll, _, _ = _walk_problem(cuda, T, U, seed=1)
    st = torch.cuda.current_stream().cuda_stream
    al32, ll32 = al.to(torch.int32), ll.to(torch.int32)

    def run(fn, *ins, tail=()):
        """fn(*ins, out, B, T, U, *tail, stream) -> out, every cell
        written (none left NaN)."""
        out = torch.full_like(lpb, float("nan"))
        assert fn(*ins, out.data_ptr(), 3, T, U, *tail, st) == 0
        torch.cuda.synchronize()
        assert not torch.isnan(out).any()
        return out

    p = (lpb.data_ptr(), lpe.data_ptr())
    assert torch.equal(run(lib.w2vs_lattice_warp_alphas, *p),
                       run(lib.w2vs_transducer_alphas, *p))
    block = run(lib.w2vs_transducer_betas, *p, al32.data_ptr(),
                ll32.data_ptr())
    for lens in ((al32, ll32), (al, ll)):
        args = [x for n in lens for x in (n.data_ptr(),
                                          int(n.dtype == torch.int64))]
        assert torch.equal(run(lib.w2vs_lattice_warp_betas, *p, *args),
                           block)
    coef = [torch.rand((3, T, U), device=cuda) for _ in range(3)]
    c = [x.data_ptr() for x in coef]
    for rev in (0, 1):
        assert _rel(run(lib.w2vs_lattice_warp_affine_rows, *c, tail=(rev,)),
                    run(lib.w2vs_transducer_affine_rows, *c,
                        tail=(rev,))) <= 1e-6


@pytest.mark.parametrize("U", [33, 257])
def test_beta_rows_past_act_len(cuda, U):
    """The rows t >= T_b of beta are the virtual row passed down (0 at
    u = U_b, BLOCK-sized elsewhere), as the twin has them; at t = T_b - 1
    the gradient reads row T_b through beta_down, and the blank posterior
    exp(min(beta_down + blank - beta, 0)) it gives matches the twin's."""
    T = 8
    lpb, lpe, al, ll, dv, valid = _walk_problem(cuda, T, U, seed=2)
    be, _ = kernels.betas_and_expected_delay_bwd(lpb, lpe, al, ll, dv)
    b_t, lp_b_eff, t_valid, _ = lattice.betas(lpb, lpe, al, ll)
    for b in range(3):
        Tb, Ub = int(al[b]), int(ll[b])
        for t in range(Tb, T):
            assert be[b, t, Ub] == 0
            assert (be[b, t, :Ub] < -1e8).all()
    down = lattice.beta_shifts(be, ll)[0]
    down_t = lattice.beta_shifts(b_t, ll)[0]
    pb, pb_t = (torch.exp(torch.clamp(d + lp_b_eff - x, max=0.0))
                for d, x in ((down, be), (down_t, b_t)))
    assert _rel(pb, pb_t, valid) <= 5e-5


@pytest.mark.parametrize("T", [8, 64])
def test_loss_and_grad_on_the_block_set_match_float64_twins(cuda, T):
    """Past the warp set's U the loss runs the block set's fused walks.  At
    U 300 (299 labels) the delay and d/dacts against the float64 twins must
    be within twice the f32 twins' own error (the walks normalise each
    cell's transition probabilities; forming them from the stored alpha,
    as the twins do, put the delay 9.7x further from float64 than the
    twins at T 64), and inside the fixed bounds of the warp set's test
    where the twins are (at T 8 the twins themselves miss those: 299
    labels in 8 frames leave a few paths of |alpha| ~ 2000); the total
    within the fixed bound or twice the twins' error."""
    B, U, V = 2, 300, 64
    acts, labels, al, ll, dv = _lattice_problem(cuda, B, T, U, V, seed=3)
    assert kernels.lattice_path(U) == kernels.BLOCK
    walks = (kernels.alphas_and_expected_delay.path_launches[kernels.BLOCK],
             kernels.betas_and_expected_delay_bwd.path_launches[
                 kernels.BLOCK])

    def run(a):
        a = a.detach().clone().requires_grad_(True)
        total, _, delay = analytic.delay_transducer_loss(
            a, labels.to(a.device), al.to(a.device), ll.to(a.device),
            dv.to(a.device))
        total.sum().backward()
        return [x.detach().cpu().double() for x in (total, delay, a.grad)]

    want = run(acts.cpu().double())

    def errs(got):
        return [((got[0] - want[0]).abs() / (1 + want[0].abs())).max(),
                ((got[1] - want[1]).abs() / (1 + want[1].abs())).max(),
                (got[2] - want[2]).abs().max() / want[2].abs().max()]

    ceiling = (1e-5, 2e-3, 5e-3)
    twin = errs(run(acts.cpu()))
    if T == 64:
        assert all(t <= c for t, c in zip(twin, ceiling))
    bound = [min(c, max(b, t)) for b, t, c in zip((1e-5, 5e-4, 1e-3), twin,
                                                  ceiling)]
    got = errs(run(acts))
    assert all(e <= b for e, b in zip(got, bound)), (got, bound)
    assert got[0] <= max(1e-5, 2 * twin[0]), (got, twin)
    assert got[1] <= 2 * twin[1], (got, twin)
    assert got[2] <= 2 * twin[2], (got, twin)
    assert (kernels.alphas_and_expected_delay.path_launches[kernels.BLOCK],
            kernels.betas_and_expected_delay_bwd.path_launches[
                kernels.BLOCK]) == (walks[0] + 1, walks[1] + 1)


def test_training_kernels_reject(cuda):
    lp = torch.zeros((2, 5, 4), device=cuda)
    with pytest.raises(ValueError):
        kernels.alphas(lp.double(), lp.double())
    with pytest.raises(ValueError):
        kernels.alphas(lp.transpose(1, 2).contiguous().transpose(1, 2), lp)
    with pytest.raises(ValueError):
        hw_dropout(lp, 1.0, 0, 0)
    lens = torch.tensor([5, 4], device=cuda)
    with pytest.raises(ValueError):      # lengths on the host
        kernels.betas_and_expected_delay_bwd(lp, lp, lens.cpu(), lens, lp)
    with pytest.raises(ValueError):      # float lengths
        kernels.betas(lp, lp, lens.float(), lens)
    with pytest.raises(ValueError):      # float64 delay values
        kernels.alphas_and_expected_delay(lp, lp, lp.double())


def test_tiny_train_step_on_cuda_equals_cpu(cuda):
    """Dropout off: two updates on the card (kernels) equal the CPU's
    (twins): loss rtol 1e-5, grad norm rtol 1e-4, params atol 1e-5."""
    from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
    from wav2vec_s_tpu_torch.train.recipes import make_caat_loss_fn
    from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

    w2v = dataclasses.replace(W2V_TINY, dropout=0.0, attention_dropout=0.0,
                              encoder_layerdrop=0.0)
    caat = dataclasses.replace(CAAT_TINY, dropout=0.0, attention_dropout=0.0,
                               activation_dropout=0.0, rand_pos_decoder=0,
                               transducer_downsample=8, tokens_per_step=200)
    cfg = OptimConfig(lr=1e-3, clip_norm=2.0, lr_scheduler="inverse_sqrt",
                      warmup_updates=2)
    g = torch.Generator().manual_seed(0)
    src = torch.randn((3, 2400), generator=g)
    tgt = torch.randint(4, caat.vocab_size, (3, 6), generator=g)
    tgt[:, -1] = caat.eos
    out = {}
    for dev in ("cpu", "cuda"):
        model = random_init_(W2V2CaatModel(w2v, caat),
                             torch.Generator().manual_seed(0)).to(dev)
        opt = build_optimizer(cfg)
        state = TrainState.create(model, opt)
        step = make_train_step(make_caat_loss_fn(model, caat), opt)
        logs = [step(state, {"source": src.to(dev), "targets": tgt.to(dev)},
                     torch.Generator().manual_seed(0))[1] for _ in range(2)]
        out[dev] = ([(float(x["loss_total"]), float(x["grad_norm"]))
                     for x in logs],
                    {k: v.cpu() for k, v in model.state_dict().items()})
    for (lc, gc), (lg, gg) in zip(out["cpu"][0], out["cuda"][0]):
        assert abs(lc - lg) <= 1e-5 * abs(lc)
        assert abs(gc - gg) <= 1e-4 * gc
    for k, v in out["cpu"][1].items():
        assert (v - out["cuda"][1][k]).abs().max() <= 1e-2 * cfg.lr, k


SEED, OFFSET = 0x1234_5678_9ABC_DEF, 5


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("D,H,T,mc,rc", [
    (24, 4, 97, 4, 2),            # dh 6, S 145: a Philox block per element
    (768, 12, 500, 16, 8),        # dh 64, S 748: the training call
    (256, 2, 64, 8, 0),           # dh 128, the widest head, no copies
    # the edges of the tensor-core kernels (bfloat16): dh 32 at S 145 (a
    # Philox block per element, ragged last tile), dh 64 with a padded
    # stream at S 144, dh 128 (row operands reloaded from shared memory)
    # with copies
    (64, 2, 97, 16, 8), (128, 2, 96, 16, 8), (256, 2, 200, 16, 8)])
def test_flash_backward_kernel_matches_twin(cuda, dtype, tol, rate, D, H, T,
                                            mc, rc):
    """K3 against ``blockwise_flash_attention_bwd_ref`` on the forward
    kernel's own out, m, l: dQ on valid rows, dK and dV everywhere, max
    |diff| over the largest gradient entry; the cotangent is zero on padded
    rows (callers strip them); two runs are bit-identical (no atomics).
    bfloat16 with heads of 32, 64 or 128 runs the tensor-core kernels."""
    q, k, v, pad = _flash_inputs(cuda, dtype, 2, T, mc, rc, D)
    valid = ~pad
    do = torch.randn(q.shape, device=cuda).to(dtype) * valid[:, :, None]
    lay = (pad, H, T, mc, rc, rate)
    out, m, l = blockwise_flash_attention_packed(q, k, v, *lay, True, SEED,
                                                 OFFSET)
    path = kernel_path(dtype, D // H)
    before = blockwise_flash_attention_bwd.launches
    on_path = blockwise_flash_attention_bwd.path_launches[path]
    got = blockwise_flash_attention_bwd(q, k, v, out, do, m, l, *lay, SEED,
                                        OFFSET)
    torch.cuda.synchronize()
    assert blockwise_flash_attention_bwd.launches == before + 1
    assert blockwise_flash_attention_bwd.path_launches[path] == on_path + 1
    again = blockwise_flash_attention_bwd(q, k, v, out, do, m, l, *lay, SEED,
                                          OFFSET)
    want = blockwise_flash_attention_bwd_ref(q, k, v, out, do, m, l, *lay,
                                             SEED, OFFSET)
    for i, (a, b, c) in enumerate(zip(got, want, again)):
        assert a.dtype == dtype and a.shape == q.shape
        assert torch.equal(a, c)
        if i == 0:
            a, b = a[valid], b[valid]
        assert torch.isfinite(a).all()
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert err.item() <= tol, (i, err.item())


# float32 with heads of S dims: the CUDA-core kernels; bfloat16 with heads of
# 64 or 128 dims (the identity padded with zero columns): the tensor-core
# kernels, whose fragments hold the mask in another arrangement
@pytest.mark.parametrize("dtype,dh", [(torch.float32, None),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128)])
@pytest.mark.parametrize("T,mc,rc", [(32, 8, 4), (33, 8, 4)])   # S % 4: 0, 1
def test_flash_dropout_masks_forward_equals_backward_on_the_card(cuda, T, mc,
                                                                 rc, dtype,
                                                                 dh):
    """The mask read back through the forward kernel (v = identity per
    head) is bit-equal to the twin's and to the one the backward kernels
    regenerate (dV for identity cotangents), with both Philox paths."""
    from wav2vec_s_tpu_torch.ops.dropout import keep_mask

    B, H, rate = 2, 3, 0.25
    S = block_layout(T, mc, rc).total_len
    dh = dh or S
    path = kernel_path(dtype, dh)
    assert path == (CUDA_CORE if dtype == torch.float32 else TENSOR_CORE)
    q = k = torch.zeros((B, S, H * dh), device=cuda, dtype=dtype)
    v = torch.eye(S, dh, device=cuda, dtype=dtype).repeat(B, 1, H)
    pad = torch.zeros((B, S), dtype=torch.bool, device=cuda)
    lay = (pad, H, T, mc, rc, rate)
    counts = (blockwise_flash_attention_packed.path_launches[path],
              blockwise_flash_attention_bwd.path_launches[path])
    out, m, l = blockwise_flash_attention_packed(q, k, v, *lay, True, SEED,
                                                 OFFSET)
    dv = blockwise_flash_attention_bwd(q, k, v, out, v, m, l, *lay, SEED,
                                       OFFSET)[2]
    assert (blockwise_flash_attention_packed.path_launches[path],
            blockwise_flash_attention_bwd.path_launches[path]) == (
                counts[0] + 1, counts[1] + 1)
    fwd = out.reshape(B, S, H, dh)[..., :S].transpose(1, 2) != 0  # [B,H,q,k]
    bwd = dv.reshape(B, S, H, dh)[..., :S].transpose(1, 2).transpose(
        2, 3) != 0
    allowed = torch.as_tensor(block_layout(T, mc, rc).allowed, device=cuda)
    want = keep_mask(B * H * S * S, rate, SEED, OFFSET, cuda).reshape(
        B, H, S, S) & allowed
    assert torch.equal(fwd, want) and torch.equal(bwd, want)
    assert not torch.equal(fwd[0], fwd[1])                    # batch slots
    assert not torch.equal(fwd[:, 0], fwd[:, 1])              # heads


@pytest.mark.parametrize("dtype,dh", [(torch.float32, None),
                                      (torch.bfloat16, 64)])
@pytest.mark.parametrize("T,mc,rc", [(32, 8, 4), (33, 8, 4)])   # S % 4: 0, 1
def test_flash_dropout_row_base_on_the_card(cuda, T, mc, rc, dtype, dh):
    """A data-parallel shard (rows 1: of 3, ``dropout_row0`` 1): the masks
    the forward and backward kernels draw are rows 1: of the whole
    batch's, with both Philox paths (S % 4 == 0 and not)."""
    from wav2vec_s_tpu_torch.ops.dropout import keep_mask

    B, H, rate, r0 = 3, 2, 0.25, 1
    S = block_layout(T, mc, rc).total_len
    dh = dh or S
    q = k = torch.zeros((B - r0, S, H * dh), device=cuda, dtype=dtype)
    v = torch.eye(S, dh, device=cuda, dtype=dtype).repeat(B - r0, 1, H)
    pad = torch.zeros((B - r0, S), dtype=torch.bool, device=cuda)
    lay = (pad, H, T, mc, rc, rate)
    out, m, l = blockwise_flash_attention_packed(
        q, k, v, *lay, True, SEED, OFFSET, dropout_row0=r0)
    dv = blockwise_flash_attention_bwd(q, k, v, out, v, m, l, *lay, SEED,
                                       OFFSET, r0)[2]
    fwd = out.reshape(B - r0, S, H, dh)[..., :S].transpose(1, 2) != 0
    bwd = dv.reshape(B - r0, S, H, dh)[..., :S].transpose(1, 2).transpose(
        2, 3) != 0
    allowed = torch.as_tensor(block_layout(T, mc, rc).allowed, device=cuda)
    want = keep_mask(B * H * S * S, rate, SEED, OFFSET, cuda).reshape(
        B, H, S, S)[r0:] & allowed
    assert torch.equal(fwd, want) and torch.equal(bwd, want)


@pytest.mark.parametrize("dtype,dh", [(torch.float32, None),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128)])
@pytest.mark.parametrize("T,mc,rc", [(32, 8, 4), (33, 8, 4)])   # S % 4: 0, 1
@pytest.mark.parametrize("r0,h0,heads", [(1, 2, 5), (0, 3, 5), (0, 0, 2)])
def test_flash_dropout_head_base_on_the_card(cuda, T, mc, rc, dtype, dh, r0,
                                             h0, heads):
    """A tensor-parallel rank's heads [h0, h0 + 2) of ``heads`` (with a
    data-parallel shard's rows 1: of 3 in one case): the masks the forward
    and backward kernels draw are those heads (and rows) of the whole
    batch's, bit-equal to the twins'; with h0 0 and ``heads`` = H (the
    defaults) the output is bit-equal to the call without them."""
    from wav2vec_s_tpu_torch.ops.dropout import keep_mask
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        blockwise_flash_attention_bwd_ref, blockwise_flash_attention_ref)

    B, H, rate = 3, 2, 0.25
    S = block_layout(T, mc, rc).total_len
    dh = dh or S
    q = k = torch.zeros((B - r0, S, H * dh), device=cuda, dtype=dtype)
    v = torch.eye(S, dh, device=cuda, dtype=dtype).repeat(B - r0, 1, H)
    pad = torch.zeros((B - r0, S), dtype=torch.bool, device=cuda)
    lay = (pad, H, T, mc, rc, rate)
    drop = dict(dropout_row0=r0, dropout_h0=h0, dropout_heads=heads)
    out, m, l = blockwise_flash_attention_packed(q, k, v, *lay, True, SEED,
                                                 OFFSET, **drop)
    dv = blockwise_flash_attention_bwd(q, k, v, out, v, m, l, *lay, SEED,
                                       OFFSET, r0, h0, heads)[2]
    fwd = out.reshape(B - r0, S, H, dh)[..., :S].transpose(1, 2) != 0
    bwd = dv.reshape(B - r0, S, H, dh)[..., :S].transpose(1, 2).transpose(
        2, 3) != 0
    allowed = torch.as_tensor(block_layout(T, mc, rc).allowed, device=cuda)
    want = keep_mask(B * heads * S * S, rate, SEED, OFFSET, cuda).reshape(
        B, heads, S, S)[r0:, h0:h0 + H] & allowed
    assert torch.equal(fwd, want) and torch.equal(bwd, want)
    # the twins on the CPU draw the same masks
    cpu = [t.cpu() for t in (q, k, v, pad)]
    out_t = blockwise_flash_attention_ref(*cpu, H, T, mc, rc, rate, SEED,
                                          OFFSET, r0, h0, heads)[0]
    dv_t = blockwise_flash_attention_bwd_ref(
        *cpu[:3], out_t, cpu[2], m.cpu(), l.cpu(), cpu[3], H, T, mc, rc,
        rate, SEED, OFFSET, r0, h0, heads)[2]
    assert torch.equal(out_t != 0, out.cpu() != 0)
    assert torch.equal(dv_t != 0, dv.cpu() != 0)
    if (h0, heads) == (0, H):
        plain = blockwise_flash_attention_packed(
            q, k, v, *lay, False, SEED, OFFSET, dropout_row0=r0)
        assert torch.equal(plain, out)


def test_flash_autograd_on_the_card_equals_the_cpu(cuda):
    """The wrapper's autograd.Function on CUDA tensors (kernels, a
    non-contiguous cotangent) against the same on the CPU (twins), dropout
    on; under no_grad the result carries no graph."""
    q, k, v, pad = _flash_inputs(cuda, torch.float32, 2, 96, 16, 8, 64)
    w = torch.randn((q.shape[0], q.shape[2], q.shape[1]), device=cuda)
    w = w.transpose(1, 2) * (~pad)[:, :, None]                # a view
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out = blockwise_flash_attention_packed(
            *leaves, pad.to(dev), 4, 96, 16, 8, 0.2, False, SEED, OFFSET)
        grads[dev] = torch.autograd.grad(out, leaves, w.to(dev))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        assert not blockwise_flash_attention_packed(
            q.requires_grad_(True), k, v, pad, 4, 96, 16, 8).requires_grad


def test_tiny_cli_run_on_cuda_equals_cpu(cuda, tmp_path):
    """Four updates through the training entry point, flash attention,
    dropout off, a validation and a checkpoint: the parameters saved by the
    run on the card equal the CPU run's (atol 1e-2 * lr)."""
    from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
    from wav2vec_s_tpu_torch.data.audio import write_wav
    from wav2vec_s_tpu_torch.train import cli

    rng = np.random.default_rng(0)
    lines = ["id\taudio\tn_frames\ttgt_text"]
    words = [f"w{i}" for i in range(20)]
    for i in range(6):
        n = 1920 + 320 * i
        write_wav(tmp_path / f"u{i}.wav",
                  rng.standard_normal(n).astype(np.float32) * 0.1)
        text = " ".join(rng.choice(words, 3))
        lines.append(f"u{i}\t{tmp_path}/u{i}.wav\t{n}\t{text}")
    (tmp_path / "train.tsv").write_text("\n".join(lines) + "\n")
    (tmp_path / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    lr = 1e-3
    saved = {}
    for dev in ("cpu", "cuda"):
        cli.main([
            "--device", dev, "run.task=caat",
            f"run.save_dir={tmp_path}/ckpt_{dev}", "run.max_update=4",
            "run.log_interval=2", "run.validate_interval_updates=4",
            f"data.train_manifest={tmp_path}/train.tsv",
            f"data.valid_manifest={tmp_path}/train.tsv",
            f"data.vocab={tmp_path}/dict.txt", "data.max_tokens=7100",
            "data.max_sample_size=3840", f"optim.lr={lr}",
            "optim.lr_scheduler=inverse_sqrt", "optim.warmup_updates=2",
            "optim.clip_norm=2.0", "context.main_context=4",
            "context.right_context=2",
            "model.conv_feature_layers=((16,10,5),(16,3,2),(16,2,2))",
            "model.encoder_layers=2", "model.encoder_embed_dim=24",
            "model.encoder_ffn_embed_dim=48",
            "model.encoder_attention_heads=4", "model.attention_impl=flash",
            "model.dropout=0.0", "model.attention_dropout=0.0",
            "model.encoder_layerdrop=0.0", "caat.decoder_layers=2",
            "caat.decoder_embed_dim=24", "caat.decoder_ffn_embed_dim=48",
            "caat.decoder_attention_heads=4", "caat.jointer_layers=2",
            "caat.jointer_embed_dim=24", "caat.jointer_ffn_embed_dim=48",
            "caat.jointer_attention_heads=4", "caat.transducer_downsample=8",
            "caat.decision_steps=(4,8)", "caat.tokens_per_step=500",
            "caat.dropout=0.0", "caat.attention_dropout=0.0",
            "caat.activation_dropout=0.0", "caat.rand_pos_decoder=0"])
        saved[dev], meta = CheckpointManager(
            tmp_path / f"ckpt_{dev}").restore()
        assert saved[dev]["step"] == 4 and meta["step"] == 4
    for k, v in saved["cpu"]["model"].items():
        assert (v - saved["cuda"]["model"][k]).abs().max() <= 1e-2 * lr, k


# --- the beam quality path (stream/beam_batched.py) ---

from wav2vec_s_tpu_torch.models.feature_extractor import (  # noqa: E402
    conv_receptive_stride)
from wav2vec_s_tpu_torch.stream import beam_batched  # noqa: E402

BEAM_KW = dict(beam_size=3, inter_beam=1, max_steps=5, max_len=64,
               eager=True, t_cap=64)


def _grid_wavs(chunks, seed=0):
    """Seeded noise of ``n * main_context + right_context`` frames each."""
    rf, hop = conv_receptive_stride(W2V_TINY.conv_feature_layers)
    mc, rc = W2V_TINY.main_context, W2V_TINY.right_context
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n * mc + rc - 1) * hop + rf).astype(
        np.float32) * 0.1 for n in chunks]


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("name", [
    "BatchedBeamStreamingDecoder", "OneShotBeamDecoder",
    "FusedBeamStreamingDecoder", "FusedOneShotBeamDecoder"])
def test_tiny_beam_decode_on_cuda_equals_cpu(cuda, name, blocks):
    """Mixed lengths, int16 wire for the fused decoders; the streaming
    decoders launch the chunk-attention kernel once per layer and chunk,
    the one-shot ones the flash kernel once per layer (one sub-batch)."""
    oneshot = "OneShot" in name
    w2v = dataclasses.replace(W2V_TINY,
                              attention_impl="flash" if oneshot else "dense")
    vocab, model, _ = _tiny(w2v)
    wavs = _grid_wavs((6, 4, 6, 3))
    out = {}
    for dev in ("cpu", "cuda"):
        dec = getattr(beam_batched, name)(model.to(dev), vocab, w2v,
                                          blocks_per_step=blocks, **BEAM_KW)
        dec.transfer_dtype = "int16"
        before = (chunk_cache_attention.launches,
                  blockwise_flash_attention_packed.launches)
        out[dev] = dec.decode_corpus(wavs)
        k1 = chunk_cache_attention.launches - before[0]
        k2 = blockwise_flash_attention_packed.launches - before[1]
        if dev == "cpu":
            assert (k1, k2) == (0, 0)
        elif oneshot:
            assert (k1, k2) == (0, w2v.encoder_layers)
        else:
            assert (k1, k2) == (w2v.encoder_layers * (6 // blocks), 0)
    assert out["cuda"] == out["cpu"]
    assert min(len(d) for d in out["cuda"][1]) > 0


@pytest.mark.parametrize("value", [float("-inf"), 0.25])
def test_ties_take_the_lowest_index_on_the_card(cuda, value):
    x = torch.full((4, 5, 300), value, device=cuda)
    assert not x.argmax(-1).any()
    x[..., 130] = x[..., 7] = 1.0
    assert (x.argmax(-1) == 7).all()
    flat = x.reshape(20, 300)
    want = torch.tensor([7, 130, 0, 1, 2], device=cuda).expand(20, 5)
    assert torch.equal(torch.sort(flat, dim=1, descending=True,
                                  stable=True)[1][:, :5], want)
    assert torch.equal(torch.argsort(-flat, dim=1, stable=True)[:, :5], want)
    # past a row's last finite value the hierarchical picks are -inf and
    # their indices carry no meaning
    n = 5 if value > 0 else 2
    got = beam_batched._top_b_per_row(x, 5)[1]
    assert torch.equal(got[..., :n], want.reshape(4, 5, 5)[..., :n])


# the pre-training call: 628 frames (a 200960-sample crop, padded to the
# seq multiple) under each (mc, rc) bucket of the sampled-context schedule
PRETRAIN_BUCKETS = ((8, 4), (12, 6), (16, 8), (20, 8), (24, 12), (28, 12),
                    (32, 16))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mc,rc", PRETRAIN_BUCKETS)
def test_flash_kernels_at_the_pretraining_buckets(cuda, mc, rc, rate):
    """K2 and K3 on the tensor-core kernels (bfloat16, 12 heads of 64) at
    the pre-training length under every context bucket (S 876-940, partial
    tiles everywhere, padded keys) against their twins: forward on valid
    rows atol 2e-2, dQ / dK / dV max |diff| over the largest entry 1e-2."""
    T = 628
    q, k, v, pad = _flash_inputs(cuda, torch.bfloat16, 2, T, mc, rc, 768)
    valid = ~pad
    do = torch.randn(q.shape, device=cuda).to(q.dtype) * valid[:, :, None]
    lay = (pad, 12, T, mc, rc, rate)
    before = dict(blockwise_flash_attention_bwd.path_launches)
    out, m, l = blockwise_flash_attention_packed(q, k, v, *lay, True, SEED,
                                                 OFFSET)
    got = blockwise_flash_attention_bwd(q, k, v, out, do, m, l, *lay, SEED,
                                        OFFSET)
    torch.cuda.synchronize()
    assert blockwise_flash_attention_bwd.path_launches[TENSOR_CORE] == (
        before[TENSOR_CORE] + 1)
    want, _, _ = blockwise_flash_attention_ref(q, k, v, *lay, SEED, OFFSET)
    err = (out[valid].float() - want[valid].float()).abs().max().item()
    assert err <= 2e-2, err
    ref = blockwise_flash_attention_bwd_ref(q, k, v, out, do, m, l, *lay,
                                            SEED, OFFSET)
    for i, (a, b) in enumerate(zip(got, ref)):
        if i == 0:
            a, b = a[valid], b[valid]
        assert torch.isfinite(a).all()
        e = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert e.item() <= 1e-2, (i, e.item())


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_tiny_pretrain_two_updates_on_cuda_equal_cpu(cuda, impl):
    """Tiny wav2vec-S pre-training, float32, dropout off: two updates on
    the card equal the CPU's (loss rtol 1e-5, grad norm rtol 1e-4, params
    atol 1e-2 lr); the draws (negatives, Gumbel uniforms) come from one CPU
    generator in both runs."""
    from wav2vec_s_tpu_torch.models import Wav2Vec2Model
    from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
    from wav2vec_s_tpu_torch.train.recipes import make_pretrain_loss_fn
    from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

    w2v = dataclasses.replace(
        W2V_TINY, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
        attention_impl=impl, dropout=0.0, attention_dropout=0.0,
        encoder_layerdrop=0.0, dropout_input=0.0, dropout_features=0.0,
        final_dim=16, latent_vars=8, n_negatives=10)
    cfg = OptimConfig(lr=1e-3, lr_scheduler="inverse_sqrt", warmup_updates=2)
    g = torch.Generator().manual_seed(0)
    src = torch.randn((3, 2400), generator=g)
    pos = torch.stack([torch.randperm(119, generator=g)[:56].sort().values
                       for _ in range(3)])
    out = {}
    for dev in ("cpu", "cuda"):
        model = random_init_(Wav2Vec2Model(w2v, pretraining=True),
                             torch.Generator().manual_seed(0)).to(dev)
        opt = build_optimizer(cfg)
        state = TrainState.create(model, opt)
        step = make_train_step(make_pretrain_loss_fn(model, 8, 4), opt)
        logs = [step(state, {"source": src.to(dev),
                             "mask_positions": pos.to(dev)},
                     torch.Generator().manual_seed(i))[1] for i in range(2)]
        out[dev] = ([(float(x["loss_total"]), float(x["grad_norm"]))
                     for x in logs],
                    {k: v.cpu() for k, v in model.state_dict().items()})
    for (lc, gc), (lg, gg) in zip(out["cpu"][0], out["cuda"][0]):
        assert abs(lc - lg) <= 1e-5 * abs(lc)
        assert abs(gc - gg) <= 1e-4 * gc
    for k, v in out["cpu"][1].items():
        assert (v - out["cuda"][1][k]).abs().max() <= 1e-2 * cfg.lr, k


# -- the offline-ASR heads (models/asr.py, eval/generator.py) ----------------

@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kind,infeasible", [("ctc", False), ("ctc", True),
                                             ("s2s", False)])
def test_tiny_asr_loss_and_grads_on_cuda_equal_cpu(cuda, kind, infeasible,
                                                   impl):
    """The CTC (with a row whose labels cannot fit: optax's floor) and
    seq2seq recipes' loss and every gradient on the card against the CPU
    (``tools/asr_parity.py``: its tolerances)."""
    from wav2vec_s_tpu_torch.tools import asr_parity as ap

    cpu, card = (ap.loss_and_grads(kind, impl, infeasible, dev)
                 for dev in ("cpu", "cuda"))
    rel, worst = ap.gap(cpu, card)
    assert rel <= ap.LOSS_RTOL and worst <= 1.0, (rel, worst)
    if infeasible:
        assert ap.FLOOR[0] < cpu[0] < ap.FLOOR[1]


@pytest.mark.parametrize("kind", ["ctc", "s2s", "transducer"])
def test_tiny_asr_greedy_decoders_on_cuda_equal_cpu(cuda, kind):
    """The three batched greedy decoders (flash encode) give the same ids on
    the card as on the CPU."""
    from wav2vec_s_tpu_torch.tools import asr_parity as ap

    for a, b in zip(ap.greedy(kind, "cpu"), ap.greedy(kind, "cuda")):
        np.testing.assert_array_equal(a, b)


def test_tiny_beam_generator_on_cuda_equals_cpu(cuda):
    from wav2vec_s_tpu_torch.tools import asr_parity as ap

    cpu, card = ap.beam("cpu"), ap.beam("cuda")
    assert [h.tokens for h in card] == [h.tokens for h in cpu]
    np.testing.assert_allclose([h.score for h in card],
                               [h.score for h in cpu], rtol=1e-5)


def _family_id(case):
    family, frontend, jointer = case
    return family if frontend is None else f"{frontend}-{jointer}"


def _family_cases():
    from wav2vec_s_tpu_torch.tools import family_parity as fp

    return fp.CASES


@pytest.mark.parametrize("case", _family_cases(), ids=_family_id)
def test_tiny_family_loss_and_grads_on_cuda_equal_cpu(cuda, case):
    """The fbank (each front-end x jointer) and text CAAT recipes with
    their dropouts on: loss and every gradient on the card against the CPU
    (``tools/family_parity.py``; ``asr_parity``'s tolerances)."""
    from wav2vec_s_tpu_torch.ops.dropout import hw_dropout
    from wav2vec_s_tpu_torch.tools import family_parity as fp

    cpu = fp.loss_and_grads(*case, "cpu")
    before = hw_dropout.launches
    card = fp.loss_and_grads(*case, "cuda")
    assert hw_dropout.launches > before
    rel, worst = fp.gap(cpu, card)
    assert rel <= fp.LOSS_RTOL and worst <= 1.0, (rel, worst)


def test_tiny_fbank_agent_on_cuda_equals_cpu(cuda):
    from wav2vec_s_tpu_torch.tools import family_parity as fp

    cpu, card = fp.agent("cpu"), fp.agent("cuda")
    assert card == cpu and any(text for text, _ in card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["fbank", "text"])
def test_dropout_kernel_at_the_family_sites(cuda, family, dtype):
    """K4 bit-equal to its twin (output and mask) at every dropout site
    of the family's tiny training forward (shallow2d / MHA for fbank)."""
    from wav2vec_s_tpu_torch.ops.dropout import (
        dropout_ref, hw_dropout, keep_mask)
    from wav2vec_s_tpu_torch.tools import family_parity as fp

    sites = fp.dropout_sites(family, *(("shallow2d", "mha")
                                       if family == "fbank" else (None,
                                                                  None)))
    assert len(sites) >= 5
    g = torch.Generator(device=cuda).manual_seed(3)
    for offset, (shape, p) in enumerate(sorted(sites)):
        x = torch.randn(shape, generator=g, device=cuda).to(dtype)
        got = hw_dropout(x, p, 0xABCDEF, offset)
        assert torch.equal(got, dropout_ref(x, p, 0xABCDEF, offset)), shape
        mask = hw_dropout(torch.ones_like(x), p, 0xABCDEF, offset) != 0
        assert torch.equal(mask.reshape(-1), keep_mask(
            x.numel(), p, 0xABCDEF, offset, cuda)), shape


# ---- the full-context encoder and the simultaneous baselines --------------

@pytest.mark.parametrize("kind, impl, noise", [
    ("waitk", "dense", False), ("waitk", "flash", False),
    ("mma", "dense", False), ("mma", "flash", False),
    ("mma", "dense", True), ("mma", "flash", True)])
def test_tiny_baseline_loss_and_grads_on_cuda_equal_cpu(cuda, kind, impl,
                                                        noise):
    """The wait-k and MMA training loss (dropouts on; MMA's energy noise
    drawn from the step generator, or none) and every gradient on the card
    against the CPU (``tools/baseline_parity.py``; ``asr_parity``'s
    tolerances); K4 launches, and under flash K2 and K3."""
    from wav2vec_s_tpu_torch.ops.dropout import hw_dropout
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        blockwise_flash_attention_bwd, blockwise_flash_attention_packed)
    from wav2vec_s_tpu_torch.tools import baseline_parity as bp

    cpu = bp.loss_and_grads(kind, impl, "cpu", noise)
    counters = (hw_dropout, blockwise_flash_attention_packed,
                blockwise_flash_attention_bwd)
    before = [f.launches for f in counters]
    card = bp.loss_and_grads(kind, impl, "cuda", noise)
    ran = [f.launches - b for f, b in zip(counters, before)]
    assert ran[0] > 0 and (min(ran[1:]) > 0) == (impl == "flash"), ran
    rel, worst = bp.gap(cpu, card)
    assert rel <= bp.LOSS_RTOL and worst <= 1.0, (rel, worst)


@pytest.mark.parametrize("encoder_type", ["full", "blockwise"])
def test_tiny_group_norm_model_on_cuda_equals_cpu(cuda, encoder_type):
    """The group-norm wav2vec 2.0 model on the full-context and the
    blockwise encoder: ``extract_features`` and the pre-training loss with
    every gradient, the card against the CPU."""
    from wav2vec_s_tpu_torch.tools import baseline_parity as bp

    (lc, gc, fc), (lg, gg, fg) = (bp.full_context(dev, encoder_type)
                                  for dev in ("cpu", "cuda"))
    torch.testing.assert_close(fg, fc, rtol=1e-5, atol=1e-5)
    rel, worst = bp.gap((lc, gc), (lg, gg))
    assert rel <= bp.LOSS_RTOL and worst <= 1.0, (rel, worst)


def test_tiny_hard_decode_step_on_cuda_equals_cpu(cuda):
    from wav2vec_s_tpu_torch.tools import baseline_parity as bp

    (lc, nc), (lg, ng) = bp.hard_step("cpu"), bp.hard_step("cuda")
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=1e-5)
    assert torch.equal(ng, nc)


def test_tiny_baseline_agents_on_cuda_equal_cpu(cuda):
    """``WaitkAgent`` and ``MMAStreamingAgent``: the same words and delays
    on the card as on the CPU."""
    from wav2vec_s_tpu_torch.tools import baseline_parity as bp

    cpu, card = bp.agents("cpu"), bp.agents("cuda")
    assert card == cpu and all(text for _, text, _ in card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["waitk", "mma"])
def test_dropout_kernel_at_the_baseline_sites(cuda, kind, dtype):
    """K4 bit-equal to its twin (output and mask) at every dropout site of
    the baseline's tiny training forward."""
    from wav2vec_s_tpu_torch.ops.dropout import (
        dropout_ref, hw_dropout, keep_mask)
    from wav2vec_s_tpu_torch.tools import baseline_parity as bp

    sites = bp.dropout_sites(kind)
    assert len(sites) >= 4        # MMA's decoder has no dropout
    g = torch.Generator(device=cuda).manual_seed(4)
    for offset, (shape, p) in enumerate(sorted(sites)):
        x = torch.randn(shape, generator=g, device=cuda).to(dtype)
        assert torch.equal(hw_dropout(x, p, 0xABCDEF, offset),
                           dropout_ref(x, p, 0xABCDEF, offset)), shape
        mask = hw_dropout(torch.ones_like(x), p, 0xABCDEF, offset) != 0
        assert torch.equal(mask.reshape(-1), keep_mask(
            x.numel(), p, 0xABCDEF, offset, cuda)), shape


def _remat_updates(policy, flat=False, extractor=False):
    """Three updates of the tiny CAAT model on the card, flash attention
    (the CUDA-core kernels at dh 6) and every dropout, layerdrop and
    position offset on -> (logs, parameters, generator state, launches of
    K2, K3, K4)."""
    from wav2vec_s_tpu_torch.ops.dropout import hw_dropout
    from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
    from wav2vec_s_tpu_torch.train.recipes import make_caat_loss_fn
    from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

    w2v = dataclasses.replace(W2V_TINY, attention_impl="flash",
                              encoder_layerdrop=0.3, feature_grad_mult=0.1,
                              remat_extractor=extractor)
    caat = dataclasses.replace(CAAT_TINY, dropout=0.1, attention_dropout=0.1,
                               activation_dropout=0.1, rand_pos_decoder=4,
                               transducer_downsample=8, tokens_per_step=200)
    model = random_init_(W2V2CaatModel(w2v, caat),
                         torch.Generator().manual_seed(0)).cuda()
    opt = build_optimizer(OptimConfig(lr=1e-3, clip_norm=2.0,
                                      lr_scheduler="polynomial_decay",
                                      warmup_updates=0, total_updates=10))
    state = TrainState.create(model, opt, flat_optimizer=flat)
    step = make_train_step(make_caat_loss_fn(model, caat), opt,
                           remat_policy=policy)
    wrappers = (blockwise_flash_attention_packed,
                blockwise_flash_attention_bwd, hw_dropout)
    before = [w.launches for w in wrappers]
    gen = torch.Generator().manual_seed(1)
    g = torch.Generator().manual_seed(0)
    logs = []
    for _ in range(3):
        src = torch.randn((3, 2400), generator=g)
        tgt = torch.randint(4, caat.vocab_size, (3, 6), generator=g)
        tgt[:, -1] = caat.eos
        state, out = step(state, {"source": src.cuda(),
                                  "targets": tgt.cuda()}, gen)
        logs.append((float(out["loss_total"]), float(out["grad_norm"]),
                     float(out["skipped"])))
    return (logs, {k: v.detach().cpu() for k, v in
                   model.named_parameters()}, gen.get_state(),
            [w.launches - b for w, b in zip(wrappers, before)])


@pytest.mark.parametrize("policy,extractor", [
    ("dots", False), ("nothing", False), ("offload_dots", False),
    ("none", True), ("nothing", True)])
def test_remat_policy_on_the_card_equals_none(cuda, policy, extractor):
    """Every policy and remat_extractor, the randomness on: the updates of
    the plain step (losses rtol 1e-5, grad norms 1e-4, parameters within
    1e-2 x lr), the generator in the same state; a recompute launches K2
    twice and K3 once."""
    logs, params, gen, (k2, k3, k4) = _remat_updates(policy,
                                                     extractor=extractor)
    logs0, params0, gen0, (k20, k30, k40) = _remat_updates("none")
    for (l, g, s), (l0, g0, s0) in zip(logs, logs0):
        assert s == s0 == 0.0
        assert abs(l - l0) <= 1e-5 * abs(l0) and abs(g - g0) <= 1e-4 * g0
    for k, v in params0.items():
        assert (params[k] - v).abs().max() <= 1e-2 * 1e-3, k
    assert torch.equal(gen, gen0)
    assert k3 == k30 > 0
    if policy == "none":
        assert (k2, k4) == (k20, k40)
    else:
        assert k2 == 2 * k20 and k4 > k40


def test_flat_optimizer_on_the_card_equals_the_tree(cuda):
    logs, params, gen, counts = _remat_updates("none", flat=True)
    logs0, params0, gen0, counts0 = _remat_updates("none")
    for (l, g, _), (l0, g0, _) in zip(logs, logs0):
        assert abs(l - l0) <= 1e-5 * abs(l0) and abs(g - g0) <= 1e-4 * g0
    for k, v in params0.items():
        assert (params[k] - v).abs().max() <= 1e-2 * 1e-3, k
    assert torch.equal(gen, gen0) and counts == counts0


def test_native_reader_builds_and_reads_on_the_card_machine(cuda, tmp_path):
    """``g++`` builds the reader there; a batch of PCM16 wavs equals the
    per-file reader bit for bit."""
    from wav2vec_s_tpu_torch.data import audio

    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((16000, 900, 12345)):
        paths.append(tmp_path / f"a{i}.wav")
        audio.write_wav(paths[-1], rng.standard_normal(n).astype(
            np.float32) * 0.3)
    for row, p in zip(audio.read_audio_batch(paths, 16000), paths):
        np.testing.assert_array_equal(row, audio.read_audio(p))
