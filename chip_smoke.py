#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printed on its own line:
  1. build   — nvcc builds the kernel library from wav2vec_s_tpu_torch/csrc
               (one nvcc per source, all started together);
  2. kernel  — the chunk-attention kernel (K1) against its plain twin at the
               main-path shapes (128 streams, 12 heads of 64, kv_cap 512,
               R 48 and 240, several t0, float32 and bfloat16), then both
               timed with CUDA events over the 15 calls of a 10-s ds2 stream;
  3. flash   — the block-sparse flash-attention kernel (K2) against its
               plain twin at the one-shot encoder's full-width call (32
               streams, T 488, mc 16, rc 8 -> S 728, 12 heads of 64, float32
               and bfloat16, padded keys; and an rc 0 layout): output on
               valid rows and the row stats m/l; then both timed per call;
  4. parity  — a tiny model decoded on the card equals the same decode on
               the CPU (plain twins), texts and delays;
  5. one-shot parity — the tiny one-shot decode (flash attention) on the
               card equals the one on the CPU and the cached decode on the
               card;
  6. full    — wav2vec-S Base + CAAT base, bfloat16, random weights from a
               seed, DECISION_STEP=2, max_emit 4, int16 wire: the cached
               agent on 128 streams of 10 s per corpus, one warm-up corpus,
               then CORPORA timed ones; K1's launch count must equal
               layers x chunks x corpora;
  7. one-shot full — the same model with attention_impl="flash", the
               one-shot corpus decoder on 256 streams of 10 s, encode batch
               32: one warm-up corpus, then CORPORA timed ones; K2's launch
               count must equal layers x sub-batches x corpora.
Each of the two full paths runs with every launch count set to 0 just
before it and read just after.  Then the card (nvidia-smi name, power
limit), the kernel summary as JSON, and the result line.  Any failure
raises: no result line, non-zero exit.  Without a CUDA device it exits 2
at once.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

CORPORA = 3
N_STREAMS = 128
ONESHOT_STREAMS = 256
ENCODE_BATCH = 32
SECONDS = 10.0


def _counters():
    from wav2vec_s_tpu_torch.ops.chunk_attention import chunk_cache_attention
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        blockwise_flash_attention_packed)

    return {"chunk_cache_attention": chunk_cache_attention,
            "blockwise_flash_attention_packed":
                blockwise_flash_attention_packed}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip()


def _cuda_ms(fn, reps):
    import torch

    fn()                                      # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel():
    """Kernel vs twin at main-path shapes -> (max_abs_err, ms, plain_ms)."""
    import torch
    from wav2vec_s_tpu_torch.ops.chunk_attention import (
        chunk_cache_attention, chunk_cache_attention_ref)
    from wav2vec_s_tpu_torch.stream.incremental import chunk_layout

    B, H, D, kv_cap = N_STREAMS, 12, 768, 512
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(dtype, *shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def inputs(R, dtype):
        return (rand(dtype, B, R, D) * 0.125, rand(dtype, kv_cap, B, D),
                rand(dtype, kv_cap, B, D), rand(dtype, B, R, D),
                rand(dtype, B, R, D))

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = 0.0
    for blocks in (2, 10):                       # R = 48 (ds2), 240 (ds10)
        _, bias = chunk_layout(16, 8, blocks)
        R = bias.shape[0]
        bias = torch.as_tensor(bias, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            args = inputs(R, dtype)
            for t0 in (0, 32, 256, 480):
                got = chunk_cache_attention(*args, bias, t0, H)
                torch.cuda.synchronize()
                want = chunk_cache_attention_ref(*args, bias, t0, H)
                err = (got.float() - want.float()).abs().max().item()
                print(f"phase kernel: R={R} {str(dtype)[6:]} t0={t0} "
                      f"max_abs_err={err:.3g} tol={tol[dtype]:g}")
                assert err <= tol[dtype], (R, dtype, t0, err)
                worst = max(worst, err)
            del args, got, want

    # timing: the 15 calls of one 10-s ds2 stream (t0 = 32k, the cache view
    # the decoder passes at that chunk), bfloat16, mean per call
    _, bias = chunk_layout(16, 8, 2)
    bias = torch.as_tensor(bias, device=dev)
    q, kc, vc, kn, vn = inputs(bias.shape[0], torch.bfloat16)
    calls = [(32 * k, min(-(-(32 * k + (40 if k == 14 else 32)) // 256) * 256,
                          kv_cap)) for k in range(15)]

    def run(fn):
        def go():
            for t0, cap in calls:
                fn(q, kc[:cap], vc[:cap], kn, vn, bias, t0, H)
        return go

    ms = _cuda_ms(run(chunk_cache_attention), 10) / len(calls)
    plain_ms = _cuda_ms(run(chunk_cache_attention_ref), 10) / len(calls)
    print(f"phase kernel: ds2 bf16 mean per call over t0=0..448: "
          f"kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms")
    return worst, ms, plain_ms


def phase_flash():
    """K2 vs twin at the one-shot encoder's full-width call ->
    (max_abs_err, ms, plain_ms)."""
    import torch
    from wav2vec_s_tpu_torch.ops.block_mask import block_layout
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        blockwise_flash_attention_packed, blockwise_flash_attention_ref)

    B, T, mc, H, D = ENCODE_BATCH, 488, 16, 12, 768
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = 0.0
    for rc in (8, 0):
        S = block_layout(T, mc, rc).total_len
        # non-contiguous key padding of one stream: a frame tail and the
        # last rc copies (tests/test_pallas_attention.py)
        pad = torch.zeros((B, S), dtype=torch.bool, device=dev)
        pad[1, T - 10:T] = True
        pad[1, S - 3:] = True
        valid = ~pad
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((B, S, D), generator=g, device=dev)
                       .to(dtype) for _ in range(3))
            args = (q, k, v, pad, H, T, mc, rc)
            out, m, l = blockwise_flash_attention_packed(*args,
                                                         return_stats=True)
            torch.cuda.synchronize()
            want, m_want, l_want = blockwise_flash_attention_ref(*args)
            err = (out[valid].float() - want[valid].float()).abs().max()
            err = err.item()
            rows = valid[:, None, :].expand_as(m)
            stat_err = max(((a[rows] - b[rows]).abs()
                            / (1.0 + b[rows].abs())).max().item()
                           for a, b in ((m, m_want), (l, l_want)))
            print(f"phase flash: S={S} rc={rc} {str(dtype)[6:]} "
                  f"max_abs_err={err:.3g} tol={tol[dtype]:g}; m/l max "
                  f"err/(1+|x|)={stat_err:.3g} tol=1e-4")
            assert err <= tol[dtype], (rc, dtype, err)
            assert stat_err <= 1e-4, (rc, dtype, stat_err)
            worst = max(worst, err)
            del out, m, l, want, m_want, l_want

    # timing: the main path's call (rc 8, bfloat16), mean per call
    S = block_layout(T, 16, 8).total_len
    q, k, v = (torch.randn((B, S, D), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    pad = torch.zeros((B, S), dtype=torch.bool, device=dev)
    args = (q, k, v, pad, H, T, mc, 8)
    ms = _cuda_ms(lambda: blockwise_flash_attention_packed(*args), 20)
    plain_ms = _cuda_ms(lambda: blockwise_flash_attention_ref(*args), 5)
    print(f"phase flash: B={B} S={S} H={H} dh={D // H} bf16 per call: "
          f"kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms")
    return worst, ms, plain_ms


def _vocab(size):
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary

    v = Dictionary()
    for i in range(size - v.nspecial):
        v.add_symbol(f"w{i}")
    return v


def _clips(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) * 0.1 for n in lengths]


def _tiny_model(attention_impl="dense"):
    """tests/test_caat.py dims, random weights from seed 0."""
    import torch
    from wav2vec_s_tpu_torch.models import Wav2Vec2Config
    from wav2vec_s_tpu_torch.models.caat import CaatConfig, W2V2CaatModel
    from wav2vec_s_tpu_torch.models.modules import random_init_

    w2v = Wav2Vec2Config(
        conv_feature_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)),
        encoder_layers=2, encoder_embed_dim=24, encoder_ffn_embed_dim=48,
        encoder_attention_heads=4, main_context=4, right_context=2,
        attention_impl=attention_impl)
    caat = CaatConfig(
        vocab_size=30, decoder_layers=2, decoder_embed_dim=24,
        decoder_ffn_embed_dim=48, decoder_attention_heads=4,
        jointer_layers=2, jointer_embed_dim=24, jointer_ffn_embed_dim=48,
        jointer_attention_heads=4)
    model = random_init_(W2V2CaatModel(w2v, caat),
                         torch.Generator().manual_seed(0))
    return w2v, caat, model


TINY_KW = dict(max_len=256, max_emit_per_chunk=4, t_cap=640,
               blocks_per_step=2)


def phase_parity():
    """Tiny model: CUDA decode == CPU decode."""
    from wav2vec_s_tpu_torch.stream.batched import CachedFusedGreedyDecoder

    w2v, caat, model = _tiny_model()
    vocab, wavs = _vocab(caat.vocab_size), _clips((6400, 9600, 12800))
    out = {}
    for dev in ("cpu", "cuda"):
        dec = CachedFusedGreedyDecoder(model.to(dev), vocab, w2v, **TINY_KW)
        out[dev] = dec.decode_corpus(wavs)
    words = [len(d) for d in out["cuda"][1]]
    print(f"phase parity: tiny decode cuda == cpu: "
          f"{out['cuda'] == out['cpu']} (words per stream {words})")
    assert out["cuda"] == out["cpu"]
    assert sum(words) > 0


def phase_oneshot_parity():
    """Tiny model, flash attention (dh 6): the one-shot decode on CUDA ==
    on the CPU == the cached decode on CUDA."""
    from wav2vec_s_tpu_torch.stream.batched import (
        CachedFusedGreedyDecoder, OneShotCorpusDecoder)

    w2v, caat, model = _tiny_model("flash")
    vocab, wavs = _vocab(caat.vocab_size), _clips((6400, 9600, 12800))
    out = {}
    for dev in ("cpu", "cuda"):
        dec = OneShotCorpusDecoder(model.to(dev), vocab, w2v, **TINY_KW)
        out[dev] = dec.decode_corpus(wavs)
    cached = CachedFusedGreedyDecoder(model, vocab, w2v, **TINY_KW)
    out["cached"] = cached.decode_corpus(wavs)
    words = [len(d) for d in out["cuda"][1]]
    print(f"phase one-shot parity: tiny one-shot cuda == cpu: "
          f"{out['cuda'] == out['cpu']}, == cached cuda: "
          f"{out['cuda'] == out['cached']} (words per stream {words})")
    assert out["cuda"] == out["cpu"] == out["cached"]
    assert sum(words) > 0


def _base_model(dev, attention_impl="dense"):
    from wav2vec_s_tpu_torch.models import wav2vec_s_base_config
    from wav2vec_s_tpu_torch.models.caat import (
        W2V2CaatModel, caat_base_config)
    from wav2vec_s_tpu_torch.models.modules import random_init_
    import torch

    w2v = wav2vec_s_base_config(dtype="bfloat16",
                                attention_impl=attention_impl)
    caat = caat_base_config(dtype="bfloat16")
    with dev:
        model = W2V2CaatModel(w2v, caat)
    random_init_(model, torch.Generator(device=dev).manual_seed(0))
    return w2v, caat, model


def _timed_corpora(dec, wavs):
    """CORPORA timed decodes, staging corpus k+1 before decoding corpus k
    (bench.py's pattern); returns (times, last texts, last delays)."""
    staged = dec.stage(wavs)
    times = []
    for i in range(CORPORA):
        t = time.perf_counter()
        nxt = dec.stage(wavs) if i + 1 < CORPORA else None
        texts, delays = dec.decode_corpus(staged)
        times.append(time.perf_counter() - t)
        staged = nxt
    return times, texts, delays


def phase_full(card):
    """Base + CAAT base, bf16, the cached greedy agent at ds2."""
    import torch
    from wav2vec_s_tpu_torch.stream import caat_step
    from wav2vec_s_tpu_torch.stream.batched import CachedFusedGreedyDecoder

    dev = torch.device("cuda")
    t = time.perf_counter()
    w2v, caat, model = _base_model(dev)
    S = int(SECONDS * 16000)
    frames = (S - 400) // 320 + 1
    t_cap = -(-(frames + w2v.right_context) // 128) * 128       # 512
    dec = CachedFusedGreedyDecoder(model, _vocab(caat.vocab_size), w2v,
                                   max_len=256, max_emit_per_chunk=4,
                                   t_cap=t_cap, blocks_per_step=2)
    dec.transfer_dtype = "int16"
    wavs = _clips([S] * N_STREAMS)
    print(f"phase full: model + decoder ready in "
          f"{time.perf_counter() - t:.1f} s")
    dec.decode_corpus(wavs)                                     # warm-up

    enc = dec._encoder(N_STREAMS)
    n_chunks = max((frames - w2v.right_context) // enc.n_main, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, texts, delays = _timed_corpora(dec, wavs)
    counts = _counts()
    launches = counts["chunk_cache_attention"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = w2v.encoder_layers * n_chunks * CORPORA
    print(f"phase full: kernel launches {counts} (K1 expected {want} = "
          f"{w2v.encoder_layers} layers x {n_chunks} chunks x {CORPORA})")
    assert launches == want, (launches, want)
    assert any(texts), "decoder emitted nothing"
    end_ms = (S + enc.window) / 16.0
    for d in delays:
        assert d == sorted(d) and all(0 < x <= end_ms for x in d)

    # outputs are finite: one encoder step and one jointer step at full width
    state = enc.init()
    win = dec.stage(wavs)[2][:, :enc.window].float() / 32768.0
    state = enc.step(state, win)
    x = state.out_cache[:state.t_main]
    jk, jv = caat_step.jointer_kv(dec.model, dec.model.cfg, x)
    lm = caat_step.lm_slot_init(dec.model, dec.model.cfg, N_STREAMS, 8)
    lp = caat_step.jointer_step(dec.model, dec.model.cfg, lm.h_last, jk, jv,
                                torch.full((N_STREAMS,), x.shape[0],
                                           device=dev))
    assert win.shape == (N_STREAMS, enc.window)
    assert torch.isfinite(x).all() and torch.isfinite(lp).all()
    assert lp.shape == (N_STREAMS, caat.vocab_size)

    rate = N_STREAMS * SECONDS / min(times)
    print(f"phase full: {N_STREAMS} streams x {SECONDS:g} s, corpus times "
          f"{['%.4f' % s for s in times]} s -> {rate:.2f} audio-sec/s "
          f"(best corpus), peak memory {peak_gb:.3f} GB, words in the last "
          f"corpus {sum(len(d) for d in delays)} [{card}]")
    return launches


def phase_oneshot_full(card):
    """Base + CAAT base, bf16, flash attention: the one-shot corpus decoder
    at ds2 (bench.py's oneshot_corpus_throughput_ds2 configuration)."""
    import torch
    from wav2vec_s_tpu_torch.stream import caat_step
    from wav2vec_s_tpu_torch.stream.batched import OneShotCorpusDecoder

    dev = torch.device("cuda")
    t = time.perf_counter()
    w2v, caat, model = _base_model(dev, attention_impl="flash")
    S = int(SECONDS * 16000)
    frames = (S - 400) // 320 + 1
    t_cap = -(-(frames + w2v.right_context) // 128) * 128       # 512
    dec = OneShotCorpusDecoder(model, _vocab(caat.vocab_size), w2v,
                               max_len=256, max_emit_per_chunk=4,
                               t_cap=t_cap, blocks_per_step=2)
    dec.transfer_dtype = "int16"
    dec.encode_batch = ENCODE_BATCH
    wavs = _clips([S] * ONESHOT_STREAMS)
    del model
    print(f"phase one-shot full: model + decoder ready in "
          f"{time.perf_counter() - t:.1f} s")
    dec.decode_corpus(wavs)                                     # warm-up

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, texts, delays = _timed_corpora(dec, wavs)
    counts = _counts()
    launches = counts["blockwise_flash_attention_packed"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_sub = ONESHOT_STREAMS // ENCODE_BATCH
    want = w2v.encoder_layers * n_sub * CORPORA
    print(f"phase one-shot full: kernel launches {counts} (K2 expected "
          f"{want} = {w2v.encoder_layers} layers x {n_sub} sub-batches x "
          f"{CORPORA})")
    assert launches == want, (launches, want)
    assert any(texts), "decoder emitted nothing"
    enc = dec._encoder(ONESHOT_STREAMS)
    end_ms = (S + enc.window) / 16.0
    for d in delays:
        assert d == sorted(d) and all(0 < x <= end_ms for x in d)

    # outputs are finite: one encode sub-batch and one jointer step at full
    # width, at the decoder's shapes
    n_chunks = (frames - w2v.right_context) // enc.n_main
    t_frames = n_chunks * enc.n_main + w2v.right_context            # 488
    n_samples = (t_frames - 1) * enc.hop + enc.rf
    au = dec.stage(wavs[:ENCODE_BATCH])[2][:, :n_samples].float() / 32768.0
    e, _ = dec.model.encode(au)
    assert e.shape == (ENCODE_BATCH, t_frames, w2v.encoder_embed_dim)
    jk, jv = caat_step.jointer_kv(dec.model, dec.model.cfg,
                                  e.transpose(0, 1).contiguous())
    lm = caat_step.lm_slot_init(dec.model, dec.model.cfg, ENCODE_BATCH, 8)
    lp = caat_step.jointer_step(dec.model, dec.model.cfg, lm.h_last, jk, jv,
                                torch.full((ENCODE_BATCH,), t_frames,
                                           device=dev))
    assert torch.isfinite(e).all() and torch.isfinite(lp).all()
    assert lp.shape == (ENCODE_BATCH, caat.vocab_size)

    rate = ONESHOT_STREAMS * SECONDS / min(times)
    print(f"phase one-shot full: {ONESHOT_STREAMS} streams x {SECONDS:g} s, "
          f"corpus times {['%.4f' % s for s in times]} s -> {rate:.2f} "
          f"audio-sec/s (best corpus), peak memory {peak_gb:.3f} GB, words "
          f"in the last corpus {sum(len(d) for d in delays)} [{card}]")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wav2vec_s_tpu_torch.ops import native

    # float32 references in full precision (cuDNN convs default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, cuda {torch.version.cuda})")

    t = time.perf_counter()
    native.library()
    ptxas = [ln.strip() for ln in native.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase build: {time.perf_counter() - t:.1f} s "
          f"(nvcc {native.build_seconds and round(native.build_seconds, 1)} s)"
          f"; ptxas: {' | '.join(ptxas)}")

    err, ms, plain_ms = phase_kernel()
    flash_err, flash_ms, flash_plain_ms = phase_flash()
    phase_parity()
    phase_oneshot_parity()
    launches = phase_full(card)
    flash_launches = phase_oneshot_full(card)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "chunk_cache_attention", "route": "cuda",
        "source": "wav2vec_s_tpu_torch/csrc/chunk_attention.cu",
        "replaces": "wav2vec_s_tpu/ops/chunk_attention.py:89",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}, {
        "name": "blockwise_flash_attention_packed", "route": "cuda",
        "source": "wav2vec_s_tpu_torch/csrc/flash_attention.cu",
        "replaces": "wav2vec_s_tpu/ops/pallas_attention.py:281",
        "launches": flash_launches, "max_abs_err": flash_err,
        "ms": flash_ms, "plain_ms": flash_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
