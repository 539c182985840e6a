"""Where the time of one corpus decode goes on the card.

    python -m wav2vec_s_tpu_torch.tools.profile_decode
        [--decoder cached|oneshot|beam|oneshot-beam] [--streams 128]
        [--seconds 10] [--corpora 3] [--top 25] [--stop-check 1]

Builds wav2vec-S Base + CAAT base with random weights from a seed (bf16
compute, a 10000-entry dictionary), and decodes seeded noise with the cached
greedy agent (``CachedFusedGreedyDecoder``: DECISION_STEP 2, max_emit 4,
int16 wire) or, with ``--decoder oneshot``, with ``OneShotCorpusDecoder``
(``attention_impl="flash"``, encode batch 32; give it ``--streams 256``).
``--decoder beam`` and ``--decoder oneshot-beam`` run the beam quality path
instead: ``FusedBeamStreamingDecoder`` (dense model) and
``FusedOneShotBeamDecoder`` (flash) at intra-beam 5, inter_beam 1,
max_steps 8, max_len 64, eager emission, DECISION_STEP 2, int16 wire (give
them ``--streams 64``); ``--stop-check n`` makes their beam block read its
early-stop test from the device every n-th iteration (0: never).
One warm-up corpus, then ``--corpora`` corpora on the host clock (staging
included, a synchronize after each), then ONE warm corpus under
``torch.profiler``.  Prints every corpus time and their median, the device
kernels of the traced corpus, its device-busy time (the union of the
kernel intervals, annotation ranges excluded) with its share of the wall,
the kernels by device time, the launches of the port's own kernels, the
program's spans (``w2vs/...``, ``utils/debug.span``) of the traced corpus
with their count and host time, the program's counters over it, the peak
memory, and the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from wav2vec_s_tpu_torch.tools.profile_train import _busy_us
from wav2vec_s_tpu_torch.utils import debug


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--decoder", default="cached",
                    choices=("cached", "oneshot", "beam", "oneshot-beam"))
    ap.add_argument("--streams", type=int, default=128)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--corpora", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--stop-check", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wav2vec_s_tpu_torch.data.dictionary import Dictionary
    from wav2vec_s_tpu_torch.models import wav2vec_s_base_config
    from wav2vec_s_tpu_torch.models.caat import (
        W2V2CaatModel, caat_base_config)
    from wav2vec_s_tpu_torch.models.modules import random_init_
    from wav2vec_s_tpu_torch.ops.chunk_attention import chunk_cache_attention
    from wav2vec_s_tpu_torch.ops.flash_attention import (
        blockwise_flash_attention_packed)
    from wav2vec_s_tpu_torch.stream.batched import (
        CachedFusedGreedyDecoder, OneShotCorpusDecoder)
    from wav2vec_s_tpu_torch.stream.beam_batched import (
        FusedBeamStreamingDecoder, FusedOneShotBeamDecoder)

    dev = torch.device("cuda")
    oneshot = args.decoder.startswith("oneshot")
    beam = args.decoder.endswith("beam")
    w2v = wav2vec_s_base_config(
        dtype="bfloat16", attention_impl="flash" if oneshot else "dense")
    caat = caat_base_config(dtype="bfloat16")
    with dev:
        model = W2V2CaatModel(w2v, caat)
    random_init_(model, torch.Generator(device=dev).manual_seed(0))
    vocab = Dictionary()
    for i in range(caat.vocab_size - vocab.nspecial):
        vocab.add_symbol(f"w{i}")
    n_samples = int(args.seconds * 16000)
    frames = (n_samples - 400) // 320 + 1
    t_cap = -(-(frames + w2v.right_context) // 128) * 128
    if beam:
        cls = (FusedOneShotBeamDecoder if oneshot
               else FusedBeamStreamingDecoder)
        dec = cls(model, vocab, w2v, beam_size=5, inter_beam=1, max_steps=8,
                  max_len=64, eager=True, t_cap=t_cap, blocks_per_step=2)
        dec.stop_check_every = args.stop_check
    else:
        cls = OneShotCorpusDecoder if oneshot else CachedFusedGreedyDecoder
        dec = cls(model, vocab, w2v, max_len=256, max_emit_per_chunk=4,
                  t_cap=t_cap, blocks_per_step=2)
    dec.transfer_dtype = "int16"
    rng = np.random.default_rng(0)
    wavs = [rng.standard_normal(n_samples).astype(np.float32) * 0.1
            for _ in range(args.streams)]
    dec.decode_corpus(wavs)                                     # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(args.corpora):
        t = time.perf_counter()
        texts, delays = dec.decode_corpus(wavs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    own = {"K1 chunk_cache_attention": chunk_cache_attention,
           "K2 blockwise_flash_attention_packed":
               blockwise_flash_attention_packed}
    for fn in own.values():
        fn.launches = 0
    debug.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        dec.decode_corpus(wavs)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3
    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith(debug.SPAN):
            n, t_us = spans.get(e.name, (0, 0.0))
            spans[e.name] = (n + 1, t_us + e.time_range.elapsed_us())
    by_name = {}
    for e in kernels:
        n, t_us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t_us + e.time_range.end
                           - e.time_range.start)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    audio = args.streams * args.seconds
    print(f"profile_decode: decoder={args.decoder} ({cls.__name__}) "
          f"{args.streams} streams x {args.seconds:g} s, bf16, int16 wire"
          + (f", early-stop read every {args.stop_check or 'never'}, "
             f"{dec.iterations_run} beam iterations in all" if beam else "")
          + f" [{card}]")
    median = float(np.median(walls))
    print(f"untraced corpus times {['%.4f' % w for w in walls]} s (median "
          f"{median:.4f} s: {audio / median:.2f} audio-sec/s), words in the "
          f"last corpus {sum(len(d) for d in delays)}, peak memory "
          f"{peak_gb:.3f} GB")
    print(f"traced corpus: wall {traced * 1e3:.2f} ms, {len(kernels)} device "
          f"kernels, device busy {busy_ms:.2f} ms = "
          f"{busy_ms / (traced * 1e3):.3f} of the traced wall, "
          f"{busy_ms / (median * 1e3):.3f} of the median untraced corpus; "
          f"launches of the port's kernels: "
          + ", ".join(f"{k} {fn.launches}" for k, fn in own.items()))
    print("program spans of the traced corpus (host ms, count):")
    for name, (n, t_us) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
        print(f"  {t_us / 1e3:9.3f} {n:6d}  {name}")
    print(f"program counters of the traced corpus: {debug.counters()}")
    if not kernels:
        print("the profiler recorded no device time")
        return 1
    print("device time by kernel over the traced corpus (ms, calls):")
    for name, (calls, t_us) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][1])[:args.top]:
        print(f"  {t_us / 1e3:9.3f} {calls:6d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
