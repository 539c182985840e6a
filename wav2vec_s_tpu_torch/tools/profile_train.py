"""Where the time of one fine-tuning step goes on the card.

    python -m wav2vec_s_tpu_torch.tools.profile_train [--attention flash|dense]
        [--family raw|fbank|text] [--frontend shallow2d] [--jointer mha]
        [--steps 3] [--batch 8] [--seconds 10] [--tokens 64] [--targets 40]
        [--top 25]

Builds wav2vec-S Base + CAAT base with random weights from a seed (bf16
compute, the recipe's dropouts) on raw audio, or the fbank family's model
(Base encoder widths, ``--frontend`` / ``--jointer``) on seeded log-mel
frames (``--seconds`` of 10 ms frames, padded to a multiple of 16), or the
text family's on ``--tokens`` source tokens; takes two warm steps on seeded
noise, then
``--steps`` steps on the host clock (a synchronize after each) and the same
number under ``torch.profiler``.  Prints the step times, the device kernels
per step, the device-busy time per step (the union of the kernel intervals,
annotation ranges excluded) with its share of the step, the kernels by
device time, the peak memory, and the card's name and power limit.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import torch


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--attention", default="flash",
                    choices=("flash", "dense"))
    ap.add_argument("--family", default="raw",
                    choices=("raw", "fbank", "text"))
    ap.add_argument("--frontend", default="shallow2d")
    ap.add_argument("--jointer", default="mha")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--targets", type=int, default=40)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wav2vec_s_tpu_torch.models import wav2vec_s_base_config
    from wav2vec_s_tpu_torch.models.caat import (
        W2V2CaatModel, caat_base_config)
    from wav2vec_s_tpu_torch.models.fbank import FbankCaatModel
    from wav2vec_s_tpu_torch.models.text_caat import TextCaatModel
    from wav2vec_s_tpu_torch.models.modules import random_init_
    from wav2vec_s_tpu_torch.train.optim import OptimConfig, build_optimizer
    from wav2vec_s_tpu_torch.train.recipes import make_caat_loss_fn
    from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step

    dev = torch.device("cuda")
    w2v = wav2vec_s_base_config(dtype="bfloat16",
                                attention_impl=args.attention)
    caat = caat_base_config(dtype="bfloat16")
    with dev:
        model = {"raw": lambda: W2V2CaatModel(w2v, caat),
                 "fbank": lambda: FbankCaatModel(w2v, dataclasses.replace(
                     caat, frontend=args.frontend,
                     jointer_type=args.jointer)),
                 "text": lambda: TextCaatModel(w2v, caat)}[args.family]()
    random_init_(model, torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator().manual_seed(0)
    tgt = torch.randint(4, caat.vocab_size, (args.batch, args.targets),
                        generator=g)
    tgt[:, -1] = caat.eos
    if args.family == "raw":
        source = torch.randn((args.batch, int(args.seconds * 16000)),
                             generator=g)
    elif args.family == "fbank":
        frames = -(-int(args.seconds * 100) // 16) * 16
        source = torch.randn((args.batch, frames, 80), generator=g)
    else:
        source = torch.randint(4, caat.vocab_size, (args.batch, args.tokens),
                               generator=g)
    batch = {"source": source.to(dev), "targets": tgt.to(dev)}
    opt = build_optimizer(OptimConfig(lr=1e-4, warmup_updates=100))
    state = TrainState.create(model, opt)
    step = make_train_step(make_caat_loss_fn(model, caat, 16, 8), opt)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, _ = step(state, batch, gen)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(args.steps):
        t = time.perf_counter()
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(args.steps):
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3
    by_name = {}
    for e in kernels:
        n, t_us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t_us + e.time_range.end
                           - e.time_range.start)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    n = args.steps
    wall = sum(walls) / n
    what = {"raw": f"{args.seconds:g} s of audio",
            "fbank": f"{args.seconds:g} s of log-mel frames, "
                     f"{args.frontend} + {args.jointer}",
            "text": f"{args.tokens} source tokens"}[args.family]
    print(f"profile_train: {args.family}, attention={args.attention} B "
          f"{args.batch} x {what}, U {args.targets} [{card}]")
    print(f"untraced step times {['%.2f' % w for w in walls]} ms (mean "
          f"{wall:.2f}), peak memory {peak_gb:.3f} GB")
    print(f"traced: {traced_ms / n:.2f} ms per step, {len(kernels) / n:.0f} "
          f"device kernels per step, device busy {busy_ms / n:.2f} ms per "
          f"step = {busy_ms / traced_ms:.3f} of the traced step, "
          f"{busy_ms / n / wall:.3f} of the untraced step")
    if not kernels:
        print("the profiler recorded no device time")
        return 1
    print(f"device time by kernel over {n} steps (ms, calls):")
    for name, (calls, t_us) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][1])[:args.top]:
        print(f"  {t_us / 1e3:9.3f} {calls:6d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
