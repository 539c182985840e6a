"""Readings that set a cell's correctness limit, on the card, in one process.

    python3 -m w2vs_bench.control --workload agent_ds2.base
        --seeds 11,12,... [--control-seeds 11,12,13]
        [--fault-seeds 11,12,13] [--seconds 2]
        [--out chiprun_out/limits_agent.json]

For each seed, the cell's own set-up and a short window at its own load
(``--seconds``), then the reference's reading of what the program served
of each number the cell compares; for the control seeds, the control's
(the fp8 reference in the program's place); for the fault seeds, the
program's once more with a greedy pick that is not the argmax planted in
its decoders (``plant_second_best``).  The benchmark's own runs never run
the control or a fault; this is how ``limits/<cell>.json`` was set (the
lower reading is the largest the program gives, the upper the smallest the
control or the fault gives).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from w2vs_bench import harness


class SecondBest:
    """``torch`` as the program's decoders see it, with ``argmax`` giving
    the index of the second largest: a planted fault, a greedy pick that
    is not the best token."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    def argmax(self, x, dim):
        return x.topk(2, dim=dim).indices.select(dim, 1)


def plant_second_best():
    """Put ``SecondBest`` in the greedy loops of the agent, the one-shot
    decoder and the serving session; returns the undo."""
    from wav2vec_s_tpu_torch.stream import batched, serving

    mods = (batched, serving)
    for m in mods:
        m.torch = SecondBest(torch)
    return lambda: [setattr(m, "torch", torch) for m in mods]


def _read(cell: str, seed: int, seconds: float, device, control: bool):
    ctx = harness.Context(harness.resolve(cell), seed, seconds, False,
                          device, time.perf_counter())
    drv = harness.driver_class(ctx.cell.traffic)(ctx)
    drv.setup()
    drv.measure()
    drv.release()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"program": {c["name"]: c["value"] for c in drv.check()}}
    if control:
        out["control"] = {c["name"]: c["value"]
                          for c in drv.check(control=True)}
    del drv
    gc.collect()
    return out


def readings(cell: str, seed: int, seconds: float, control: bool,
             fault: bool = False, device=None) -> dict:
    device = device or torch.device("cuda", 0)
    out = dict(seed=seed, **_read(cell, seed, seconds, device, control))
    if fault:
        undo = plant_second_best()
        try:
            out["fault"] = _read(cell, seed, seconds, device, False)[
                "program"]
        finally:
            undo()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    flt = {int(s) for s in args.fault_seeds.split(",") if s}
    rows = []
    for s in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(args.workload, s, args.seconds, s in ctl, s in flt)
        r["s"] = time.perf_counter() - t
        rows.append(r)
        print(json.dumps(r), flush=True)
    names = list(rows[0]["program"])
    summary = {"workload": args.workload,
               "lower": {n: max(r["program"][n] for r in rows) for n in names}}
    for side in ("control", "fault"):
        summary[side] = {n: min((r[side][n] for r in rows if side in r),
                                default=None) for n in names}
    summary["rows"] = rows
    summary["card"] = harness.card_info(torch.device("cuda", 0))
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
