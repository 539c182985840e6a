"""One run of one benchmark cell, found by name.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell lies in a file of its own, which this module finds by the names in
``BENCHMARK.json``:

- ``configs/<config>.json``: the model's sizes, source and cuts;
- ``traffic/<traffic>.json``: the mix's parameters and the ``driver`` (a
  module of ``drivers/``) that runs it;
- ``metrics/<metric>.py``: a reader with ``read(s)`` -> a number or None,
  over the traced slice ``s`` (``trace.Slice``);
- ``limits/<cell>.json``: the limit of each number the correctness check
  compares, with the readings it was set from.

A driver module defines ``Driver(ctx)`` with ``setup()``, ``measure()``
(the window, or with ``ctx.trace`` the profiled slice), ``release()`` (frees
the program's state) and ``check()`` (the comparison with the reference).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PROGRAM = "wav2vec_s_tpu_torch"
#: top-level modules that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "wav2vec_s_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file, ...)."""


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` that are in ``FORBIDDEN``."""
    names = {m.split(".", 1)[0] for m in (modules or list(sys.modules))}
    return sorted(n for n in names if n in FORBIDDEN)


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    bench_dir: Path
    chips: int = 1


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell_name: str, bench_dir: Path = BENCH_DIR,
            benchmark: Optional[dict] = None) -> Cell:
    """The cell's configuration, traffic, metrics and limits, by name."""
    bench = benchmark or load_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise BenchError(f"no workload {cell_name!r} in BENCHMARK.json")
    w = cells[cell_name]
    cfg = load_json(bench_dir / "configs" / f"{w['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    return Cell(cell_name, cfg, traffic,
                [m for m in bench["end_to_end"] if _applies(m, cell_name)],
                [m for m in bench["per_layer"] if _applies(m, cell_name)],
                load_json(bench_dir / "limits" / f"{cell_name}.json"),
                bench_dir, w["chips"])


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no reader {path.relative_to(bench_dir.parent)}")
    spec = importlib.util.spec_from_file_location(
        f"w2vs_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_class(traffic: dict):
    return importlib.import_module(
        f"w2vs_bench.drivers.{traffic['driver']}").Driver


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments and the device."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_process: float
    window_start: Optional[float] = None
    log: object = sys.stderr

    def say(self, msg: str) -> None:
        print(f"w2vs_bench: {msg}", file=self.log, flush=True)


def card_info(device) -> dict:
    """The card's name, clocks and power limit (nvidia-smi), for the log."""
    import torch

    info = {"name": torch.cuda.get_device_name(device)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem", "--format=csv,noheader",
             f"--id={torch.cuda.current_device()}"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        info["nvidia_smi"] = out
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = f"unavailable ({e})"
    return info


def run_cell(ctx: Context) -> dict:
    """Set up, measure, check: the result line's dict (``checks`` last)."""
    import torch

    from w2vs_bench import trace as trace_mod

    cell = ctx.cell
    drv = driver_class(cell.traffic)(ctx)
    on_card = ctx.device.type == "cuda"
    drv.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = drv.measure()
    setup_s = ctx.window_start - ctx.t_process
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    for line in getattr(drv, "log_lines", lambda: [])():
        ctx.say(line)
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = drv.check()

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics: Dict[str, dict] = {}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks),
              "attempted": out["attempted"], "failed": out["failed"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device) if on_card
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    if ctx.trace:
        sl = out["slice"]
        for m in cell.per_layer:
            v = metric_reader(m["name"], cell.bench_dir)(sl)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        device["busy_s"] = sl.busy_s
        device["window_s"] = sl.wall_s
        result["breakdown"] = trace_mod.breakdown(out["host_slice"])
    else:
        vals = dict(out["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": vals[m["name"]],
                                  "unit": units[m["name"]]}
    result["metrics"] = metrics
    result["device"] = device
    result["checks"] = checks
    return result


def main(argv=None, t_process: Optional[float] = None) -> int:
    import argparse

    t_process = t_process if t_process is not None else time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m w2vs_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build caches at fixed paths of the checkout: only its first run builds
    cache = ROOT / ".w2vs_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["USE_FLAX"] = "0"
    try:
        cell = resolve(args.workload)
        prog = importlib.util.find_spec(PROGRAM)
        if prog is None or not Path(prog.origin).resolve().is_relative_to(
                ROOT):
            raise BenchError(f"the program {PROGRAM} is not in this checkout "
                             f"({ROOT})")
        import torch
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise BenchError(f"the cell needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} are here")
        torch.set_num_threads(4)
        ctx = Context(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_process)
        ctx.say(f"card {card_info(ctx.device)}")
        result = run_cell(ctx)
    except BenchError as e:
        print(f"w2vs_bench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_loaded()
    if bad:
        print(f"w2vs_bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for c in result["checks"]:
        print(f"w2vs_bench check: {c['name']} {c['value']!r} limit "
              f"{c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
