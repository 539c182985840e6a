"""Tiny cells for CPU tests: the harness, its drivers and readers at small
widths on the program's plain paths (no device number comes from them)."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch

from w2vs_bench import harness

BENCH = harness.BENCH_DIR
TINY_CONVS = [[32, 10, 5], [32, 3, 2], [32, 3, 2], [32, 3, 2], [32, 3, 2],
              [32, 2, 2], [32, 2, 2]]


def tiny_config(name: str = "w2vs_base_caat", dtype: str = "float32") -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["w2v"].update(conv_feature_layers=TINY_CONVS, encoder_layers=2,
                      encoder_embed_dim=32, encoder_ffn_embed_dim=64,
                      encoder_attention_heads=4, dtype=dtype)
    cfg["caat"].update(vocab_size=60, decoder_layers=1, decoder_embed_dim=32,
                       decoder_ffn_embed_dim=64, decoder_attention_heads=4,
                       jointer_layers=2, jointer_embed_dim=32,
                       jointer_ffn_embed_dim=64, jointer_attention_heads=4,
                       dtype=dtype)
    return cfg


def tiny_cell(cell: str, dtype: str = "float32", traffic_update=None,
              limit=1e-3) -> harness.Cell:
    """The cell at tiny widths; ``limit`` replaces every correctness limit
    (None keeps the cell's own)."""
    real = harness.resolve(cell)
    traffic = dict(real.traffic)
    traffic.update(traffic_update or {})
    name = [w for w in json.loads((BENCH.parent / "BENCHMARK.json")
                                  .read_text())["workloads"]
            if w["name"] == cell][0]["config"]
    limits = real.limits if limit is None else {
        k: dict(v, limit=limit) for k, v in real.limits.items()}
    return harness.Cell(cell, tiny_config(name, dtype), traffic,
                        real.end_to_end, real.per_layer, limits, BENCH)


def run_tiny(cell: harness.Cell, seed: int = 3, seconds: float = 0.0,
             trace: bool = False) -> dict:
    torch.manual_seed(0)
    ctx = harness.Context(cell, seed, seconds, trace, torch.device("cpu"),
                          time.perf_counter())
    return harness.run_cell(ctx)
