"""The reader of ``jointer_rows_loaded.serve`` (the program's counter
``serving.jointer_rows_loaded`` over ``serving.plane_rows_read``): silent
on an empty snapshot, on a program without counters and on a program that
keeps the serving counters but not this one (a jointer that reads the
whole plane); the share of the planted counters otherwise; and non-null,
above the visible rows' share, over a tiny traced run of the serving
cell's driver on the CPU."""

import pytest
import torch

from w2vs_bench import harness, program_counters
from w2vs_bench.tests.test_w2vs_bench_cells import TINY
from w2vs_bench.tests.tiny import run_tiny, tiny_cell
from w2vs_bench.trace import Slice
from wav2vec_s_tpu_torch.utils import debug

NAME = "jointer_rows_loaded.serve"
PART, BASE = "serving.jointer_rows_loaded", "serving.plane_rows_read"


def _read(snapshot, monkeypatch):
    monkeypatch.setattr(program_counters, "snapshot", lambda: snapshot)
    return harness.metric_reader(NAME)(Slice([("k", 0.0, 1.0)], [], [], 1.0,
                                             {}))


@pytest.fixture(autouse=True)
def _fresh_counters():
    debug.reset_counters()
    yield
    debug.reset_counters()


@pytest.mark.parametrize("snapshot,want", [
    ({}, None),                                   # no counter at all
    ({BASE: 1024, "serving.plane_rows_visible": 178}, None),   # the parent
    ({PART: 3}, None),                            # no base
    ({PART: 17, BASE: 68, "other": 5}, 25.0),
    ({PART: 0, BASE: 68}, 0.0),
])
def test_reader_reads_the_share_and_is_silent_without_its_counter(
        monkeypatch, snapshot, want):
    got = _read(snapshot, monkeypatch)
    assert got == (None if want is None else pytest.approx(want))


def test_reader_is_silent_on_a_program_without_counters(monkeypatch):
    monkeypatch.delattr(debug, "counters")
    assert program_counters.snapshot() == {}
    assert harness.metric_reader(NAME)(None) is None


def test_a_tiny_traced_serving_run_reports_it():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = "serve_backlog.base"
        line = run_tiny(tiny_cell(cell, "float32", TINY[cell]), seconds=0.3,
                        trace=True)
    finally:
        torch.set_num_threads(n)
    assert line["correct"] is True, line["checks"]
    m = line["metrics"][NAME]
    assert m["unit"] == "%" and 0 < m["value"] <= 100, m
    assert m["value"] >= line["metrics"]["plane_rows_live.serve"]["value"]
