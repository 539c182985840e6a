"""The readers of the program's counters (``emit_live.decode``,
``emit_live.serve``, ``plane_rows_live.serve``): silent on an empty
snapshot and on a program without counters; the share of the planted
counters otherwise; and non-null over a tiny traced run of each cell's
driver on the CPU (the program counts while a profiler runs, whatever its
activities)."""

import pytest
import torch

from w2vs_bench import harness, program_counters
from w2vs_bench.tests.test_w2vs_bench_cells import TINY
from w2vs_bench.tests.tiny import run_tiny, tiny_cell
from w2vs_bench.trace import Slice
from wav2vec_s_tpu_torch.utils import debug

READERS = {
    "emit_live.decode": ("decoder.emit_iters_live", "decoder.emit_iters"),
    "emit_live.serve": ("serving.emit_iters_live", "serving.emit_iters"),
    "plane_rows_live.serve": ("serving.plane_rows_visible",
                              "serving.plane_rows_read"),
}
NEW = {"agent_ds2.base": ["emit_live.decode"],
       "oneshot_ds2.base": ["emit_live.decode"],
       "serve_backlog.base": ["emit_live.serve", "plane_rows_live.serve"]}


def _slice():
    return Slice([("k", 0.0, 1.0)], [], [], 1.0, {})


@pytest.fixture(autouse=True)
def _fresh_counters():
    debug.reset_counters()
    yield
    debug.reset_counters()


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_silent_on_an_empty_snapshot(name):
    assert debug.counters() == {}
    assert harness.metric_reader(name)(_slice()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_the_planted_share(monkeypatch, name):
    part, base = READERS[name]
    monkeypatch.setattr(program_counters, "snapshot",
                        lambda: {part: 17, base: 68, "other": 5})
    read = harness.metric_reader(name)
    assert read(_slice()) == pytest.approx(25.0)
    monkeypatch.setattr(program_counters, "snapshot", lambda: {part: 3})
    assert read(_slice()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_silent_on_a_program_without_counters(monkeypatch, name):
    monkeypatch.delattr(debug, "counters")
    assert program_counters.snapshot() == {}
    assert harness.metric_reader(name)(_slice()) is None


@pytest.fixture
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_tiny_traced_run_reports_the_counter_metrics(
        _threads, cell):
    c = tiny_cell(cell, "float32", TINY[cell])
    line = run_tiny(c, seconds=0.3, trace=True)
    assert line["correct"] is True, line["checks"]
    for name in NEW[cell]:
        m = line["metrics"][name]
        assert m["unit"] == "%" and 0 < m["value"] <= 100, (name, m)
    for name in set(READERS) - set(NEW[cell]):
        assert name not in line["metrics"]
