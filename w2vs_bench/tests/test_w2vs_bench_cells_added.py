"""The cells added after the first three, at tiny widths on the CPU, held
to what ``test_w2vs_bench_cells.py`` holds those to: the result line's
form, ``correct`` false under every fault the timed path can have (the
faults of that file), and the fp8 control failing a limit of the cell's
own where the program in bfloat16 passes them."""

import json
import time

import pytest
import torch

from w2vs_bench import harness
from w2vs_bench.tests import test_w2vs_bench_cells as first
from w2vs_bench.tests.tiny import run_tiny, tiny_cell

TINY = {
    # 8 s: two chunks of 160 frames (the cell's 10 s run three)
    "agent_ds10.base": {"streams": 4, "stream_seconds": 8.0,
                        "pool_streams": 8, "t_cap": 512, "check_streams": 4,
                        "enc_streams": 4, "trace_corpora": 1},
    "serve_backlog.large": first.TINY["serve_backlog.base"],
}
FAULTS = {"agent_ds10.base": first.FAULTS["agent_ds2.base"],
          "serve_backlog.large": first.FAULTS["serve_backlog.base"]}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_tiny_run_prints_the_contracts_line(cell, trace):
    c = tiny_cell(cell, "float32", TINY[cell])
    r = run_tiny(c, seconds=0.3, trace=bool(trace))
    line = json.loads(json.dumps(r))
    assert [k for k in line if k != "breakdown"] == first.KEYS
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["memory_peak_bytes"] == 0
    if trace:
        # no device here: no device metric is written
        assert line["metrics"] == {}
        assert line["breakdown"] == {"device_ops": [], "idle_gaps": []}
    else:
        names = {m["name"] for m in c.end_to_end}
        assert set(line["metrics"]) == names and "setup_s" in names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    for chk in line["checks"]:
        assert set(chk) == {"name", "value", "limit"}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_tiny(tiny_cell(cell, "float32", TINY[cell], limit=None),
                 seconds=0.3)
    assert r["correct"] is False, r["checks"]
    if fault is first._second_best:
        assert [c["name"] for c in r["checks"]
                if c["value"] > c["limit"]] == ["max_logit_gap"], r["checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_fp8_control_fails_a_limit_where_bf16_passes(cell):
    c = tiny_cell(cell, "bfloat16", TINY[cell], limit=None)
    for seed in (11, 12, 13):
        ctx = harness.Context(c, seed, 0.3, False, torch.device("cpu"),
                              time.perf_counter())
        drv = harness.driver_class(c.traffic)(ctx)
        drv.setup()
        drv.measure()
        drv.release()
        prog = drv.check()
        ctrl = drv.check(control=True)
        assert all(x["value"] <= x["limit"] for x in prog), prog
        assert any(x["value"] > x["limit"] for x in ctrl), ctrl
