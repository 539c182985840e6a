"""On the card: each cell runs correct through the benchmark's command, the
lower-precision control, put in the program's place, fails a limit, and a
greedy pick of the second-best token fails the widest logit gap.

    python -m pytest -m gpu w2vs_bench/tests/test_w2vs_bench_card.py

Skips without a CUDA device (decided in the fixture)."""

import json
import subprocess
import sys

import pytest

from w2vs_bench import harness

pytestmark = pytest.mark.gpu
CELLS = ["agent_ds2.base", "serve_backlog.base", "oneshot_ds2.base"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "w2vs_bench.run",
                          "--workload", cell, "--seed", "2718281828",
                          "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_is_not_correct(card, cell):
    """The control's readings at the cell's own size on three seeds: each
    fails at least one of the cell's limits."""
    from w2vs_bench.control import readings

    limits = harness.resolve(cell).limits
    for seed in (5, 6, 7):
        r = readings(cell, seed, 1.0, control=True, device=card)
        assert any(v > limits[k]["limit"] for k, v in r["control"].items()), r
        assert all(v <= limits[k]["limit"] for k, v in r["program"].items()), r


@pytest.mark.parametrize("cell", CELLS)
def test_a_pick_that_is_not_the_argmax_is_not_correct(card, cell):
    """The program with ``control.plant_second_best`` at the cell's own size
    on three seeds: the widest logit gap fails its limit."""
    from w2vs_bench.control import readings

    limit = harness.resolve(cell).limits["max_logit_gap"]["limit"]
    for seed in (5, 6, 7):
        r = readings(cell, seed, 1.0, control=False, fault=True, device=card)
        assert r["fault"]["max_logit_gap"] > limit, r
