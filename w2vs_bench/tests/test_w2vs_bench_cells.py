"""Each cell's driver at tiny widths on the CPU, through the harness: the
result line's form, and ``correct`` false under every fault the timed
path can have.  (These runs read the program's plain paths: no device
number comes from them, and the per-layer metrics stay silent.)"""

import json

import pytest
import torch

from w2vs_bench.tests.tiny import run_tiny, tiny_cell

TINY = {
    "agent_ds2.base": {"streams": 4, "stream_seconds": 3.0, "pool_streams": 8,
                       "t_cap": 256, "check_streams": 4, "enc_streams": 4,
                       "trace_corpora": 1},
    "oneshot_ds2.base": {"streams": 4, "stream_seconds": 3.0,
                         "pool_streams": 8, "t_cap": 256, "encode_batch": 2,
                         "check_streams": 4, "enc_streams": 4,
                         "trace_corpora": 1},
    "serve_backlog.base": {"slots": 4, "t_cap": 256, "warm_steps": 4,
                           "trace_steps": 3, "host_trace_steps": 2,
                           "check_streams": 4, "enc_streams": 4,
                           "length_block": 8, "min_seconds": 1.5,
                           "max_seconds": 3.0, "pool_seconds": 10},
}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


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
    assert [k for k in line if k != "breakdown"] == KEYS
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


def _unchanged_state(monkeypatch):
    """The incremental encoder's step returns its state unchanged."""
    from wav2vec_s_tpu_torch.stream.incremental import (
        IncrementalBlockwiseEncoder)
    monkeypatch.setattr(IncrementalBlockwiseEncoder, "_encode",
                        lambda self, state, *a, **k: state)


def _unchanged_encoding(monkeypatch):
    """The one-shot encode returns its input features unencoded (zeros)."""
    from wav2vec_s_tpu_torch.models.caat import W2V2CaatModel
    real = W2V2CaatModel.encode

    def enc(self, *a, **k):
        x, pad = real(self, *a, **k)
        return torch.zeros_like(x), pad
    monkeypatch.setattr(W2V2CaatModel, "encode", enc)


def _half_batch(monkeypatch):
    """The second half of the streams is left out: it never emits."""
    from wav2vec_s_tpu_torch.stream import caat_step
    real = caat_step.jointer_step

    def step(model, cfg, h, jk, jv, visible):
        lp = real(model, cfg, h, jk, jv, visible)
        lp[h.shape[0] // 2:, cfg.bos] = 1e9
        return lp
    monkeypatch.setattr(caat_step, "jointer_step", step)


def _altered_token(monkeypatch):
    """Every token is altered where it is produced (the next id)."""
    from wav2vec_s_tpu_torch.stream import caat_step
    real = caat_step.jointer_step

    def step(model, cfg, h, jk, jv, visible):
        return real(model, cfg, h, jk, jv, visible).roll(1, dims=-1)
    monkeypatch.setattr(caat_step, "jointer_step", step)


def _second_best(monkeypatch):
    """The greedy loop picks the second best token, not the argmax; the
    jointer's log-probs stay as they were (only the widest logit gap of the
    served decisions can see it)."""
    from wav2vec_s_tpu_torch.stream import batched, serving

    from w2vs_bench.control import SecondBest
    for m in (batched, serving):
        monkeypatch.setattr(m, "torch", SecondBest(torch))


FAULTS = {"agent_ds2.base": [_unchanged_state, _half_batch, _altered_token,
                             _second_best],
          "serve_backlog.base": [_unchanged_state, _half_batch,
                                 _altered_token, _second_best],
          "oneshot_ds2.base": [_unchanged_encoding, _half_batch,
                               _altered_token, _second_best]}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    """The harness's look for a card is skipped (``run_tiny`` hands it the
    CPU); the rest of a run goes on over a broken program, and the cell's
    own limit (``limits/<cell>.json``) turns it down."""
    fault(monkeypatch)
    r = run_tiny(tiny_cell(cell, "float32", TINY[cell], limit=None),
                 seconds=0.3)
    assert r["correct"] is False, r["checks"]
    if fault is _second_best:
        # caught by the gap alone: the outputs the check keeps are sound
        assert [c["name"] for c in r["checks"]
                if c["value"] > c["limit"]] == ["max_logit_gap"], r["checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_fp8_control_fails_a_limit_where_bf16_passes(cell):
    """The control (the reference in fp8, put in the program's place) at
    tiny widths fails one of the cell's own limits on three seeds, while
    the program in its configured bfloat16 passes them."""
    import time

    from w2vs_bench import harness

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
