"""The harness finds cells, configurations, traffic, metric readers and
limits by name, so additions are new files; no run loads JAX or the JAX
package; a run without a card or without the program gives no result."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from w2vs_bench import harness
from w2vs_bench.tests.tiny import TINY_CONVS, run_tiny, tiny_config

ROOT = harness.ROOT


def _digest(folder: Path):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_found_from_new_files_alone(tmp_path):
    shutil.copytree(ROOT / "w2vs_bench", tmp_path / "w2vs_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digest(tmp_path / "w2vs_bench")
    b = tmp_path / "w2vs_bench"

    cfg = tiny_config()
    cfg["name"] = "dummy_cfg"
    (b / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "agent_ds2.json").read_text())
    mix.update(streams=2, stream_seconds=2.0, pool_streams=4, t_cap=128,
               check_streams=2, trace_corpora=1)
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (b / "metrics" / "dummy_count.decode.py").write_text(
        "def read(s):\n    return float(len(s.spans)) or None\n")
    (b / "limits" / "dummy.base.json").write_text(
        json.dumps({"encoder_rel_err": {"limit": 1e-3},
                    "joint_logprob_err": {"limit": 1e-3},
                    "max_logit_gap": {"limit": 1e-3}}))
    bench["workloads"].append({"name": "dummy.base", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "decode_audio_s_per_s":
            m["workloads"].append("dummy.base")
    bench["per_layer"].append({"name": "dummy_count.decode", "unit": "spans",
                               "better": "higher", "source": "program_span",
                               "layer": "test", "moves":
                               "decode_audio_s_per_s",
                               "workloads": ["dummy.base"]})

    cell = harness.resolve("dummy.base", bench_dir=b, benchmark=bench)
    assert cell.config["w2v"]["conv_feature_layers"] == TINY_CONVS
    assert cell.traffic["streams"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "dummy_count.decode"
    read = harness.metric_reader("dummy_count.decode", b)
    torch.set_num_threads(2)
    r = run_tiny(cell, seconds=0.2, trace=False)
    assert r["correct"] and set(r["metrics"]) == {"decode_audio_s_per_s",
                                                   "setup_s"}
    from w2vs_bench.trace import Slice
    assert read(Slice([], [("step", 0, 1)], [], 1.0, {})) == 1.0
    # nothing that was there changed
    after = _digest(b)
    assert {k: v for k, v in after.items() if k in before} == before


SCRIPT = """
import sys, torch
torch.set_num_threads(1)
from pathlib import Path
import w2vs_bench.harness as h
from w2vs_bench.tests.tiny import run_tiny, tiny_cell
from w2vs_bench.tests.test_w2vs_bench_cells import TINY
for p in sorted(Path(h.BENCH_DIR, "metrics").glob("*.py")):
    h.metric_reader(p.stem)
import w2vs_bench.control, w2vs_bench.run
for cell in sorted(TINY):
    run_tiny(tiny_cell(cell, "float32", TINY[cell]), seconds=0.1,
             trace=cell.startswith("agent"))
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_no_run_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1]
                        .replace("'", '"'))
    assert "wav2vec_s_tpu_torch" in loaded
    assert harness.forbidden_loaded(loaded) == []


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "-m", "w2vs_bench.run",
                           "--workload", "agent_ds2.base", "--seed",
                           "3000000019", "--seconds", "1", "--trace", "0",
                           *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_a_run_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this is the CPU-only case")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_with_only_the_benchmark_files_a_run_fails(tmp_path):
    shutil.copytree(ROOT / "w2vs_bench", tmp_path / "w2vs_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "not in this checkout" in out.stderr
