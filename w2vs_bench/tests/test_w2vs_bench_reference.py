"""The frozen reference against the program at tiny widths on the CPU.

Only this test imports both: the reference module imports torch alone."""

import ast
from pathlib import Path

import pytest
import torch

from w2vs_bench.model import build_program_model, make_weights
from w2vs_bench.reference import w2v2_caat as ref
from w2vs_bench.tests.tiny import tiny_config

REF_FILE = Path(ref.__file__)


def _cfg(pre_ln: bool):
    cfg = tiny_config()
    if pre_ln:           # the Large recipe's encoder: pre-LN, conv bias
        cfg["w2v"].update(layer_norm_first=True, conv_bias=True,
                          encoder_layers=3)
    return cfg


def test_reference_imports_torch_alone():
    tree = ast.parse(REF_FILE.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots <= {"__future__", "contextlib", "math", "typing", "torch"}


@pytest.mark.parametrize("pre_ln", [False, True])
def test_reference_encoder_equals_the_programs(pre_ln):
    cfg = _cfg(pre_ln)
    model, w2v, _ = build_program_model(cfg, 5, torch.device("cpu"))
    W = {k: v.float() for k, v in make_weights(cfg, 5, "cpu").items()}
    audio = torch.randn(1, 16000 * 2, generator=torch.Generator()
                        .manual_seed(1)) * 0.1
    with torch.no_grad():
        enc, _ = model.encode(audio, None, 16, 8)
    mine = ref.encode(W, cfg["w2v"], audio[0], enc.shape[1],
                      ref.Arith("float32"))
    torch.testing.assert_close(mine, enc[0], atol=2e-5, rtol=1e-5)


def test_reference_lm_and_jointer_equal_the_programs():
    from wav2vec_s_tpu_torch.stream import caat_step

    cfg = _cfg(False)
    model, _, caat = build_program_model(cfg, 6, torch.device("cpu"))
    W = {k: v.float() for k, v in make_weights(cfg, 6, "cpu").items()}
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(2, caat.vocab_size, (7,), generator=g).tolist()
    with torch.no_grad():
        h = model.decoder.lm(torch.tensor([[0] + tokens]))[0]
    mine = ref.lm_states(W, cfg["caat"], tokens, ref.Arith("float32"), "cpu")
    torch.testing.assert_close(mine, h, atol=2e-5, rtol=1e-5)

    T, N = 40, h.shape[0]
    enc = torch.randn(T, 32, generator=g)
    vis = torch.randint(1, T + 1, (N,), generator=g)
    with torch.no_grad():
        jk, jv = caat_step.jointer_kv(model, caat,
                                      enc[:, None].expand(T, N, 32)
                                      .contiguous())
        lp = caat_step.jointer_step(model, caat, h, jk, jv, vis)
    lp[:, 1] = -float("inf")            # pad, as the decoders mask it
    lp = lp.log_softmax(-1)
    mine = ref.joint_log_probs(W, cfg["caat"], mine, enc, vis,
                               ref.Arith("float32"))
    torch.testing.assert_close(mine, lp, atol=5e-5, rtol=1e-5)


def test_decision_points():
    # chunk 0: two tokens then blank; chunk 1: max_emit tokens, no blank;
    # chunk 2: blank alone; the prefix cap ends every decision
    pts = ref.decisions([5, 6, 7, 8, 9, 10], [0, 0, 1, 1, 1, 1], 3, 4, 64)
    assert pts == [(0, 0, 5), (1, 0, 6), (2, 0, 0), (2, 1, 7), (3, 1, 8),
                   (4, 1, 9), (5, 1, 10), (6, 2, 0)]
    assert ref.decisions([5, 6], [0, 0], 2, 4, 3) == [(0, 0, 5), (1, 0, 6)]
    with pytest.raises(ValueError):
        ref.decisions([5], [3], 2, 4, 64)


def test_fp8_products_are_coarser_than_float32():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    err = (ref._fp8(x) - x).abs().max() / x.abs().max()
    assert 1e-3 < err < 0.1
