"""The training entry point under a process group: ``train.cli.main`` in
two spawned CPU ranks over gloo (``tests/_torch_parallel_worker.py``)
against the same call in one process, with the recipe's dropouts and
flash attention on (the flash twins drop at their rows' place in the
whole batch).

- CAAT fine-tuning with ``run.fsdp=true`` and ``run.eval_bleu``, seq2seq
  fine-tuning under data parallelism with ``run.eval_bleu``, and
  pre-training with ``run.zero=true`` (sampled block contexts), CAAT
  with ``run.zero=true``, ``run.flat_optimizer`` and ``run.remat=dots``,
  and CAAT with ``run.fsdp=true`` and ``run.flat_optimizer`` (off under
  FSDP; one process trains the flat vector): every
  batch of the corpora holds 2 rows, so one process and 2 data ranks see
  the same batches; rank 0's progress records equal one process's (losses
  and grad norms rtol 1e-5; the validation loss, a sum over rows, and the
  BLEU and accuracy of the ranks' gathered decodes too), rank 1 prints
  none, and the final checkpoint (written by rank 0 in the single-process
  layout) equals one process's (atol 1e-5 rtol 1e-4).
"""

import json

import numpy as np
import pytest
import torch

from tests import _torch_parallel_worker as worker
from tests.test_torch_port_cli import _overrides as caat_overrides
from tests.test_torch_port_cli import corpus  # noqa: F401 (a fixture)
from tests.test_torch_port_pretrain_cli import _argv as pretrain_argv
from tests.test_torch_port_pretrain_cli import audio_corpus  # noqa: F401
from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
from wav2vec_s_tpu_torch.train import cli

torch.set_num_threads(1)

DROPOUTS = {"model.dropout": 0.1, "model.attention_dropout": 0.1,
            "model.encoder_layerdrop": 0.2, "caat.dropout": 0.1,
            "caat.attention_dropout": 0.1, "caat.activation_dropout": 0.1,
            "caat.rand_pos_decoder": 4}
COMPARED = ("loss_total", "sample_size", "grad_norm", "skipped")
#: the CAAT scenarios' parallel settings; the one-process run drops run.fsdp
#: and run.zero and keeps the rest (under run.fsdp the flat optimizer is
#: off, as in the JAX CLI: the ranks train the tree, one process the flat
#: vector, and the two updates are equal)
SWITCHED = {"caat_fsdp": {"run.fsdp": "true"},
            "caat_zero_flat_dots": {"run.zero": "true",
                                    "run.flat_optimizer": "true",
                                    "run.remat": "dots"},
            "caat_fsdp_flat": {"run.fsdp": "true",
                               "run.flat_optimizer": "true"}}
VALID = ("valid_loss", "valid_bleu", "valid_accuracy")


def _records(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.fixture
def run(request, corpus, audio_corpus, tmp_path, capsys):  # noqa: F811
    """The scenario ``request.param`` in one process and on two ranks ->
    (one process's records, each rank's standard output, the corpus
    directory)."""
    name = request.param
    if name == "pretrain_zero":
        root = audio_corpus
        argv = pretrain_argv(audio_corpus, "two_pretrain_zero",
                             **{"run.zero": "true", "data.max_tokens": 8000,
                                "run.validate_interval_updates": 0})
    else:
        root = corpus[0]
        extra = SWITCHED.get(name, {"run.task": "s2s"})
        argv = caat_overrides(corpus, f"two_{name}", **DROPOUTS,
                              **{"run.eval_bleu": "true"}, **extra)
    single = [a.replace("/two_", "/one_") for a in argv]
    cli.main([a for a in single
              if not a.startswith(("run.fsdp", "run.zero"))])
    one = _records(capsys.readouterr().out)
    worker.run_cli_job({name: {"argv": argv, "stdout": str(tmp_path / name)}},
                       str(tmp_path))
    two = [(tmp_path / f"{name}.{r}").read_text() for r in range(2)]
    return one, two, root


@pytest.mark.parametrize("run", ["caat_fsdp", "s2s_dp", "pretrain_zero",
                                 "caat_zero_flat_dots", "caat_fsdp_flat"],
                         indirect=True)
def test_two_rank_cli_equals_one_process(run, request):
    name = request.node.callspec.params["run"]
    want, two, root = run
    got = _records(two[0])
    assert _records(two[1]) == []                 # rank 0 alone prints
    assert [r["tag"] for r in got] == [r["tag"] for r in want]
    assert len([r for r in got if r["tag"] == "train"]) == 4
    for a, b in zip(got, want):
        keys = COMPARED if a["tag"] == "train" else VALID
        assert [k for k in keys if k in a] == [k for k in keys if k in b]
        for k in (k for k in keys if k in b):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    mine = CheckpointManager(root / f"two_{name}",
                             keep_last=0).restore()[0]
    theirs = CheckpointManager(root / f"one_{name}",
                               keep_last=0).restore()[0]
    assert mine["step"] == theirs["step"] == 4
    for k, v in theirs["model"].items():
        torch.testing.assert_close(mine["model"][k], v, rtol=1e-4,
                                   atol=1e-5, msg=k)
    flat = theirs["opt"].pop("flat", False)
    if flat and name == "caat_fsdp_flat":       # the ranks trained the tree
        assert "flat" not in mine["opt"]
        return
    assert mine["opt"].pop("flat", False) == flat
    for field, tensors in theirs["opt"].items():
        if field == "count":
            assert mine["opt"]["count"] == tensors
            continue
        for a, b in zip(mine["opt"][field], tensors):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
