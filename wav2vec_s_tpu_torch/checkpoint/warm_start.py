"""Stage-to-stage warm start: load a trained encoder into a new model
(port of ``wav2vec_s_tpu/checkpoint/warm_start.py`` for checkpoints of the
port).

Twin of the reference's ``--pretrained-encoder-path`` flow
(rain/models/w2v2_transducer.py:234-244): the published simultaneous-ST
recipe initialises the CAAT model's streaming encoder from a model trained
in an earlier stage.  Accepted source: a checkpoint directory of the port
(the ``save_dir`` of an earlier run, latest step, or one ``step_*``
directory in it).  A fairseq/rain ``.pt`` file is not read yet (ROADMAP
Queue 1 item 9).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch

ENCODER_PREFIX = "encoder."


def load_pretrained_encoder(path) -> Dict[str, torch.Tensor]:
    """The ``encoder.*`` entries of the model state dict saved under
    ``path`` (keys keep their prefix)."""
    from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager

    p = Path(path)
    if p.is_file():
        raise NotImplementedError(
            f"{path}: warm start from a fairseq/rain .pt file is not ported "
            f"(ROADMAP Queue 1 item 9); give a checkpoint directory of "
            f"this package")
    if p.name.startswith("step_"):
        mgr, step = CheckpointManager(p.parent, keep_last=0), int(
            p.name.split("_")[1])
    else:
        mgr, step = CheckpointManager(p, keep_last=0), None
    payload, _ = mgr.restore(step=step)
    if payload is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    enc = {k: v for k, v in payload["model"].items()
           if k.startswith(ENCODER_PREFIX)}
    if not enc:
        raise ValueError(f"{path}: checkpoint has no 'encoder' subtree")
    return enc


def apply_pretrained_encoder(model: torch.nn.Module, path) -> None:
    """Overwrite ``model``'s encoder subtree with the one saved under
    ``path``.  Template-driven, as the JAX package's merge: the source may
    carry extra entries, but every encoder parameter of ``model`` must be
    present in it with the same shape."""
    src = load_pretrained_encoder(path)
    own = {k: v for k, v in model.state_dict().items()
           if k.startswith(ENCODER_PREFIX)}
    for k, v in own.items():
        if k not in src:
            raise ValueError(f"pretrained encoder at {path} is missing {k}")
        if src[k].shape != v.shape:
            raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} vs "
                             f"{tuple(src[k].shape)}")
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(src[k])
