"""Stage-to-stage warm start: load a trained encoder into a new model
(port of ``wav2vec_s_tpu/checkpoint/warm_start.py`` for checkpoints of the
port).

Twin of the reference's ``--pretrained-encoder-path`` flow
(rain/models/w2v2_transducer.py:234-244): the published simultaneous-ST
recipe initialises the CAAT model's streaming encoder from a model trained
in an earlier stage.  Accepted sources:

- a checkpoint directory of the port (the ``save_dir`` of an earlier run,
  latest step, or one ``step_*`` directory in it): its ``encoder.*``
  entries (a seq2seq or CAAT run), or the wav2vec2 weights of a CTC run
  (``w2v_encoder.w2v_model.*``, read as ``encoder.w2v2_model.*``);
- a fairseq / rain ``.pt`` file: the wav2vec2 weights under the first of
  ``TORCH_PREFIXES`` that holds a conv front-end (rain's
  ``OnlineW2V2TransformerEncoder``, fairseq's fine-tuned heads, a bare
  pre-trained model), imported by ``torch_import`` as the CAAT encoder's
  ``encoder.w2v2_model.*``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch
from torch import nn

ENCODER_PREFIX = "encoder."
W2V2_PREFIX = "encoder.w2v2_model."
CTC_PREFIX = "w2v_encoder.w2v_model."    # models/asr.Wav2VecCtc
TORCH_PREFIXES = (
    "encoder.w2v2_model.",      # rain OnlineW2V2TransformerEncoder
    "w2v_encoder.w2v_model.",   # fairseq wav2vec2_asr fine-tune heads
    "",                         # bare Wav2Vec2 / wav2vec-S pre-train model
)


def _from_torch_file(path, w2v_model) -> Dict[str, torch.Tensor]:
    from wav2vec_s_tpu_torch.checkpoint.torch_import import (
        load_torch_checkpoint, wav2vec2_state_dict)

    sd = load_torch_checkpoint(path)
    sd = sd["model"] if "model" in sd else sd
    for prefix in TORCH_PREFIXES:
        if any(k.startswith(prefix + "feature_extractor.") for k in sd):
            return {W2V2_PREFIX + k: v for k, v in wav2vec2_state_dict(
                sd, w2v_model, prefix).items()}
    raise ValueError(f"{path}: no wav2vec2 encoder weights found under any "
                     f"known prefix {TORCH_PREFIXES}")


def load_pretrained_encoder(path, w2v_model: Optional[nn.Module] = None
                            ) -> Dict[str, torch.Tensor]:
    """The ``encoder.*`` entries of the model state dict saved under
    ``path`` (keys keep their prefix).  A ``.pt`` file needs the
    ``Wav2Vec2Model`` it is imported for (``w2v_model``: its config and
    heads decide what is kept)."""
    from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager

    p = Path(path)
    if p.is_file():
        if w2v_model is None:
            raise ValueError(f"{path}: importing a .pt encoder needs the "
                             f"Wav2Vec2Model it is for")
        return _from_torch_file(p, w2v_model)
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
    enc.update({W2V2_PREFIX + k[len(CTC_PREFIX):]: v
                for k, v in payload["model"].items()
                if k.startswith(CTC_PREFIX)})
    if not enc:
        raise ValueError(f"{path}: checkpoint has no 'encoder' subtree")
    return enc


def apply_pretrained_encoder(model: torch.nn.Module, path) -> None:
    """Overwrite ``model``'s encoder subtree with the one saved under
    ``path`` (from a ``.pt``: the wav2vec2 part, ``encoder.w2v2_model.*``).
    ``model`` is a CAAT (the fbank family's too, from a directory only) or
    seq2seq model (its ``encoder.*``) or a
    ``Wav2VecCtc`` (its ``w2v_encoder.w2v_model.*``, read from the
    source's ``encoder.w2v2_model.*``).  Template-driven, as the JAX
    package's merge: the source may carry extra entries, but every encoder
    parameter of ``model`` must be present in it with the same shape."""
    is_file = Path(path).is_file()
    ctc = hasattr(model, "w2v_encoder")
    src = load_pretrained_encoder(path, None if not is_file else (
        model.w2v_encoder.w2v_model if ctc
        else getattr(model.encoder, "w2v2_model", None)))
    prefix = (CTC_PREFIX if ctc else W2V2_PREFIX if is_file
              else ENCODER_PREFIX)
    own = {k: v for k, v in model.state_dict().items()
           if k.startswith(prefix)}
    name = ({k: W2V2_PREFIX + k[len(CTC_PREFIX):] for k in own} if ctc
            else {k: k for k in own})
    for k, v in own.items():
        if name[k] not in src:
            raise ValueError(f"pretrained encoder at {path} is missing "
                             f"{name[k]}")
        if src[name[k]].shape != v.shape:
            raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} vs "
                             f"{tuple(src[name[k]].shape)}")
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(src[name[k]])
