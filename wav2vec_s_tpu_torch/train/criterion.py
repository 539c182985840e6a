"""Pre-training criterion: InfoNCE plus the weighted extra losses (port of
``wav2vec_s_tpu/train/criterion.py``).

Behavioral twin of ``Wav2vecCriterion`` with ``infonce=true,
loss_weights=[0.1, 10]`` (fairseq/fairseq/criterions/wav2vec_criterion.py:
36-160 and the wav2vec-S yaml): summed cross-entropy over the masked frames
with the positive at class 0, plus ``0.1 * (V - prob_ppl) / V *
sample_size`` (codebook diversity) and ``10 * features_pen * sample_size``
(feature L2), where ``sample_size = B * M`` masked frames.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

DEFAULT_LOSS_WEIGHTS = (0.1, 10.0)


def wav2vec_loss(net_output: Dict[str, object],
                 loss_weights: Sequence[float] = DEFAULT_LOSS_WEIGHTS
                 ) -> Tuple[torch.Tensor, int, Dict[str, object]]:
    """(summed loss, sample_size, logs) of a pre-training forward's output.
    ``correct`` counts a frame whose positive is the largest logit and not
    also the smallest (all logits equal): ties count as wrong (criterion
    :138-152); the ``-inf`` distractors are the smallest."""
    logits = net_output["logits"].float()                     # [B, M, 1+N]
    B, M, _ = logits.shape
    sample_size = B * M

    main_loss = -torch.log_softmax(logits, dim=-1)[:, :, 0].sum()
    extra = []
    if net_output.get("prob_perplexity") is not None:
        V = net_output["num_vars"]
        extra.append((V - net_output["prob_perplexity"]) / V)
    extra.append(net_output["features_pen"])
    w = tuple(loss_weights)
    if len(w) == 1:
        w = w * len(extra)
    if len(w) != len(extra):
        raise ValueError(f"{len(w)} loss weights for {len(extra)} extra "
                         f"losses")

    loss = main_loss
    logs: Dict[str, object] = {"loss_infonce": main_loss,
                               "sample_size": sample_size}
    for i, (coef, p) in enumerate(zip(w, extra)):
        if coef != 0:
            pl = coef * p.float() * sample_size
            loss = loss + pl
            logs[f"loss_extra_{i}"] = pl

    is_max = logits.argmax(dim=-1) == 0
    is_min = logits.argmin(dim=-1) == 0
    correct = is_max.sum() - (is_max & is_min).sum()
    logs.update(loss=loss, correct=correct,
                count=torch.tensor(float(B * M), device=logits.device),
                prob_perplexity=net_output.get("prob_perplexity"),
                code_perplexity=net_output.get("code_perplexity"),
                temp=net_output.get("temp"))
    return loss, sample_size, logs
