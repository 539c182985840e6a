"""Training CLI: ``python -m wav2vec_s_tpu_torch.train.cli --config cfg.yaml
[--device cuda|cpu] [section.key=value ...]``.

Port of ``wav2vec_s_tpu/train/cli.py`` for wav2vec-S streaming pre-training
(``run.task=pretrain``: span masking, the Gumbel quantizer, the contrastive
head, a block context sampled per update under
``context.context_type=sampling``), CAAT fine-tuning (``run.task=caat``)
on raw audio, on log-mel features (``data.features=fbank``: the fbank
family, ``caat.frontend`` / ``caat.jointer_type``) or on source text
(``data.features=text``: the text family, a parallel-text manifest) and
the offline-ASR heads (``run.task=s2s``: the
seq2seq model whose encoder seeds CAAT; ``run.task=ctc``): the fairseq
training program's epoch/update loop
(fairseq/fairseq_cli/train.py:52-488 + trainer.py) with max-tokens batches,
periodic validation and checkpointing with keep-K/best policies, patience
early stop, json progress records and resume.  The same yaml and the same
``section.key=value`` overrides drive both packages; fairseq ``.pt`` warm
starts (``run.load_pretrained_model_from``, ``run.w2v2_model_path``, a
``.pt`` ``run.pretrained_encoder_path``) go through
``checkpoint/torch_import.py``: a stock wav2vec 2.0 ``.pt`` under
``model.extractor_mode=default`` keeps its group norm, and its conv
positions are dropped (the encoder is blockwise, as the JAX CLI builds
it).

What differs from the JAX CLI, on purpose:
- ``--device`` (default ``cuda``) takes the place of ``--platform``; the
  model, the optimizer state and every batch live on that device.
- Nothing is compiled: "one step function per (mc, rc, ds) bucket" is a
  dictionary of closures over one model.
- The randomness of update ``n`` (dropout seed, layerdrop, decoder position
  offsets, negatives, Gumbel noise, the sampled decision step, the sampled
  (mc, rc)) is a function of ``(run.seed, n)``, as
  ``jax.random.fold_in(base_rng, n)`` is there, and a pre-training batch's
  crops and masks are a function of ``(data.seed, epoch, batch offset)``,
  so a resumed run continues exactly.  The iterator state that is saved is
  the consumer's position, not the prefetch thread's.
- Validation runs the loss in eval mode (no dropout, no layerdrop; in
  pre-training hard codes and negatives of a fixed seed) under
  ``torch.no_grad()``.  ``run.eval_bleu`` (and ``run.eval_wer`` for CTC)
  decode the validation set greedily (``eval/generator.py``) and track
  BLEU (WER) for the best checkpoint and patience, as the JAX CLI does.
  Under a process group each data rank decodes its rows, the ranks'
  decoding loops stop together, and every rank scores the gathered
  hypotheses in the global batch's row order (the JAX CLI decodes only in
  a single process; one process per card is the port's data
  parallelism).
- A batch that runs out of device memory is skipped as the fairseq trainer
  does (trainer.py:700-720): gradients freed, the allocator's cache
  emptied, the skip counted in the next progress record (``oom_skipped``).
  Not under a process group: one rank's skip would leave the others
  waiting in a collective, so there it raises.
- Parallel runs (``parallel/``): launched by ``python -m
  torch.distributed.run --nproc-per-node N -m wav2vec_s_tpu_torch.train.cli
  ...`` (or in a process whose default group is already started), one
  process per device (``cuda:{LOCAL_RANK}``; ``nccl`` on the card,
  ``gloo`` on the CPU).  ``run.num_devices``, when set, must equal the
  world size; ``run.seq`` ranks split the encoder's time axis (context
  parallelism), the rest form the ``data`` dim; ``run.zero`` shards the
  optimizer moments and ``run.fsdp`` the parameters over it, with or
  without ``run.seq``.  (Tensor parallelism and the pipeline, like the
  JAX CLI's, are not options of the trainer: ``parallel/sharding.py`` and
  ``parallel/pipeline.py`` run them by hand.)  As in the
  JAX CLI every batch is a multiple of the data width and each rank
  collates its contiguous rows with the global batch's shapes; a rank's
  dropout masks and host draws are its rows' part of the global batch's,
  so a DP step equals one process over the global batch.  Validation sums
  loss and count over the data ranks; rank 0 alone prints the progress
  and writes checkpoints (in the single-process layout).
- The fbank family's ``TFMask`` draws from the batcher's generator in
  collate order, as the JAX one does; the JAX CLI collates two rows for
  its ``init_params`` first (the port does not), and under data
  parallelism each rank masks its own rows.
- ``run.debug_nan``: a ``utils/debug.Watchdog(600)`` pinged every update,
  and every update's loss read on the host; a non-finite loss raises
  ``FloatingPointError`` naming the non-finite logs and parameters (by
  their fairseq names).  ``run.profile_dir``: a ``torch.profiler`` trace
  of updates [10, 20) (CPU and CUDA activity) written as
  ``<profile_dir>/trace.json``, stopped early if the run ends inside the
  window.  Its program spans (``utils/debug.span``): ``w2vs/train.data_wait``
  (the wait for the next batch of ``prefetch_batches``), and from
  ``train/step.py`` ``w2vs/train.forward`` and ``w2vs/train.backward`` per
  micro-batch and ``w2vs/train.optimizer`` (reduce, clip and update).
- ``run.remat`` rematerializes the loss forward (``train/remat.py``) and
  ``run.flat_optimizer`` runs the optimizer over one flat vector
  (``train/step.py``), as in the JAX CLI; the flat optimizer is off under
  ``run.fsdp`` (said on stderr), and under tensor parallelism it raises.
- No configuration key is ignored silently (``data.features=fbank|text``
  outside ``run.task=caat``, and ``caat.frontend`` /
  ``caat.jointer_type`` outside the fbank family, raise where the JAX CLI
  ignores them).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import math
import random
import sys
from typing import Dict, Optional

import numpy as np
import torch

from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
from wav2vec_s_tpu_torch.data.batching import (
    EpochBatchIterator, batch_by_size, length_buckets)
from wav2vec_s_tpu_torch.data.dataset import (
    CaatBatcher, PretrainBatcher, TextBatcher, to_device)
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.data.manifests import (
    read_audio_manifest, read_s2t_manifest, read_text_manifest)
from wav2vec_s_tpu_torch.data.prefetch import prefetch_batches
from wav2vec_s_tpu_torch.data.tokenizer import build_tokenizer
from wav2vec_s_tpu_torch.data.transforms import TFMask, Whiten
from wav2vec_s_tpu_torch.models import Wav2Vec2Config, Wav2Vec2Model
from wav2vec_s_tpu_torch.models.caat import CaatConfig, W2V2CaatModel
from wav2vec_s_tpu_torch.models.modules import random_init_
from wav2vec_s_tpu_torch.train.config import TrainConfig, load_config
from wav2vec_s_tpu_torch.train.optim import build_optimizer
from wav2vec_s_tpu_torch.train.recipes import (
    make_caat_loss_fn, make_ctc_loss_fn, make_freeze_mask,
    make_pretrain_loss_fn, make_s2s_loss_fn, sample_context_bucket)
from wav2vec_s_tpu_torch.train.remat import REMAT_POLICIES
from wav2vec_s_tpu_torch.train.step import TrainState, make_train_step
from wav2vec_s_tpu_torch.utils.debug import span
from wav2vec_s_tpu_torch.utils.metrics import JsonProgress, TimeMeter


TASKS = ("pretrain", "caat", "s2s", "ctc")
FEATURES = ("raw", "fbank", "text")


def check_supported(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for a value the trainer does not take."""
    run, data = cfg.run, cfg.data
    if run.task not in TASKS:
        raise ValueError(f"run.task={run.task!r} is not one of {TASKS}")
    if data.features not in FEATURES:
        raise ValueError(f"data.features={data.features!r} is not one of "
                         f"{FEATURES}")
    if data.features != "raw" and run.task != "caat":
        raise ValueError(f"data.features={data.features} trains the fbank "
                         f"and text CAAT families: run.task=caat, not "
                         f"{run.task!r}")
    for key in ("frontend", "jointer_type"):
        default = getattr(CaatConfig, key)
        value = cfg.caat.get(key, default)
        if value != default and data.features != "fbank":
            raise ValueError(f"caat.{key}={value} picks a module of the "
                             f"fbank family (data.features=fbank), not of "
                             f"data.features={data.features}")
    if run.remat not in REMAT_POLICIES:
        raise ValueError(f"run.remat={run.remat!r} is not one of "
                         f"{REMAT_POLICIES}")


def _config(cls, kwargs: Dict, section: str, **fixed):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(kwargs) - known)
    if unknown:
        raise ValueError(
            f"{section}.{unknown[0]} is not a field of {cls.__name__}")
    kw = {k: (tuple(map(tuple, v)) if k == "conv_feature_layers"
              else tuple(v) if isinstance(v, list) else v)
          for k, v in kwargs.items()}
    return cls(**kw, **fixed)


def encoder_config(cfg: TrainConfig) -> Wav2Vec2Config:
    """The fine-tuning encoder's config: the ``model`` section with the
    ``context`` section's (mc, rc)."""
    return _config(Wav2Vec2Config, cfg.model, "model",
                   main_context=cfg.context.main_context,
                   right_context=cfg.context.right_context)


def caat_configs(cfg: TrainConfig, vocab_size: int):
    """(Wav2Vec2Config, CaatConfig) of the configuration's ``model``,
    ``caat`` and ``context`` sections."""
    caat_cfg = _config(CaatConfig, cfg.caat, "caat", vocab_size=vocab_size)
    return encoder_config(cfg), caat_cfg


def _s2t_data(cfg: TrainConfig):
    """(manifest, target dict, batcher) of a fine-tuning run on audio: the
    S2T tsv, its dictionary, ``CaatBatcher`` over the 640-multiple pad grid
    of samples, or for fbank over a 16-multiple grid of log-mel frames
    (10 ms shift) with ``Whiten`` and, under ``data.specaugment``,
    ``TFMask``."""
    data = cfg.data
    manifest = read_s2t_manifest(data.train_manifest, data.audio_root)
    tgt_dict = Dictionary.load(data.vocab)
    tokenizer = build_tokenizer(data.tokenizer, data.spm_model or None,
                                data.bpe_dropout)
    transforms = ()
    if data.features == "fbank":
        audio_buckets = length_buckets(data.max_sample_size // 160,
                                       multiple=16)
        transforms = (Whiten(),) + (
            (TFMask(seed=data.seed),) if data.specaugment else ())
    else:
        audio_buckets = length_buckets(data.max_sample_size, multiple=640)
    batcher = CaatBatcher(manifest, tgt_dict, tokenizer, audio_buckets,
                          task_type=data.task_type, normalize=data.normalize,
                          features=data.features, transforms=transforms)
    return manifest, tgt_dict, batcher


def _init_fine_tuning(cfg: TrainConfig, model, w2v_model):
    """Seeded random weights, then the pre-trained wav2vec2 weights
    (``run.w2v2_model_path``) over ``w2v_model`` (None: the fbank family,
    which ignores the path as the JAX CLI does), then the fine-tuned
    encoder of ``run.pretrained_encoder_path``, which wins (the reference
    order).  Returns ``model``."""
    random_init_(model, torch.Generator().manual_seed(cfg.run.seed))
    if cfg.run.w2v2_model_path and w2v_model is not None:
        from wav2vec_s_tpu_torch.checkpoint.torch_import import (
            load_torch_checkpoint, load_wav2vec2_)
        load_wav2vec2_(w2v_model, load_torch_checkpoint(
            cfg.run.w2v2_model_path)["model"])
        print(f"wav2vec2 encoder initialized from {cfg.run.w2v2_model_path}",
              file=sys.stderr)
    if cfg.run.pretrained_encoder_path:
        from wav2vec_s_tpu_torch.checkpoint.warm_start import (
            apply_pretrained_encoder)
        apply_pretrained_encoder(model, cfg.run.pretrained_encoder_path)
        print(f"encoder initialized from {cfg.run.pretrained_encoder_path}",
              file=sys.stderr)
    return model


def build_caat(cfg: TrainConfig):
    """(manifest, batcher, model, caat_cfg, make_loss) of a CAAT run
    (``wav2vec_s_tpu/train/cli.py`` ``build_caat``): ``W2V2CaatModel`` on
    raw audio, ``FbankCaatModel`` on log-mel features, or the text family
    (``build_text_caat``)."""
    if cfg.data.features == "text":
        return build_text_caat(cfg)
    manifest, tgt_dict, batcher = _s2t_data(cfg)
    model_cfg, caat_cfg = caat_configs(cfg, len(tgt_dict))
    if cfg.data.features == "fbank":
        from wav2vec_s_tpu_torch.models.fbank import FbankCaatModel

        model = _init_fine_tuning(cfg, FbankCaatModel(model_cfg, caat_cfg),
                                  None)
    else:
        model = W2V2CaatModel(model_cfg, caat_cfg)
        _init_fine_tuning(cfg, model, model.encoder.w2v2_model)

    def make_loss(mc, rc, downsample=None, train=True, plan=None):
        return make_caat_loss_fn(model, caat_cfg, mc, rc,
                                 downsample=downsample, train=train,
                                 plan=plan)

    return manifest, batcher, model, caat_cfg, make_loss


def build_text_caat(cfg: TrainConfig):
    """(manifest, batcher, model, caat_cfg, make_loss) of simultaneous text
    translation with the attention transducer (``run.task=caat`` +
    ``data.features=text``; JAX ``build_text_caat``): the reference's text
    side of the CAAT family (rain/models/caat_transformer.py text encoder,
    trained by rain/tasks/dropout_translation.py over fairseq bitext with
    BPE dropout).  Manifest: a tsv with src_text/tgt_text columns or a
    ``src.txt,tgt.txt`` pair; ``data.src_vocab`` a separate source
    dictionary; block contexts count token positions.  Seeded random
    weights: as in the JAX CLI, no warm start reaches this family."""
    from wav2vec_s_tpu_torch.models.text_caat import TextCaatModel

    data = cfg.data
    manifest = read_text_manifest(data.train_manifest)
    tgt_dict = Dictionary.load(data.vocab)
    src_dict = Dictionary.load(data.src_vocab) if data.src_vocab else None
    tokenizer = build_tokenizer(data.tokenizer, data.spm_model or None,
                                data.bpe_dropout)
    batcher = TextBatcher(manifest, tgt_dict, tokenizer, src_dict=src_dict)
    model_cfg, caat_cfg = caat_configs(cfg, len(tgt_dict))
    model = random_init_(
        TextCaatModel(model_cfg, caat_cfg,
                      src_vocab_size=len(src_dict) if src_dict else 0),
        torch.Generator().manual_seed(cfg.run.seed))

    def make_loss(mc, rc, downsample=None, train=True, plan=None):
        return make_caat_loss_fn(model, caat_cfg, mc, rc,
                                 downsample=downsample, train=train,
                                 plan=plan)

    return manifest, batcher, model, caat_cfg, make_loss


def build_s2s(cfg: TrainConfig):
    """(manifest, batcher, model, caat_cfg, make_loss) of an offline
    seq2seq run (JAX ``build_s2s``): the reference's
    ``online_w2v2_transformer_offline`` stage
    (train_wav2vec_s_offline_asr_base.sh), whose encoder seeds the CAAT ST
    model through ``run.pretrained_encoder_path``."""
    from wav2vec_s_tpu_torch.models.asr import Wav2Vec2Seq2Seq

    manifest, tgt_dict, batcher = _s2t_data(cfg)
    model_cfg, caat_cfg = caat_configs(cfg, len(tgt_dict))
    model = Wav2Vec2Seq2Seq(model_cfg, caat_cfg)
    _init_fine_tuning(cfg, model, model.encoder.w2v2_model)

    def make_loss(mc, rc, downsample=None, train=True, plan=None):
        return make_s2s_loss_fn(model, caat_cfg, mc, rc,
                                label_smoothing=cfg.run.label_smoothing,
                                train=train, plan=plan)

    return manifest, batcher, model, caat_cfg, make_loss


def build_ctc(cfg: TrainConfig):
    """(manifest, batcher, model, None, make_loss) of a CTC fine-tuning run
    (JAX ``build_ctc``): the reference's fork-shipped ``Wav2VecCtc`` head
    (fairseq wav2vec2_asr.py:154, criterions/ctc.py, blank = bos) over the
    S2T manifest, ``task_type: asr`` transcripts as targets."""
    from wav2vec_s_tpu_torch.models.asr import Wav2VecCtc

    manifest, tgt_dict, batcher = _s2t_data(cfg)
    model = Wav2VecCtc(encoder_config(cfg), vocab_size=len(tgt_dict),
                       final_dropout=cfg.run.final_dropout)
    _init_fine_tuning(cfg, model, model.w2v_encoder.w2v_model)

    def make_loss(mc, rc, downsample=None, train=True, plan=None):
        return make_ctc_loss_fn(model, pad=tgt_dict.pad(), eos=tgt_dict.eos(),
                                main_context=mc, right_context=rc,
                                blank=tgt_dict.bos(), train=train, plan=plan)

    return manifest, batcher, model, None, make_loss


def pretrain_config(cfg: TrainConfig) -> Wav2Vec2Config:
    """The pre-training model's config: the ``model`` section with the
    ``context`` section's type and (mc, rc) (JAX ``build_pretrain``)."""
    return _config(Wav2Vec2Config, cfg.model, "model",
                   context_type=cfg.context.context_type,
                   main_context=cfg.context.main_context,
                   right_context=cfg.context.right_context)


def build_pretrain(cfg: TrainConfig):
    """(manifest, batcher, model, make_loss) of a wav2vec-S pre-training
    run (``wav2vec_s_tpu/train/cli.py`` ``build_pretrain``).  As there, the
    batcher masks with its own defaults (mask_prob 0.65, mask_length 10),
    not the model section's; it counts frames with the model's conv stack
    (the JAX batcher always takes the default one)."""
    manifest = read_audio_manifest(cfg.data.train_manifest,
                                   cfg.data.min_sample_size)
    buckets = length_buckets(cfg.data.max_sample_size,
                             min_len=cfg.data.min_sample_size, multiple=640)
    model_cfg = pretrain_config(cfg)
    batcher = PretrainBatcher(manifest, buckets, normalize=cfg.data.normalize,
                              seed=cfg.data.seed,
                              conv_layers=model_cfg.conv_feature_layers)
    model = random_init_(Wav2Vec2Model(model_cfg, pretraining=True),
                         torch.Generator().manual_seed(cfg.run.seed))
    if cfg.run.load_pretrained_model_from:
        from wav2vec_s_tpu_torch.checkpoint.torch_import import (
            load_torch_checkpoint, load_wav2vec2_)
        load_wav2vec2_(model, load_torch_checkpoint(
            cfg.run.load_pretrained_model_from)["model"])
        print(f"model initialized from "
              f"{cfg.run.load_pretrained_model_from}", file=sys.stderr)

    def make_loss(mc, rc, downsample=None, train=True, plan=None):
        return make_pretrain_loss_fn(model, mc, rc, train=train, plan=plan)

    return manifest, batcher, model, make_loss


def main(argv=None):
    parser = argparse.ArgumentParser(description="wav2vec_s_tpu_torch trainer")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (cpu for testing)")
    parser.add_argument("overrides", nargs="*", default=[])
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    check_supported(cfg)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(give --device cpu to run on the host)")
    plan, started = _parallel_plan(cfg, device.type)
    if plan is not None:
        from wav2vec_s_tpu_torch.parallel.mesh import device_for
        device = device_for(device.type, _local_rank())
    try:
        _train(cfg, device, plan)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _local_rank() -> int:
    import os

    import torch.distributed as dist
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _parallel_plan(cfg: TrainConfig, device_type: str):
    """(the run's ``ParallelPlan`` or None, whether this call started the
    process group).  A run is parallel when ``torch.distributed.run``
    launched it (or the default group is already started); a parallel
    setting without one raises."""
    import torch.distributed as dist

    from wav2vec_s_tpu_torch.parallel import mesh as pmesh
    from wav2vec_s_tpu_torch.parallel.sharding import ParallelPlan

    run = cfg.run
    started = False
    if not dist.is_initialized():
        if not pmesh.launched():
            if run.num_devices > 1 or run.zero or run.fsdp or run.seq > 1:
                raise RuntimeError(
                    f"run.num_devices={run.num_devices} / run.zero="
                    f"{run.zero} / run.fsdp={run.fsdp} / run.seq={run.seq} "
                    f"need a process group: launch with python -m "
                    f"torch.distributed.run --nproc-per-node N")
            return None, False
        pmesh.init_from_env(device_type)
        started = True
    world = dist.get_world_size()
    if run.num_devices and run.num_devices != world:
        raise ValueError(f"run.num_devices={run.num_devices} but "
                         f"{world} processes were launched")
    if world % run.seq:
        raise ValueError(f"run.seq={run.seq} does not divide the {world} "
                         f"processes")
    if run.seq > 1:
        # the encoder splits its time axis over the mesh's seq dim (the
        # JAX CLI sets the same default)
        cfg.model.setdefault("seq_axis", pmesh.AXES.seq)
    mesh = pmesh.make_mesh(world // run.seq, n_seq=run.seq,
                           device_type=device_type)
    mode = "fsdp" if run.fsdp else "zero" if run.zero else "dp"
    return ParallelPlan(mesh, mode), started


def _step_seed(seed: int, step: int) -> int:
    """The 63-bit seed of update ``step``'s randomness, a function of
    ``(run.seed, step)`` alone; hashed, because generators seeded with
    neighbouring integers start out correlated."""
    digest = hashlib.sha256(f"{seed}:{step}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _keyed(epoch_itr, epoch: int, start: int):
    """The epoch's batches from offset ``start`` on, as ``((epoch, batch
    offset), indices)``: the key of each batch's collation draws."""
    for offset, batch_idx in enumerate(epoch_itr, start):
        yield (epoch, offset), batch_idx


def _waited(batches):
    """``batches`` (a generator), each wait for the next one under the span
    ``train.data_wait``; closes ``batches`` when the consumer stops."""
    end = object()
    try:
        while True:
            with span("train.data_wait"):
                item = next(batches, end)
            if item is end:
                return
            yield item
    finally:
        batches.close()


def _train(cfg: TrainConfig, device: torch.device, plan=None):
    run = cfg.run
    pretrain = run.task == "pretrain"
    n_data = 1 if plan is None else plan.n_data
    writer = plan is None or plan.writer
    if pretrain:
        manifest, batcher, model, make_loss = build_pretrain(cfg)
        # crop-only batches: sizes clipped to the largest bucket, the crop
        # bucket hinted by the batch's shortest wav
        sizes = np.minimum(np.asarray(manifest.sizes),
                           cfg.data.max_sample_size)
        sampled_steps = None
    else:
        build = {"s2s": build_s2s, "ctc": build_ctc}.get(run.task, build_caat)
        manifest, batcher, model, caat_cfg, make_loss = build(cfg)
        sizes = np.asarray(manifest.n_frames)
        # sampled decision-step training (reference step_mode=random,
        # rain/layers/attention_transducer.py:800-815): one trained model
        # serves every DECISION_STEP eval point.  Host-side draw per update.
        sampled_steps = (caat_cfg.sampled_steps if run.task == "caat"
                         and caat_cfg.step_mode == "random" else None)
    fbank = cfg.data.features == "fbank"

    def hint(batch_sizes) -> int:
        """The pad (crop) bucket's size hint of a batch: its longest row
        (pre-training: shortest); samples, log-mel frames for fbank."""
        if pretrain:
            return int(np.min(batch_sizes))
        return int(np.max(batch_sizes)) // (160 if fbank else 1)

    model.to(device)
    if plan is not None:
        plan.prepare(model)
        if plan.seq_group is not None:
            from wav2vec_s_tpu_torch.parallel.context import enable
            enable(model, plan.seq_group)

    batches = _batches(sizes, cfg.data.max_tokens, n_data)
    if not batches:
        raise ValueError(
            "the training manifest gives no batch" + (
                f" of at least {n_data} rows (the data-parallel width)"
                if n_data > 1 else ""))
    itr = EpochBatchIterator(batches, seed=cfg.data.seed)

    optimizer = build_optimizer(cfg.optim)
    # the flat optimizer is off under FSDP, as in the JAX CLI: a rank holds
    # no whole parameter to ravel
    flat_opt = run.flat_optimizer and not run.fsdp
    if run.flat_optimizer and run.fsdp and writer:
        print("run.flat_optimizer is off under run.fsdp: the optimizer "
              "updates each parameter's rows", file=sys.stderr)
    state = TrainState.create(model, optimizer, plan,
                              flat_optimizer=flat_opt)

    mgr = CheckpointManager(run.save_dir, keep_last=run.keep_last,
                            keep_best=run.keep_best,
                            async_save=run.async_checkpoints, writer=writer)
    if run.restore_from or mgr.latest_step() is not None:
        src = CheckpointManager(run.restore_from) if run.restore_from else mgr
        restored, meta = src.restore(template=state)
        if restored is not None:
            if meta and meta.get("extra", {}).get("iterator"):
                itr.load_state_dict(meta["extra"]["iterator"])
            print(f"restored checkpoint at step {state.step}",
                  file=sys.stderr)

    grad_mask = None
    if run.freeze_w2v2_enc or run.freeze_finetune_updates:
        grad_mask = make_freeze_mask(model, run.freeze_w2v2_enc,
                                     run.freeze_finetune_updates)

    # one step function per context bucket and decision step
    steps = {}

    def get_step(mc, rc, ds=None):
        if (mc, rc, ds) not in steps:
            steps[(mc, rc, ds)] = make_train_step(
                make_loss(mc, rc, ds, plan=plan), optimizer,
                accum_steps=run.update_freq, grad_mask=grad_mask,
                remat_policy=run.remat)
        return steps[(mc, rc, ds)]

    # sampled block contexts (pre-training, context_type=sampling): one
    # (mc, rc) bucket drawn per update, one step function per bucket
    sampled_contexts = pretrain and cfg.context.context_type == "sampling"
    mc0, rc0 = cfg.context.main_context, cfg.context.right_context

    # validation: eval-mode loss over the valid manifest (patience early
    # stop like fairseq_cli/train.py:209-236)
    valid_setup = None
    if cfg.data.valid_manifest:
        if pretrain:
            vman = read_audio_manifest(cfg.data.valid_manifest,
                                       cfg.data.min_sample_size)
            vsizes = np.minimum(np.asarray(vman.sizes),
                                cfg.data.max_sample_size)
            vbatcher = dataclasses.replace(batcher, manifest=vman)
        else:
            vman = (read_text_manifest(cfg.data.valid_manifest)
                    if cfg.data.features == "text" else
                    read_s2t_manifest(cfg.data.valid_manifest,
                                      cfg.data.audio_root))
            vsizes = np.asarray(vman.n_frames)
            vbatcher = _valid_batcher(batcher, vman)
        valid_setup = (vbatcher, _batches(vsizes, cfg.data.max_tokens,
                                          n_data),
                       vsizes, make_loss(mc0, rc0, train=False),
                       _valid_decoder(cfg, model, vbatcher, plan))

    @torch.no_grad()
    def validate():
        """(loss per sample, BLEU / WER of the greedy decode or None,
        accuracy (s2s) or None)."""
        from wav2vec_s_tpu_torch.stream.searcher import detok_pieces

        vbatcher, vbatches, vsz, vloss_fn, vdecode = valid_setup
        tot = torch.zeros(3, dtype=torch.float64)
        pairs = []             # per batch: (hypothesis, reference) per row
        for i, bidx in enumerate(vbatches):
            keyed = {"key": (0, i)} if pretrain else {}
            rows = _rows(len(bidx))
            hb = vbatcher.collate(bidx, size_hint=hint(vsz[bidx]),
                                  rows=rows, **keyed)
            vb = to_device(hb, device)
            loss, size, logs = vloss_fn(vb, None, 0)
            tot += torch.tensor([float(loss), float(size),
                                 float(logs.get("n_correct", 0.0))],
                                dtype=torch.float64)
            if vdecode is not None:
                pfx, lens = vdecode(vb["source"], vb.get("padding_mask"))
                texts = (vman.src_texts if cfg.data.task_type == "asr"
                         else vman.tgt_texts)
                local = bidx if rows is None else bidx[rows]
                pairs.append([(detok_pieces(vbatcher.tgt_dict,
                                            vbatcher.tokenizer,
                                            pfx[r, 1:lens[r]]), texts[row])
                              for r, row in enumerate(local)])
        if plan is not None:
            import torch.distributed as dist
            dist.all_reduce(tot, group=plan.data_group)
            if vdecode is not None:
                # every data rank's rows of each batch, in rank order: the
                # global batch's row order
                parts = [None] * plan.n_data
                dist.all_gather_object(parts, pairs, group=plan.data_group)
                pairs = [sum((p[i] for p in parts), [])
                         for i in range(len(pairs))]
        hyps = [h for batch in pairs for h, _ in batch]
        refs = [r for batch in pairs for _, r in batch]
        n = max(float(tot[1]), 1.0)
        vacc = float(tot[2]) / n if run.task == "s2s" else None
        if vdecode is None:
            return float(tot[0]) / n, None, vacc
        if run.task == "ctc":
            from wav2vec_s_tpu_torch.eval.wer import corpus_wer
            return float(tot[0]) / n, corpus_wer(hyps, refs), vacc
        from wav2vec_s_tpu_torch.eval.bleu import corpus_bleu
        return float(tot[0]) / n, corpus_bleu(hyps, refs), vacc

    def _rows(n_rows):
        if plan is None:
            return None
        from wav2vec_s_tpu_torch.parallel.mesh import process_local_rows
        return process_local_rows(n_rows, plan.mesh)

    def collate_train(item):
        key, batch_idx = item
        keyed = {"key": key} if pretrain else {}
        host_batch = batcher.collate(
            batch_idx, size_hint=hint(sizes[batch_idx]),
            rows=_rows(len(batch_idx)), **keyed)
        if run.update_freq > 1:
            host_batch = {k: _microbatch(v, run.update_freq)
                          for k, v in host_batch.items()}
        return host_batch

    # failure detection behind run.debug_nan (fairseq nan_detector.py via
    # trainer.py:801-811 + DistributedTimeoutWrapper): name the non-finite
    # logs and parameters instead of silently skipping the update, and
    # signal the process if no update completes for 10 minutes
    watchdog = None
    if run.debug_nan:
        from wav2vec_s_tpu_torch.utils.debug import NanDetector, Watchdog
        watchdog = Watchdog(timeout=600.0)

    def check_finite(logs):
        if watchdog is None:
            return
        watchdog.ping()
        if not math.isfinite(float(logs["loss_total"])):
            bad = (NanDetector.check(logs, "logs")
                   + NanDetector.check(dict(model.named_parameters()),
                                       "params"))
            raise FloatingPointError(
                "non-finite loss; offending tensors: " + "; ".join(bad))

    # run.profile_dir (the --profile twin): trace updates [10, 20) once warm
    profile = None

    progress = JsonProgress(tensorboard_dir=run.tensorboard_dir or None)
    speed = TimeMeter()
    gen = torch.Generator()
    window: Dict[str, list] = {}
    best_valid, bad_validations = float("inf"), 0
    oom_skipped = oom_in_a_row = 0
    stop = False
    logs: Optional[Dict[str, torch.Tensor]] = None

    # host-side step mirror: the hot loop keeps the logs as device tensors
    # and defers every readback to log/valid/save points (the step itself
    # reads one scalar, the gradient norm, to decide the non-finite skip)
    host_step = state.step
    position = itr.state_dict()
    if watchdog is not None:
        watchdog.start()
    try:
        while host_step < run.max_update and not stop:
            # the consumer's position in the epoch: what a checkpoint saves
            # (the prefetch thread runs ahead of it)
            position = itr.state_dict()
            for (_, batch_idx), host_batch in _waited(prefetch_batches(
                    _keyed(itr.next_epoch_itr(), position["epoch"],
                           position["batch_offset"]), collate_train,
                    run.prefetch)):
                if host_step >= run.max_update:
                    break
                position["batch_offset"] += 1
                draw = random.Random(_step_seed(run.seed, host_step))
                mc, rc = (sample_context_bucket(draw, cfg.context.buckets)
                          if sampled_contexts else (mc0, rc0))
                ds = (sampled_steps[draw.randrange(len(sampled_steps))]
                      if sampled_steps else None)
                gen.manual_seed(_step_seed(run.seed, host_step))
                try:
                    state, logs = get_step(mc, rc, ds)(
                        state, to_device(host_batch, device), gen)
                    oom = None
                except torch.cuda.OutOfMemoryError as e:
                    if plan is not None:
                        raise        # the other ranks wait in a collective
                    oom = e
                if oom is not None:
                    # skip the batch: free what the failed step left behind
                    # (outside the handler, where its traceback pins nothing)
                    oom_in_a_row += 1
                    if oom_in_a_row >= len(batches):
                        raise oom              # no batch of the epoch fits
                    oom = None
                    for p in model.parameters():
                        p.grad = None
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
                    oom_skipped += 1
                    print(f"out of device memory on a batch of "
                          f"{len(batch_idx)}: skipped", file=sys.stderr)
                    continue
                oom_in_a_row = 0
                host_step += 1

                check_finite(logs)
                if run.profile_dir:
                    if host_step == 10:
                        from wav2vec_s_tpu_torch.utils.debug import Profile
                        profile = Profile(run.profile_dir)
                    elif host_step == 20 and profile is not None:
                        path, profile = profile.stop(), None
                        print(f"profile trace written to {path}",
                              file=sys.stderr)

                speed.update(1)
                for k, v in logs.items():
                    # device tensors: no sync
                    window.setdefault(k, []).append(v)
                if ds is not None:
                    window.setdefault("decision_step", []).append(float(ds))
                if sampled_contexts:
                    window.setdefault("main_context", []).append(float(mc))
                    window.setdefault("right_context", []).append(float(rc))

                if host_step % run.log_interval == 0:
                    stats = {k: float(np.mean([float(x) for x in v]))
                             for k, v in window.items()}
                    if "loss_total" in stats and "sample_size" in stats:
                        stats["loss_per_sample"] = (
                            stats["loss_total"] / max(stats["sample_size"], 1))
                    stats["ups"] = round(speed.avg, 2)
                    if oom_skipped:
                        stats["oom_skipped"], oom_skipped = oom_skipped, 0
                    if writer:
                        progress.log(stats, host_step)
                    window.clear()

                if valid_setup is not None and run.validate_interval_updates \
                        and host_step % run.validate_interval_updates == 0:
                    vloss, vscore, vacc = validate()
                    vstats = {"valid_loss": vloss}
                    if vscore is not None:
                        vstats["valid_wer" if run.task == "ctc"
                               else "valid_bleu"] = vscore
                    if vacc is not None:
                        vstats["valid_accuracy"] = vacc
                    if writer:
                        progress.log(vstats, host_step, tag="valid")
                    # patience and the best checkpoint track WER for CTC, BLEU
                    # (negated: lower is better) under eval_bleu, else the s2s
                    # accuracy (the reference's --best-checkpoint-metric
                    # accuracy --maximize), else the loss
                    if vscore is not None:
                        vmetric = vscore if run.task == "ctc" else -vscore
                    elif vacc is not None:
                        vmetric = -vacc
                    else:
                        vmetric = vloss
                    if vmetric < best_valid - 1e-6:
                        best_valid, bad_validations = vmetric, 0
                    else:
                        bad_validations += 1
                        if run.patience and bad_validations >= run.patience:
                            if writer:
                                print(f"early stop: no improvement in "
                                      f"{run.patience} validations",
                                      file=sys.stderr)
                            stop = True

                if run.save_interval_updates and \
                        host_step % run.save_interval_updates == 0:
                    mgr.save(host_step, state,
                             extra={"iterator": dict(position)},
                             metric=(best_valid if valid_setup is not None else
                                     float(logs["loss_total"])
                                     / max(float(logs["sample_size"]), 1)))
                if stop:
                    break
            else:
                position = {"epoch": position["epoch"] + 1, "batch_offset": 0}
    finally:
        # every exit stops the watchdog and the trace, a raise too: a
        # caller that catches the error keeps a process the daemon would
        # otherwise signal 10 minutes later
        if watchdog is not None:
            watchdog.stop()
        if profile is not None:    # the run ended inside the window
            print(f"profile trace written to {profile.stop()}",
                  file=sys.stderr)

    mgr.save(host_step, state, extra={"iterator": dict(position)})
    mgr.wait()                         # commit any in-flight async write
    if plan is not None:
        import torch.distributed as dist
        dist.barrier()                 # the checkpoint is written
    if writer:
        print(f"training done at step {host_step}", file=sys.stderr)


def _batches(sizes: np.ndarray, max_tokens: int, n_data: int):
    """max_tokens batches, each a multiple of the data-parallel width
    (JAX CLI: ``required_batch_size_multiple=n_data``, trimmed, shorter
    batches dropped)."""
    batches = batch_by_size(sizes, max_tokens,
                            required_batch_size_multiple=n_data)
    if n_data == 1:
        return batches
    return [b[:len(b) // n_data * n_data] for b in batches
            if len(b) >= n_data]


def _microbatch(x: np.ndarray, k: int) -> np.ndarray:
    b = x.shape[0] // k * k
    return x[:b].reshape((k, b // k) + x.shape[1:])


def _valid_decoder(cfg: TrainConfig, model, vbatcher, plan):
    """The greedy decoder of generation-based validation (rain
    w2v2_s2s_task.py:199-236; the CTC argmax WER path of fairseq
    criterions/ctc.py), or None: BLEU under ``run.eval_bleu`` (any
    fine-tuning task), WER under ``run.eval_wer`` for CTC.  Under a process
    group the emission loops of the data ranks stop together (FSDP gathers
    parameters in every step's forward)."""
    run = cfg.run
    if run.task == "pretrain" or not (
            run.eval_bleu or (run.eval_wer and run.task == "ctc")):
        return None
    from wav2vec_s_tpu_torch.eval import generator

    mc, rc = cfg.context.main_context, cfg.context.right_context
    if run.task == "ctc":
        return generator.make_ctc_greedy_decoder(model, vbatcher.tgt_dict,
                                                 mc, rc)
    make = (generator.make_s2s_greedy_decoder if run.task == "s2s"
            else generator.make_offline_greedy_decoder)
    return make(model, vbatcher.tgt_dict, mc, rc,
                group=None if plan is None else plan.data_group)


def _valid_batcher(batcher, manifest):
    """The training batcher (``CaatBatcher`` or ``TextBatcher``) over the
    validation manifest, without ``TFMask`` and without BPE dropout on
    either tokenizer (validation segments deterministically; JAX
    ``dataclasses_replace_manifest``)."""
    import copy

    new = dataclasses.replace(batcher, manifest=manifest)
    if getattr(new, "transforms", ()):
        new = dataclasses.replace(new, transforms=tuple(
            t for t in new.transforms if not isinstance(t, TFMask)))
    for attr in ("tokenizer", "src_tokenizer"):
        tok = getattr(new, attr, None)
        if tok is not None and getattr(tok, "bpe_dropout", 0.0) > 0:
            clean = copy.copy(tok)
            clean.bpe_dropout = 0.0
            new = dataclasses.replace(new, **{attr: clean})
    return new


if __name__ == "__main__":
    main()
