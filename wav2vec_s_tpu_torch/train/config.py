"""Layered typed config: dataclasses + yaml + dot-overrides (port of
``wav2vec_s_tpu/train/config.py``, same sections, keys and defaults, so one
yaml file drives both packages; ``train/cli.py`` says which keys the port
does not act on yet, and raises on them).

Replaces the reference's Hydra/OmegaConf + argparse registry maze
(fairseq/fairseq/dataclass/configs.py:26-916, hydra_train.py:25-95) with a
small, explicit system: a nested dataclass tree, a yaml file to fill it, and
``section.key=value`` command-line overrides — same capabilities (typed
fields, composition, overrides) without the plugin machinery.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional, Tuple

from wav2vec_s_tpu_torch.train.optim import OptimConfig


@dataclasses.dataclass
class DataConfig:
    train_manifest: str = ""
    valid_manifest: str = ""
    audio_root: str = ""
    vocab: str = ""                    # fairseq-format dict.txt
    tokenizer: str = "word"            # word | char | spm
    spm_model: str = ""
    bpe_dropout: float = 0.0
    max_tokens: int = 1_400_000        # audio samples per batch
    max_sample_size: int = 250_000
    min_sample_size: int = 32_000
    normalize: bool = False
    num_buckets: int = 10
    seed: int = 1
    task_type: str = "st"              # CAAT: st | asr
    src_vocab: str = ""                # text family: separate source dict
    features: str = "raw"              # raw waveform | fbank (log-mel, the
    # rain fbank model family: tasks/transducer_task.py) | text (bitext
    # simultaneous MT: rain dropout_translation + caat_transformer)
    specaugment: bool = True           # fbank-only: TFMask during training
    # (rain audio_encoder.py TFMask; validation always runs without it)


@dataclasses.dataclass
class RunConfig:
    task: str = "pretrain"             # pretrain | caat | s2s | ctc
    # s2s (offline ASR/ST seq2seq fine-tuning): label-smoothed CE
    # (--label-smoothing 0.1, train_wav2vec_s_offline_asr_base.sh)
    label_smoothing: float = 0.1
    # ctc (offline ASR fine-tuning, fairseq wav2vec2_asr.py:154 Wav2VecCtc):
    # dropout before the vocab projection (--final-dropout)
    final_dropout: float = 0.0
    save_dir: str = "checkpoints"
    max_update: int = 400_000
    update_freq: int = 1
    log_interval: int = 100
    save_interval_updates: int = 5000
    validate_interval_updates: int = 5000
    keep_last: int = 3
    keep_best: int = 0
    # write checkpoints on a background thread (the reference's iopath
    # async path, checkpoint_utils.py:427-455); save() returns once the
    # tensors are staged to host, the file write overlaps training
    async_checkpoints: bool = True
    patience: int = 0                  # early stop on stagnant valid loss
    seed: int = 1
    num_devices: int = 0               # 0 = all visible devices (data axis)
    tensorboard_dir: str = ""
    # warm starts (checkpoint_utils analogues)
    load_pretrained_model_from: str = ""   # torch .pt (wav2vec2 warm start)
    w2v2_model_path: str = ""              # torch .pt for CAAT encoder
    # encoder warm start from a previous fine-tune stage (the published ST
    # recipe initializes the CAAT encoder from a trained OFFLINE ASR model:
    # --pretrained-encoder-path, rain/models/w2v2_transducer.py:234-244).
    # Accepts one of our checkpoint dirs or a torch .pt.
    pretrained_encoder_path: str = ""
    restore_from: str = ""                 # our own checkpoint dir
    # freeze schedules (rain w2v2_transducer.py:163-174, unidirect:585-588)
    freeze_w2v2_enc: int = 0
    freeze_finetune_updates: int = 0
    # sharded state (fairseq optim/shard.py ZeRO via OSS;
    # distributed/fully_sharded_data_parallel.py)
    zero: bool = False                 # ZeRO-1: shard optimizer state
    fsdp: bool = False                 # shard parameters over the data axis
    flat_optimizer: bool = False       # raveled single-vector optimizer
    # update (exact ZeRO-1 sharding; off under fsdp; see
    # train/step.py::FlatParams)
    # context parallelism: shard the encoder's time axis over `seq`-many
    # devices (mesh axis "seq"; model.seq_axis is set automatically).  The
    # reference has no sequence/context parallelism (SURVEY §2.7).
    seq: int = 1
    # rematerialization of the loss forward: none | dots | nothing |
    # offload_dots (offload saveables to pinned host memory); see
    # train/remat.py::REMAT_POLICIES
    remat: str = "none"
    # NaN localization (fairseq nan_detector.py, trainer.py:801-811)
    debug_nan: bool = False
    # background collation depth (fairseq DataLoader num_workers analogue,
    # data/prefetch.py); 0 disables
    prefetch: int = 2
    # generation-based BLEU during validation; when on, best-checkpoint +
    # patience track BLEU instead of loss (rain w2v2_s2s_task.py:109-123,
    # 199-236: eval_bleu + best_checkpoint_metric=bleu)
    eval_bleu: bool = False
    # argmax-decode WER during CTC validation; best-checkpoint + patience
    # then track WER (fairseq criterions/ctc.py eval_wer)
    eval_wer: bool = False
    # capture a profiler trace of training steps [10, 20) into this
    # directory (the --profile hook, fairseq_cli/hydra_train.py:40-43)
    profile_dir: str = ""


@dataclasses.dataclass
class ContextConfig:
    context_type: str = "sampling"     # constant | sampling
    main_context: int = 16
    right_context: int = 8
    # bucket grid used when sampling (one compiled step per bucket)
    buckets: Tuple[Tuple[int, int], ...] = (
        (8, 4), (12, 6), (16, 8), (20, 8), (24, 12), (28, 12), (32, 16))


@dataclasses.dataclass
class TrainConfig:
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    context: ContextConfig = dataclasses.field(default_factory=ContextConfig)
    model: dict = dataclasses.field(default_factory=dict)   # Wav2Vec2Config kw
    caat: dict = dataclasses.field(default_factory=dict)    # CaatConfig kw


def _coerce(value: str, current: Any):
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        import ast
        return tuple(ast.literal_eval(value))
    return value


def apply_overrides(cfg: TrainConfig, overrides) -> TrainConfig:
    """``section.key=value`` (or ``model.key=value`` into the dict fields)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not key=value")
        key, value = ov.split("=", 1)
        parts = key.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p) if dataclasses.is_dataclass(obj) else obj[p]
        last = parts[-1]
        if dataclasses.is_dataclass(obj):
            cur = getattr(obj, last)
            object.__setattr__(obj, last, _coerce(value, cur)) \
                if getattr(type(obj), "__dataclass_params__").frozen \
                else setattr(obj, last, _coerce(value, cur))
        else:
            import ast
            try:
                obj[last] = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                obj[last] = value
    return cfg


def load_config(yaml_path: Optional[str] = None, overrides=()) -> TrainConfig:
    cfg = TrainConfig()
    if yaml_path:
        import yaml

        raw = yaml.safe_load(Path(yaml_path).read_text()) or {}
        for section, values in raw.items():
            cur = getattr(cfg, section)
            if dataclasses.is_dataclass(cur) and isinstance(values, dict):
                known = {f.name for f in dataclasses.fields(cur)}
                fixed = {}
                for k, v in values.items():
                    if k not in known:
                        raise ValueError(f"unknown config key {section}.{k}")
                    fixed[k] = tuple(map(tuple, v)) if (
                        isinstance(v, list) and v and isinstance(v[0], list)
                    ) else (tuple(v) if isinstance(
                        getattr(cur, k), tuple) and isinstance(v, list) else v)
                setattr(cfg, section, dataclasses.replace(cur, **fixed))
            else:
                setattr(cfg, section, values)
    return apply_overrides(cfg, overrides)
