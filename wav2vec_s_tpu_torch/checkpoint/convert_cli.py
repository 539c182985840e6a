"""Convert checkpoints between the reference's ``.pt`` format and the
port's checkpoint directories (port of
``wav2vec_s_tpu/checkpoint/convert_cli.py``).

Import: a fairseq ``.pt`` (a pre-trained wav2vec-S model, a stock
wav2vec 2.0 model with ``--encoder-type full``, or a fine-tuned rain CAAT
checkpoint with ``encoder.w2v2_model.*`` keys) becomes a checkpoint
directory of ``checkpoint/io.py`` (step 0, no optimizer state) that the
eval CLI reads and the trainer warm-starts from.  ``--encoder-type full``
keeps the conv positions (folded, ``torch_import.fold_weight_norm``); the
default ``blockwise`` drops them, as the JAX converter does.

Export: the latest step of a port checkpoint directory becomes a
reference-named ``.pt`` that the fairseq / rain stack loads.

Usage:
  # import
  python -m wav2vec_s_tpu_torch.checkpoint.convert_cli \\
      --pt wav2vec-S-base.pt --out ckpt_dir [--prefix encoder.w2v2_model.] \\
      [--encoder-type blockwise|full] [--model w2v2|caat] \\
      [key=value ...] [caat.key=value ...]
  # export
  python -m wav2vec_s_tpu_torch.checkpoint.convert_cli \\
      --export-from ckpt_dir --out model.pt --model w2v2|caat

The widths and ``extractor_mode`` come from the checkpoint's stored
``cfg["model"]`` where it has them, else from the overrides
(``Wav2Vec2Config`` fields; ``caat.*`` for ``CaatConfig``); a w2v2
checkpoint with a quantizer or projections builds the pre-training model.
Everything runs on the CPU.
"""

from __future__ import annotations

import argparse
import ast
import sys

from wav2vec_s_tpu_torch.checkpoint.torch_import import HEADS

_W2V_KEYS = ("encoder_layers", "encoder_embed_dim", "encoder_ffn_embed_dim",
             "encoder_attention_heads", "extractor_mode", "final_dim",
             "latent_vars", "latent_groups")
_CAAT_KEYS = ("decoder_layers", "decoder_embed_dim", "decoder_ffn_embed_dim",
              "decoder_attention_heads", "jointer_layers", "jointer_embed_dim",
              "jointer_ffn_embed_dim", "jointer_attention_heads",
              "transducer_downsample")


def _overrides(items):
    kw, caat_kw = {}, {}
    for ov in items:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not key=value")
        k, v = ov.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        if k.startswith("caat."):
            caat_kw[k[len("caat."):]] = v
        else:
            kw[k] = v
    return kw, caat_kw


def _export(args) -> None:
    from wav2vec_s_tpu_torch.checkpoint.io import load_params
    from wav2vec_s_tpu_torch.checkpoint.torch_export import (
        export_caat_state_dict, export_wav2vec2_state_dict,
        save_fairseq_checkpoint)

    model_sd = load_params(args.export_from)
    sd = (export_caat_state_dict(model_sd) if args.model == "caat"
          else export_wav2vec2_state_dict(model_sd, args.prefix))
    save_fairseq_checkpoint(args.out, sd)
    n = sum(v.numel() for v in sd.values())
    print(f"exported {args.export_from} -> {args.out} ({n / 1e6:.1f}M "
          f"values, {len(sd)} tensors)", file=sys.stderr)


def _import(args) -> None:
    from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager
    from wav2vec_s_tpu_torch.checkpoint.torch_import import (
        load_caat_, load_torch_checkpoint, load_wav2vec2_)
    from wav2vec_s_tpu_torch.models import Wav2Vec2Config, Wav2Vec2Model

    state = load_torch_checkpoint(args.pt)
    sd = state["model"] if "model" in state else state
    kw, caat_kw = _overrides(args.overrides)
    stored = state.get("cfg") or {}
    stored = (stored.get("model") if isinstance(stored, dict) else None) or {}
    for key in _W2V_KEYS:
        if key in stored and key not in kw:
            kw[key] = stored[key]
    cfg = Wav2Vec2Config(**kw)

    if args.model == "caat":
        from wav2vec_s_tpu_torch.models.caat import CaatConfig, W2V2CaatModel

        for key in _CAAT_KEYS:
            if key in stored and key not in caat_kw:
                caat_kw[key] = stored[key]
        # --use-linear-layer exists iff rain created it
        # (unidirect_w2v2_encoder.py:557-562)
        caat_kw.setdefault("encoder_proj",
                           "encoder.encoder_proj.weight" in sd)
        caat_kw.setdefault("vocab_size",
                           sd["decoder.lm.embed_tokens.weight"].shape[0])
        model = load_caat_(W2V2CaatModel(cfg, CaatConfig(**caat_kw)), sd)
    else:
        heads = any(k.startswith(args.prefix + h) for k in sd for h in HEADS)
        model = load_wav2vec2_(Wav2Vec2Model(
            cfg, pretraining=heads, encoder_type=args.encoder_type), sd,
            args.prefix)
    model_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    CheckpointManager(args.out, keep_last=0).save_payload(
        0, {"step": 0, "model": model_sd, "opt": None},
        extra={"source": str(args.pt)})
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {args.pt} -> {args.out} ({n / 1e6:.1f}M params)",
          file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(
        "fairseq .pt <-> port checkpoint directory converter")
    p.add_argument("--pt", default=None,
                   help="fairseq .pt to import (the default direction)")
    p.add_argument("--out", required=True,
                   help="output: checkpoint dir (import) or .pt (export)")
    p.add_argument("--export-from", default=None, metavar="CKPT_DIR",
                   help="EXPORT: read the latest step of this port "
                        "checkpoint dir and write a reference-named .pt")
    p.add_argument("--prefix", default="",
                   help="state-dict key prefix to strip on import / add on "
                        "a w2v2 export (e.g. 'encoder.w2v2_model.')")
    p.add_argument("--encoder-type", default="blockwise",
                   choices=["blockwise", "full"])
    p.add_argument("--model", default="w2v2", choices=["w2v2", "caat"],
                   help="'caat': a whole w2v2_caat model (encoder, LM "
                        "decoder, jointer, output embedding)")
    p.add_argument("overrides", nargs="*", default=[],
                   help="config overrides key=value; caat.* keys go to "
                        "CaatConfig")
    args = p.parse_args(argv)
    if args.export_from:
        _export(args)
    elif args.pt:
        _import(args)
    else:
        p.error("--pt is required for the import direction (or pass "
                "--export-from for export)")


if __name__ == "__main__":
    main()
