"""Dictionary-building CLI (port of ``wav2vec_s_tpu/data/preprocess.py``,
host only) — twin of ``fairseq-preprocess``'s vocabulary
pass (fairseq_cli/preprocess.py + Dictionary.finalize): count tokens over
text corpora or S2T manifest columns, apply threshold / size cap /
padding-factor, write a fairseq-format ``dict.txt``.

Usage::

    python -m wav2vec_s_tpu_torch.data.preprocess \
        --inputs train.txt dev.txt --tokenizer word --out dict.txt
    python -m wav2vec_s_tpu_torch.data.preprocess \
        --manifests train_st.tsv --column tgt_text --spm-model bpe.model \
        --threshold 2 --out dict.txt

Only the dictionary stage is re-provided: the reference's binarized
``.bin/.idx`` output is an artifact of its memory-mapped dataset layer,
which this framework replaces with manifest-driven on-the-fly collation
(SURVEY §2.5 — raw audio + text are read per batch, not pre-binarized).
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.data.tokenizer import build_tokenizer


def build_dictionary(lines, tokenizer, threshold: int = -1,
                     nwords: int = -1, padding_factor: int = 1
                     ) -> Dictionary:
    """Count token occurrences and build a fairseq-compatible Dictionary
    (most-frequent first, ties by insertion order — the
    ``Dictionary.finalize`` sort contract)."""
    counts = Counter()
    order = {}
    for line in lines:
        for tok in tokenizer.encode(line.strip()):
            if tok not in order:
                order[tok] = len(order)
            counts[tok] += 1

    items = sorted(counts.items(), key=lambda kv: (-kv[1], order[kv[0]]))
    d = Dictionary()
    kept = 0
    for word, n in items:
        if threshold > 0 and n < threshold:
            break
        if 0 < nwords <= kept:
            break
        d.add_symbol(word, n)
        kept += 1

    # padding_factor: pad the vocab with madeupword fillers so its size is
    # a multiple (tile-friendly embedding/vocab-projection shapes)
    i = 0
    while padding_factor > 1 and len(d) % padding_factor != 0:
        d.add_symbol(f"madeupword{i:04d}", 0)
        i += 1
    return d


def _iter_lines(args):
    for path in args.inputs or []:
        with open(path) as f:
            yield from f
    for path in args.manifests or []:
        from wav2vec_s_tpu_torch.data.manifests import read_s2t_manifest
        man = read_s2t_manifest(path)
        texts = (man.src_texts if args.column == "src_text"
                 else man.tgt_texts)
        for t in texts:
            if t:
                yield t


def main(argv=None):
    p = argparse.ArgumentParser(description="build a fairseq-format dict")
    p.add_argument("--inputs", nargs="*", help="plain text files")
    p.add_argument("--manifests", nargs="*", help="S2T tsv manifests")
    p.add_argument("--column", default="tgt_text",
                   choices=["tgt_text", "src_text"])
    p.add_argument("--tokenizer", default="word",
                   choices=["word", "char", "spm"])
    p.add_argument("--spm-model", default="")
    p.add_argument("--threshold", type=int, default=-1,
                   help="drop tokens seen fewer times")
    p.add_argument("--nwords", type=int, default=-1, help="vocab size cap")
    p.add_argument("--padding-factor", type=int, default=1)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if not args.inputs and not args.manifests:
        p.error("need --inputs and/or --manifests")

    tok = build_tokenizer(args.tokenizer, args.spm_model or None, 0.0)
    d = build_dictionary(_iter_lines(args), tok, args.threshold,
                         args.nwords, args.padding_factor)
    d.save(args.out)
    print(f"wrote {args.out}: {len(d)} entries "
          f"({len(d) - d.nspecial} tokens)", file=sys.stderr)


if __name__ == "__main__":
    main()
