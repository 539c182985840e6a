"""Dataset preparation CLI — twin of the reference's preprocess scripts
(port of ``wav2vec_s_tpu/data/prep.py``, host only: the standard library,
and PyYAML for MuST-C; run as ``python -m wav2vec_s_tpu_torch.data.prep
librispeech|s2t|mustc ...``).

Provides:

- ``librispeech``: walk a LibriSpeech split directory and emit the
  pre-training audio manifest (root line + ``relpath\\tnum_samples`` rows)
  plus ``.wrd``/``.ltr`` transcript files — the combination of fairseq's
  ``examples/wav2vec/wav2vec_manifest.py`` and ``libri_labels.py`` the
  wav2vec-S recipes assume as their starting point.
- ``s2t``: convert a pre-training manifest + ``.wrd`` transcripts into the
  fine-tuning S2T tsv (id/audio/n_frames/src_text/tgt_text/speaker) — the
  reference's ``wav2vec_s_scripts/preprocess/process_librispeech_raw_data.py``
  (its ASR manifests set tgt_text = src_text) — and optionally the data
  config yaml (``gen_config_yaml_raw`` twin).
- ``mustc``: walk the MuST-C ``en-<lang>/data/<split>/{txt,wav}`` layout and
  emit raw-audio S2T tsvs whose audio column uses the
  ``<wav>:<sample offset>:<n samples>`` segment syntax — the reference's
  ``fairseq/examples/speech_to_text/prep_mustc_data_raw.py``.

Vocabulary building lives in ``wav2vec_s_tpu_torch.data.preprocess`` (the
``gen_vocab`` sentencepiece training step requires the optional
``sentencepiece`` package; the published recipes ship trained spm models,
so prep here emits word/char-ready text files and the dictionary CLI
handles counting).
"""

from __future__ import annotations

import argparse
import csv
import sys
import wave
from pathlib import Path

S2T_COLUMNS = ["id", "audio", "n_frames", "src_text", "src_lang",
               "tgt_text", "tgt_lang", "speaker"]


def _num_samples(path: Path) -> int:
    if path.suffix.lower() == ".wav":
        with wave.open(str(path), "rb") as w:
            return w.getnframes()
    try:
        import soundfile as sf
    except ImportError as e:
        raise ImportError(f"reading {path.suffix} metadata needs the "
                          "optional 'soundfile' package") from e
    return sf.info(str(path)).frames


def write_s2t_tsv(path, rows):
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(
            f, fieldnames=S2T_COLUMNS, delimiter="\t", quotechar=None,
            doublequote=False, lineterminator="\n", quoting=csv.QUOTE_NONE)
        writer.writeheader()
        for r in rows:
            writer.writerow(r)


def write_data_config(path, audio_root: str, vocab_filename: str,
                      spm_model: str = ""):
    """Data-config yaml (S2TDataConfig twin of ``gen_config_yaml_raw``,
    fairseq/examples/speech_to_text/data_utils.py)."""
    lines = [
        f"audio_root: {audio_root}",
        f"vocab_filename: {vocab_filename}",
        "use_audio_input: true",
        "sample_rate: 16000",
        "shuffle: true",
    ]
    if spm_model:
        lines.append("bpe_tokenizer:")
        lines.append("  bpe: sentencepiece")
        lines.append(f"  sentencepiece_model: {spm_model}")
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")


def prep_librispeech(root, out_dir, split: str, ext: str = "flac"):
    """LibriSpeech layout -> pretrain manifest + .wrd/.ltr transcripts.

    Layout: ``<root>/<split>/<speaker>/<chapter>/<spk>-<ch>-<utt>.<ext>``
    with per-chapter ``<spk>-<ch>.trans.txt`` transcript files.
    """
    root, out_dir = Path(root), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    split_dir = root / split
    if not split_dir.is_dir():
        raise FileNotFoundError(split_dir)

    trans = {}
    for tfile in sorted(split_dir.rglob("*.trans.txt")):
        for line in tfile.read_text(encoding="utf-8").splitlines():
            if not line.strip():
                continue
            utt_id, text = line.split(" ", 1)
            trans[utt_id] = text.strip()

    # manifests are rooted at the split directory so relpaths start at the
    # speaker (<spk>/<chapter>/<utt>.<ext>) — the wav2vec_manifest.py
    # convention process_librispeech_raw_data.py assumes when it parses the
    # speaker from the first path component
    rows, words, letters = [], [], []
    for audio in sorted(split_dir.rglob(f"*.{ext}")):
        utt_id = audio.stem
        if utt_id not in trans:
            continue
        n = _num_samples(audio)
        rows.append(f"{audio.relative_to(split_dir)}\t{n}")
        text = trans[utt_id]
        words.append(text)
        # fairseq libri_labels.py letter format: chars spaced, '|' word ends
        letters.append(" ".join(list(text.replace(" ", "|"))) + " |")

    (out_dir / f"{split}.tsv").write_text(
        "\n".join([str(split_dir)] + rows) + "\n", encoding="utf-8")
    (out_dir / f"{split}.wrd").write_text(
        "\n".join(words) + "\n", encoding="utf-8")
    (out_dir / f"{split}.ltr").write_text(
        "\n".join(letters) + "\n", encoding="utf-8")
    return len(rows)


def prep_s2t_from_pretrain(manifest, wrd, out_tsv, src_lang="en",
                           tgt_lang="en", dataset="librispeech"):
    """Pretrain manifest + .wrd -> fine-tuning S2T tsv (ASR: tgt == src).

    Mirrors process_librispeech_raw_data.py: utterance ids are
    ``<dataset>_<speaker>_<filename>``, audio paths absolute.
    """
    lines = Path(manifest).read_text(encoding="utf-8").splitlines()
    root = Path(lines[0].strip())
    texts = Path(wrd).read_text(encoding="utf-8").splitlines()
    entries = [ln for ln in lines[1:] if ln.strip()]
    if len(entries) != len(texts):
        raise ValueError(f"manifest rows ({len(entries)}) != transcript "
                         f"lines ({len(texts)})")
    rows = []
    for line, text in zip(entries, texts):
        rel, n = line.split("\t")
        parts = Path(rel).parts
        speaker = parts[0] if len(parts) > 1 else "spk.unk"
        rows.append(dict(
            id=f"{dataset}_{speaker}_{Path(rel).stem}",
            audio=str(root / rel), n_frames=int(n),
            src_text=text.strip(), src_lang=src_lang,
            tgt_text=text.strip(), tgt_lang=tgt_lang, speaker="spk.unk"))
    write_s2t_tsv(out_tsv, rows)
    return len(rows)


def prep_mustc(data_root, lang: str, splits, out_dir=None):
    """MuST-C layout -> raw-audio S2T tsv per split.

    ``<data_root>/en-<lang>/data/<split>/txt/<split>.yaml`` holds segments
    (wav/offset/duration in seconds, speaker_id); ``txt/<split>.{en,<lang>}``
    hold the parallel text.  Audio refs are written as
    ``<wav path>:<sample offset>:<n samples>`` (prep_mustc_data_raw.py).
    """
    import yaml

    data_root = Path(data_root)
    cur = data_root / f"en-{lang}" / "data"
    out_dir = Path(out_dir) if out_dir else data_root / f"en-{lang}"
    out_dir.mkdir(parents=True, exist_ok=True)
    counts = {}
    for split in splits:
        txt_root = cur / split / "txt"
        wav_root = cur / split / "wav"
        with open(txt_root / f"{split}.yaml", encoding="utf-8") as f:
            segments = yaml.safe_load(f)
        for side in ("en", lang):
            utts = (txt_root / f"{split}.{side}").read_text(
                encoding="utf-8").splitlines()
            if len(utts) != len(segments):
                raise ValueError(f"{split}.{side}: {len(utts)} lines vs "
                                 f"{len(segments)} segments")
            for seg, u in zip(segments, utts):
                seg[side] = u.strip()

        rows, seg_index = [], {}
        rate_cache = {}
        for seg in segments:
            wav_path = wav_root / seg["wav"]
            if wav_path not in rate_cache:
                with wave.open(str(wav_path), "rb") as w:
                    rate_cache[wav_path] = w.getframerate()
            rate = rate_cache[wav_path]
            offset = int(float(seg["offset"]) * rate)
            n_frames = int(float(seg["duration"]) * rate)
            i = seg_index.setdefault(seg["wav"], 0)
            seg_index[seg["wav"]] += 1
            rows.append(dict(
                id=f"{Path(seg['wav']).stem}_{i}",
                audio=f"{wav_path}:{offset}:{n_frames}",
                n_frames=n_frames,
                src_text=seg["en"], src_lang="en",
                tgt_text=seg[lang], tgt_lang=lang,
                speaker=seg.get("speaker_id", "spk.unk")))
        write_s2t_tsv(out_dir / f"{split}_st_raw.tsv", rows)
        counts[split] = len(rows)
    return counts


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="wav2vec_s_tpu_torch.data.prep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    ls = sub.add_parser("librispeech", help="LibriSpeech -> manifest+labels")
    ls.add_argument("root")
    ls.add_argument("--split", default="train-clean-100")
    ls.add_argument("--out", required=True)
    ls.add_argument("--ext", default="flac")

    s2 = sub.add_parser("s2t", help="pretrain manifest+wrd -> S2T tsv")
    s2.add_argument("--manifest", required=True)
    s2.add_argument("--wrd", required=True)
    s2.add_argument("--out", required=True)
    s2.add_argument("--src-lang", default="en")
    s2.add_argument("--tgt-lang", default="en")
    s2.add_argument("--config-out", default="")
    s2.add_argument("--vocab", default="dict.txt")
    s2.add_argument("--spm-model", default="")

    mc = sub.add_parser("mustc", help="MuST-C -> raw S2T tsvs")
    mc.add_argument("root")
    mc.add_argument("--lang", required=True)
    mc.add_argument("--splits", nargs="+",
                    default=["train", "dev", "tst-COMMON"])
    mc.add_argument("--out", default="")
    mc.add_argument("--config-out", default="")
    mc.add_argument("--vocab", default="dict.txt")
    mc.add_argument("--spm-model", default="")

    args = p.parse_args(argv)
    if args.cmd == "librispeech":
        n = prep_librispeech(args.root, args.out, args.split, args.ext)
        print(f"wrote {n} utterances to {args.out}")
    elif args.cmd == "s2t":
        n = prep_s2t_from_pretrain(args.manifest, args.wrd, args.out,
                                   args.src_lang, args.tgt_lang)
        if args.config_out:
            write_data_config(args.config_out, "", args.vocab,
                              args.spm_model)
        print(f"wrote {n} rows to {args.out}")
    elif args.cmd == "mustc":
        counts = prep_mustc(args.root, args.lang, args.splits,
                            args.out or None)
        if args.config_out:
            write_data_config(args.config_out, "", args.vocab,
                              args.spm_model)
        for split, n in counts.items():
            print(f"{split}: {n} rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
