"""Data preparation CLI (the reference's ``data_process/`` scripts as one
tool; the port's copy of ``speecht5_tpu/cli/prep.py``, host-only: it takes
no device). Subcommands:

  manifest       audio dir -> root+relpath+nframes TSV (+ optional valid split)
  wrd2ltr        word transcripts -> letter targets (wrd2ltr.py)
  phonemize      words -> phones w/ lexicon + silence prob (phoneize_with_sil.py)
  kaldi-phn      letter transcripts -> kaldi phones, !SIL p=0.25
                 (phoneme_tokenizer/ltr2kaldi_phn_sil025.py)
  repeat-phones  reduced phones -> frame-level via duration stats
                 (phoneme_tokenizer/repeat_withou_insert_sil_less_4375.py)
  filter-paired  drop over-/zero-length pairs (filter_paireddata_by_len.py)
  st-manifest    columned ST TSV -> audio manifest + target labels
  letter-lexicon word transcripts -> 'WORD<TAB>W O R D' lexicon
  resample       audio file or tree -> 16 kHz (--sr) WAV
  lm-binary      ARPA -> the native decoder's binary (or KenLM's) format
  t2u-manifest   aligned phones + units -> FastSpeech2 T2U training TSV
                 (get_t2u_manifest.py / get_t2u_manifest_textonly.py)

Examples:
    python -m speecht5_tpu_torch.cli.prep manifest --audio-root wavs/ \
        --out train.tsv --valid-percent 0.01
    python -m speecht5_tpu_torch.cli.prep kaldi-phn --input train.ltr \
        --lexicon align_lexicon.txt --output train
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..data import prep


def main(argv=None):
    p = argparse.ArgumentParser(prog="speecht5_tpu_torch.cli.prep")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("manifest")
    m.add_argument("--audio-root", required=True)
    m.add_argument("--out", required=True)
    m.add_argument("--valid-out", default=None)
    m.add_argument("--valid-percent", type=float, default=0.0)
    m.add_argument("--ext", nargs="+", default=[".wav", ".flac"])
    m.add_argument("--seed", type=int, default=42)

    w = sub.add_parser("wrd2ltr")
    w.add_argument("--input", required=True)
    w.add_argument("--output", required=True)

    ph = sub.add_parser("phonemize")
    ph.add_argument("--input", "-i", required=True)
    ph.add_argument("--output", "-o", required=True)
    ph.add_argument("--lexicon", required=True)
    ph.add_argument("--sil-prob", "-s", type=float, default=0.0)
    ph.add_argument("--surround", action="store_true")
    ph.add_argument("--oov", choices=["skip", "error", "as-is"],
                    default="skip")
    ph.add_argument("--seed", type=int, default=0)

    k = sub.add_parser("kaldi-phn")
    k.add_argument("--input", "-i", required=True)
    k.add_argument("--output", "-o", required=True,
                   help="writes <output>.kaldi_phn_sil025 (+ .oov)")
    k.add_argument("--lexicon", default="align_lexicon.txt")
    k.add_argument("--sil-prob", type=float, default=0.25)
    k.add_argument("--seed", type=int, default=0)

    r = sub.add_parser("repeat-phones")
    r.add_argument("--input", required=True)
    r.add_argument("--mean-std", required=True,
                   help="JSON {phone: [mean, std]}")
    r.add_argument("--output", required=True)
    r.add_argument("--max-len", type=int, default=4375)
    r.add_argument("--seed", type=int, default=0)

    fp = sub.add_parser("filter-paired")
    fp.add_argument("--input", "-i", required=True,
                    help="prefix: reads <input>.<src>/<input>.<tgt>")
    fp.add_argument("--output", "-o", required=True)
    fp.add_argument("--src", "-s", required=True)
    fp.add_argument("--tgt", "-t", required=True)
    fp.add_argument("--max-len", "-m", type=int, default=2998)

    st = sub.add_parser("st-manifest")
    st.add_argument("--tsv", required=True,
                    help="columned ST tsv (id/audio/n_frames/tgt_text)")
    st.add_argument("--out-manifest", required=True)
    st.add_argument("--out-labels", required=True)
    st.add_argument("--audio-root", default=None,
                    help="remap audio paths to <audio-root>/<basename>")

    lx = sub.add_parser(
        "letter-lexicon",
        help="word transcripts -> letter-spelling lexicon for the "
             "ctc_lexicon decoder (the role of the reference's "
             "librispeech_lexicon.lst artifacts, SpeechLM/README.md:105-121)")
    lx.add_argument("--input", "-i", required=True,
                    help="word transcripts (.wrd) or word list, one per line")
    lx.add_argument("--output", "-o", required=True,
                    help="writes 'WORD<TAB>W O R D' lines, sorted, unique")

    rs = sub.add_parser(
        "resample",
        help="convert audio to a target sample rate (the role sox/"
             "torchaudio play in the reference prep; recipes demand 16 kHz)")
    rs.add_argument("--input", "-i", required=True,
                    help="audio file or directory (wav/flac)")
    rs.add_argument("--output", "-o", required=True,
                    help="output file or directory (.wav)")
    rs.add_argument("--sr", type=int, default=16000)

    lb = sub.add_parser(
        "lm-binary",
        help="compile a text ARPA LM into the native decoder's binary "
             "format (KenLM build_binary's role for the reference decode "
             "recipes, SpeechLM/README.md:105-121)")
    lb.add_argument("--arpa", required=True)
    lb.add_argument("--out", required=True)
    lb.add_argument("--format", default="native",
                    choices=("native", "kenlm"),
                    help="'native' = this library's flat format; 'kenlm' = "
                         "KenLM probing binary (format version 5), readable "
                         "by KenLM-based stacks too")

    t = sub.add_parser("t2u-manifest")
    t.add_argument("--audio-manifest", default=None,
                   help="<split>.audio.tsv; omit for text-only rows")
    t.add_argument("--phn", required=True)
    t.add_argument("--km", default=None)
    t.add_argument("--out", required=True)
    t.add_argument("--no-duration", action="store_true",
                   help="phn stream is already reduced (no alignment)")

    args = p.parse_args(argv)

    if args.cmd == "manifest":
        train, valid = prep.create_audio_manifest(
            args.audio_root, exts=tuple(args.ext),
            valid_percent=args.valid_percent, seed=args.seed)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write("\n".join(train) + "\n")
        if args.valid_percent > 0:
            vout = args.valid_out or args.out.replace("train", "valid")
            with open(vout, "w", encoding="utf-8") as f:
                f.write("\n".join(valid) + "\n")
        print(f"{len(train)-1} train / {len(valid)-1} valid utterances")

    elif args.cmd == "wrd2ltr":
        with open(args.input, encoding="utf-8") as fin, \
                open(args.output, "w", encoding="utf-8") as fout:
            for line in fin:
                fout.write(prep.wrd_to_ltr(line) + "\n")

    elif args.cmd == "phonemize":
        lex = prep.read_lexicon(args.lexicon)
        rng = np.random.default_rng(args.seed)
        kept = dropped = 0
        with open(args.input, encoding="utf-8") as fin, \
                open(args.output, "w", encoding="utf-8") as fout:
            for line in fin:
                phones = prep.phonemize_with_sil(
                    line, lex, rng, sil_prob=args.sil_prob,
                    surround=args.surround, oov=args.oov)
                if phones is None:
                    dropped += 1
                    continue
                kept += 1
                fout.write(" ".join(phones) + "\n")
        print(f"kept {kept}, dropped {dropped} (OOV)")

    elif args.cmd == "kaldi-phn":
        lex = prep.read_lexicon(args.lexicon, kaldi_format=True)
        rng = np.random.default_rng(args.seed)
        oov_total = words_total = 0
        with open(args.input, encoding="utf-8") as fin, \
                open(f"{args.output}.kaldi_phn_sil025", "w",
                     encoding="utf-8") as fout, \
                open(f"{args.output}.kaldi_phn_sil025.oov", "w",
                     encoding="utf-8") as foov:
            for line in fin:
                phones, oov, total = prep.kaldi_phonemize(
                    line, lex, rng, sil_prob=args.sil_prob)
                fout.write(" ".join(phones) + "\n")
                if oov:
                    foov.write(f"{oov}\n")
                oov_total += oov
                words_total += total
        print(f"OOV rate: {oov_total}/{words_total}")

    elif args.cmd == "repeat-phones":
        with open(args.mean_std, encoding="utf-8") as f:
            mean_std = json.load(f)
        rng = np.random.default_rng(args.seed)
        with open(args.input, encoding="utf-8") as fin, \
                open(args.output, "w", encoding="utf-8") as fout:
            for line in fin:
                out = prep.repeat_phones(
                    line.split(), mean_std, rng, max_len=args.max_len)
                fout.write(" ".join(out) + "\n")

    elif args.cmd == "filter-paired":
        def read(path):
            with open(path, encoding="utf-8") as f:
                return [l.rstrip("\n") for l in f]
        src = read(f"{args.input}.{args.src}")
        tgt = read(f"{args.input}.{args.tgt}")
        src_f, tgt_f = prep.filter_paired_by_len(src, tgt, args.max_len)
        for suffix, lines in ((args.src, src_f), (args.tgt, tgt_f)):
            with open(f"{args.output}.{suffix}", "w", encoding="utf-8") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))
        print(f"kept {len(src_f)}/{len(src)} pairs")

    elif args.cmd == "st-manifest":
        manifest, labels = prep.convert_st_tsv(args.tsv, args.audio_root)
        with open(args.out_manifest, "w", encoding="utf-8") as f:
            f.write("\n".join(manifest) + "\n")
        with open(args.out_labels, "w", encoding="utf-8") as f:
            f.write("\n".join(labels) + "\n")
        print(f"wrote {len(labels)} utterances")

    elif args.cmd == "letter-lexicon":
        words = set()
        with open(args.input, encoding="utf-8") as fin:
            for line in fin:
                words.update(w for w in line.split() if w)
        with open(args.output, "w", encoding="utf-8") as fout:
            for w in sorted(words):
                fout.write(w + "\t" + " ".join(w) + "\n")
        print(f"wrote {len(words)} lexicon entries")

    elif args.cmd == "resample":
        from ..data.audio import read_audio, write_wav

        def _convert(src, dst):
            wav, _ = read_audio(src, target_sr=args.sr)
            os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
            write_wav(dst, wav, sr=args.sr)

        if os.path.isdir(args.input):
            n = 0
            for dirpath, _dirs, files in os.walk(args.input):
                for name in sorted(files):
                    if not name.lower().endswith((".wav", ".flac")):
                        continue
                    rel = os.path.relpath(os.path.join(dirpath, name),
                                          args.input)
                    dst = os.path.join(
                        args.output, os.path.splitext(rel)[0] + ".wav")
                    _convert(os.path.join(dirpath, name), dst)
                    n += 1
            print(f"resampled {n} files to {args.sr} Hz")
        else:
            _convert(args.input, args.output)
            print(f"resampled 1 file to {args.sr} Hz")

    elif args.cmd == "lm-binary":
        from ..decode.lexicon import build_binary_lm

        build_binary_lm(args.arpa, args.out, format=args.format)
        print(f"compiled {args.arpa} -> {args.out}")

    elif args.cmd == "t2u-manifest":
        if args.audio_manifest:
            if not args.km:
                p.error("t2u-manifest with --audio-manifest requires --km")
            rows = prep.t2u_manifest_rows(
                args.audio_manifest, args.phn, args.km,
                add_duration=not args.no_duration)
        else:
            rows = prep.t2u_manifest_textonly_rows(args.phn)
        prep.write_tsv(rows, args.out)
        print(f"wrote {len(rows)} rows to {args.out}")

    return 0


if __name__ == "__main__":
    sys.exit(main())
