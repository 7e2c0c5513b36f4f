"""Dataset preparation utilities (the reference's ``data_process/`` layer;
the port's copy of ``speecht5_tpu/data/prep.py``).

Covers SpeechLM's data-prep scripts with library functions + a CLI
(``python -m speecht5_tpu_torch.cli.prep``), reading/writing the same file formats
our datasets consume:

- audio manifest creation (root + relpath + nframes TSV, the format of
  `load_audio_manifest` / fairseq wav2vec manifests) from a directory tree,
  with a deterministic valid-split option;
- word -> letter transcripts (reference
  SpeechLM/speechlm/data_process/wrd2ltr.py);
- lexicon phonemization with probabilistic silence insertion (reference
  data_process/phoneize_with_sil.py);
- kaldi-style phonemization of letter transcripts with !SIL insertion at
  p=0.25 (reference data_process/phoneme_tokenizer/ltr2kaldi_phn_sil025.py);
- frame-level phone repetition from per-phone duration statistics (reference
  phoneme_tokenizer/repeat_withou_insert_sil_less_4375.py);
- paired-text length filtering (reference data_process/filter_paireddata_by_len.py);
- text-to-unit manifests for the FastSpeech2 T2U tokenizer, from
  force-aligned phone + unit streams (reference data_process/get_t2u_manifest.py,
  get_t2u_manifest_textonly.py) — pitch extraction is intentionally omitted:
  the shipped fasttext2unit_s arch disables pitch/energy (use_pitch default
  False, speechlm/models/fasttext2unit.py), so duration targets suffice.

All randomness is via an explicit ``numpy.random.Generator`` (the reference
uses the global numpy RNG — not reproducible).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

SIL = "<SIL>"
KALDI_SIL_WORD = "!SIL"
KALDI_UNK_WORD = "<UNK>"


# --------------------------------------------------------------------------
# audio manifest creation
# --------------------------------------------------------------------------

def wav_num_samples(path: str) -> int:
    """Frame count of a WAV file from its header (no sample data read)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        channels = bits = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"no data chunk found: {path}")
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
                channels = struct.unpack("<H", fmt[2:4])[0]
                bits = struct.unpack("<H", fmt[14:16])[0]
            elif cid == b"data":
                if channels is None:
                    raise ValueError(f"data chunk before fmt: {path}")
                return size // (channels * (bits // 8))
            else:
                f.seek(size + (size & 1), os.SEEK_CUR)


def flac_num_samples(path: str) -> int:
    """Total samples from a FLAC STREAMINFO block (no decode), through the
    native decoder's probe (``data/native.flac_info``); ValueError on a
    file that is not FLAC."""
    from .native import flac_info

    return flac_info(path)[0]


def audio_num_samples(path: str) -> int:
    return flac_num_samples(path) if path.lower().endswith(".flac") \
        else wav_num_samples(path)


def create_audio_manifest(
    audio_root: str,
    exts: Sequence[str] = (".wav", ".flac"),
    valid_percent: float = 0.0,
    seed: int = 42,
) -> Tuple[List[str], List[str]]:
    """Walk ``audio_root`` and build manifest lines (root line included).

    Returns (train_lines, valid_lines); ``valid_percent`` of files go to the
    valid split, chosen by a seeded RNG (deterministic, unlike a dir walk
    order). Files are sorted for reproducibility across filesystems.
    """
    audio_root = os.path.abspath(audio_root)
    rels = []
    for dirpath, _dirnames, filenames in os.walk(audio_root):
        for name in filenames:
            if any(name.lower().endswith(e) for e in exts):
                rels.append(
                    os.path.relpath(os.path.join(dirpath, name), audio_root))
    rels.sort()
    rng = np.random.default_rng(seed)
    train, valid = [audio_root], [audio_root]
    for rel in rels:
        n = audio_num_samples(os.path.join(audio_root, rel))
        line = f"{rel}\t{n}"
        (valid if rng.random() < valid_percent else train).append(line)
    return train, valid


# --------------------------------------------------------------------------
# transcript transforms
# --------------------------------------------------------------------------

def wrd_to_ltr(line: str) -> str:
    """Word transcript -> space-separated letters with '|' word boundaries
    (reference wrd2ltr.py: drop <unk>, upper-case, trailing boundary)."""
    line = line.replace("<unk>", "")
    line = " ".join(line.strip().split())
    return " ".join(line.replace(" ", "|").upper() + "|")


def ltr_to_words(line: str) -> List[str]:
    """Inverse view of a letter transcript: '|'-bounded words."""
    return [w for w in line.strip().replace(" ", "").split("|") if w]


def read_lexicon(path: str, kaldi_format: bool = False) -> Dict[str, List[str]]:
    """word -> phones. kaldi align_lexicon.txt repeats the word twice
    (``WORD WORD ph1 ph2 ...``, reference ltr2kaldi_phn_sil025.py)."""
    lex: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for raw in f:
            items = raw.split()
            if not items:
                continue
            if kaldi_format:
                if len(items) < 3 or items[0] != items[1]:
                    raise ValueError(f"bad align-lexicon line: {raw!r}")
                lex[items[0]] = items[2:]
            else:
                if len(items) < 2:
                    raise ValueError(f"bad lexicon line: {raw!r}")
                if items[0] in lex:
                    raise ValueError(f"duplicate lexicon entry: {items[0]}")
                lex[items[0]] = items[1:]
    return lex


def normalize_phn(phones: Iterable[str]) -> List[str]:
    """Strip stress digits: g2p-style 39-phone normalization."""
    return [p.rstrip("0123456789") for p in phones]


def phonemize_with_sil(
    line: str,
    lexicon: Dict[str, List[str]],
    rng: np.random.Generator,
    sil_prob: float = 0.0,
    surround: bool = False,
    oov: str = "skip",
) -> Optional[List[str]]:
    """Words -> phones with optional inter-word silence.

    ``oov``: 'skip' drops lines containing OOV words (the reference's
    non-strict path), 'error' raises, 'as-is' emits the OOV word itself as a
    single token (stands in for the reference's g2p fallback — g2p_en is not
    in-image). Reference: phoneize_with_sil.py.
    """
    words = line.strip().upper().split()
    missing = [w for w in words if w not in lexicon]
    if missing:
        if oov == "skip":
            return None
        if oov == "error":
            raise KeyError(f"OOV words {missing[:5]}")
    phones: List[str] = [SIL] if surround else []
    sil_draws = rng.random(len(words) - 1) if (
        sil_prob > 0 and len(words) > 1) else None
    for i, w in enumerate(words):
        phones.extend(lexicon.get(w, [w]))
        if sil_draws is not None and i < len(sil_draws) \
                and sil_draws[i] < sil_prob:
            phones.append(SIL)
    if surround:
        phones.append(SIL)
    return phones


def kaldi_phonemize(
    ltr_line: str,
    lexicon: Dict[str, List[str]],
    rng: np.random.Generator,
    sil_prob: float = 0.25,
) -> Tuple[List[str], int, int]:
    """Letter transcript -> kaldi phones, !SIL surround + p(sil_prob)
    insertion between words, <UNK> substitution for OOV. Returns
    (phones, oov_count, word_count). Reference: ltr2kaldi_phn_sil025.py."""
    words = ltr_to_words(ltr_line)
    phones = list(lexicon[KALDI_SIL_WORD])
    sil_draws = rng.random(len(words) - 1) if (
        sil_prob > 0 and len(words) > 1) else None
    oov = 0
    for i, w in enumerate(words):
        if w not in lexicon:
            w = KALDI_UNK_WORD
            oov += 1
        phones.extend(lexicon[w])
        if sil_draws is not None and i < len(sil_draws) \
                and sil_draws[i] < sil_prob:
            phones.extend(lexicon[KALDI_SIL_WORD])
    phones.extend(lexicon[KALDI_SIL_WORD])
    return phones, oov, len(words)


def repeat_phones(
    phones: Sequence[str],
    mean_std: Dict[str, Sequence[float]],
    rng: np.random.Generator,
    max_len: int = 4375,
    default: Sequence[float] = (5.0, 2.5),
) -> List[str]:
    """Expand a reduced phone sequence to frame level by sampling each
    phone's repeat count from N(mean, std) (clamped to >= 1). If the result
    reaches ``max_len``, fall back to deterministic ``mean - k`` repeats with
    the smallest k that fits (reference
    repeat_withou_insert_sil_less_4375.py)."""
    out: List[str] = []
    for phn in phones:
        m, s = mean_std.get(phn, default)
        n = max(1, round(float(rng.normal(m, s))))
        out.extend([phn] * n)
    minus = 0
    while len(out) >= max_len:
        minus += 1
        out = []
        at_floor = True
        for phn in phones:
            m, _s = mean_std.get(phn, default)
            n = max(1, round(m - minus))
            at_floor &= n <= 1
            out.extend([phn] * n)
        if at_floor:
            # Every phone is already at 1 repeat; further reduction cannot
            # shrink the sequence (reference script would loop forever here).
            return out[: max_len - 1]
    return out


def filter_paired_by_len(
    src_lines: Sequence[str],
    tgt_lines: Sequence[str],
    max_len: int = 2998,
) -> Tuple[List[str], List[str]]:
    """Keep pairs where both sides have 0 < token count < max_len
    (reference filter_paireddata_by_len.py)."""
    src_out, tgt_out = [], []
    for s, t in zip(src_lines, tgt_lines):
        ls, lt = len(s.split()), len(t.split())
        if 0 < ls < max_len and 0 < lt < max_len:
            src_out.append(s)
            tgt_out.append(t)
    return src_out, tgt_out


# --------------------------------------------------------------------------
# text-to-unit (T2U) manifests for the FastSpeech2 tokenizer
# --------------------------------------------------------------------------

def run_length_durations(fa_ids: np.ndarray) -> np.ndarray:
    """Run lengths of consecutive equal ids (reference get_duration)."""
    fa_ids = np.asarray(fa_ids)
    same = np.concatenate(([True], fa_ids[:-1] != fa_ids[1:], [True]))
    return np.diff(np.where(same)[0])


def unique_consecutive(fa_ids: np.ndarray) -> np.ndarray:
    fa_ids = np.asarray(fa_ids)
    keep = np.concatenate(([True], fa_ids[1:] != fa_ids[:-1]))
    return fa_ids[keep]


T2U_COLUMNS = ("id", "speaker", "n_frames", "tgt_text", "unit", "duration")


def t2u_manifest_rows(
    audio_manifest: str,
    phn_path: str,
    km_path: str,
    add_duration: bool = True,
) -> List[Dict[str, str]]:
    """Merge an audio manifest + force-aligned phone stream + unit stream
    into T2U training rows. With ``add_duration`` the phone stream is
    frame-level aligned ids: durations are its run lengths and tgt_text the
    run-length-collapsed phones (reference get_t2u_manifest.py); otherwise
    the phone stream is used as-is."""
    rows = []
    with open(audio_manifest, encoding="utf-8") as f1, \
            open(phn_path, encoding="utf-8") as f2, \
            open(km_path, encoding="utf-8") as f3:
        f1.readline()  # audio root
        for audio_line, phn_line, km_line in zip(f1, f2, f3):
            rel = audio_line.rstrip("\n").split("\t")[0]
            units = km_line.strip()
            uttid = os.path.basename(rel).rsplit(".", 1)[0]
            row = {
                "id": uttid,
                "speaker": uttid.split("-")[0],
                "n_frames": str(len(units.split())),
                "unit": units,
            }
            phones = phn_line.split()
            if add_duration:
                if len(phones) != len(units.split()):
                    raise ValueError(
                        f"{uttid}: {len(phones)} aligned phones vs "
                        f"{len(units.split())} units")
                fa = np.asarray(list(map(int, phones)))
                row["duration"] = " ".join(
                    map(str, run_length_durations(fa)))
                row["tgt_text"] = " ".join(map(str, unique_consecutive(fa)))
            else:
                row["tgt_text"] = " ".join(phones)
            rows.append(row)
    return rows


def t2u_manifest_textonly_rows(phn_path: str,
                               prefix: str = "librilm") -> List[Dict[str, str]]:
    """Unpaired-text rows for T2U generation (reference
    get_t2u_manifest_textonly.py; unit column is a dummy 0)."""
    rows = []
    with open(phn_path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            phones = line.strip()
            rows.append({
                "id": f"{prefix}-{i}",
                "speaker": prefix,
                "n_frames": str(len(phones.split())),
                "tgt_text": phones,
                "unit": "0",
            })
    return rows


def write_tsv(rows: Sequence[Dict[str, str]], path: str,
              columns: Sequence[str] = T2U_COLUMNS) -> None:
    cols = [c for c in columns if rows and c in rows[0]]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\t".join(cols) + "\n")
        for row in rows:
            f.write("\t".join(row[c] for c in cols) + "\n")


# --------------------------------------------------------------------------
# columned ST TSVs (fairseq speech_to_text format)
# --------------------------------------------------------------------------

def read_columned_tsv(path: str) -> List[Dict[str, str]]:
    """Header-row TSV -> row dicts (the fairseq speech_to_text manifest
    format: ``id  audio  n_frames  tgt_text``, e.g. the shipped CoVoST2
    fixture SpeechLM/dataset/CommonVoice/v4/en/en-de/
    dev-sample100_st_en_de_local.tsv)."""
    with open(path, encoding="utf-8") as f:
        header = f.readline().rstrip("\n").split("\t")
        return [dict(zip(header, line.rstrip("\n").split("\t")))
                for line in f if line.strip()]


def convert_st_tsv(
    tsv_path: str,
    audio_root: Optional[str] = None,
) -> Tuple[List[str], List[str]]:
    """Columned ST TSV -> (audio manifest lines, target label lines) in the
    formats our SpeechToTextDataset consumes. ``audio_root`` remaps the
    TSV's (possibly machine-specific) absolute audio paths to
    ``audio_root/<basename>``; otherwise the common dirname is the root.
    n_frames comes from the TSV — no audio is opened."""
    rows = read_columned_tsv(tsv_path)
    if not rows:
        raise ValueError(f"empty ST tsv: {tsv_path}")
    if audio_root:
        root = os.path.abspath(audio_root)
        rels = [os.path.basename(r["audio"]) for r in rows]
    else:
        root = os.path.commonpath([os.path.dirname(r["audio"]) for r in rows])
        rels = [os.path.relpath(r["audio"], root) for r in rows]
    manifest = [root] + [
        f"{rel}\t{int(row['n_frames'])}" for rel, row in zip(rels, rows)
    ]
    labels = [row["tgt_text"] for row in rows]
    return manifest, labels
