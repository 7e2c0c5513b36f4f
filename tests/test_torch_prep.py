"""The port's data preparation (``data/prep.py``, ``cli/prep.py``) held
against the JAX package: every function of ``data/prep.py`` returns what
JAX's returns at the same seeds, and each of the eleven ``cli/prep.py``
subcommands writes files byte-identical to JAX's ``cli/prep.main`` on the
inputs written here (a WAV + FLAC tree, a CoVoST-shaped TSV, lexicons, an
ARPA LM, phone and unit streams).  The resample subcommand is held on
48 kHz FLAC and 16 kHz WAV: there the two resamplers agree bit for bit
(at 44.1 kHz they differ by ~1e-10, which tests/test_torch_audio_io.py
holds within 1e-6)."""

import json
import os
import re

import numpy as np
import pytest

import chip_smoke
from speecht5_tpu.cli import prep as JCLI
from speecht5_tpu.data import audio as JA
from speecht5_tpu.data import prep as JP
from speecht5_tpu_torch.cli import prep as PCLI
from speecht5_tpu_torch.data import prep as PP

LEXICON = "HELLO HH AH0 L OW1\nWORLD W ER1 L D\nTHE DH AH0\nCAT K AE1 T\nSAT S AE1 T\n"
ALIGN_LEXICON = ("!SIL !SIL SIL\n<UNK> <UNK> SPN\nHELLO HELLO HH AH L OW\n"
                 "WORLD WORLD W ER L D\nTHE THE DH AH\nCAT CAT K AE T\n")


@pytest.fixture
def inputs(tmp_path):
    """Every input file of the subcommands, under ``tmp_path/in``."""
    d = tmp_path / "in"
    rng = np.random.default_rng(0)
    for sub, name, sr, kind in (("a", "x", 16000, "wav"), ("a", "y", 16000, "flac"),
                                ("b", "z", 48000, "flac"), ("b", "w", 16000, "wav"),
                                ("b", "v", 16000, "flac"), ("c", "u", 8000, "wav")):
        os.makedirs(d / "audio" / sub, exist_ok=True)
        n = int(sr * rng.uniform(0.2, 0.5))
        path = str(d / "audio" / sub / f"{name}.{kind}")
        if kind == "wav":
            JA.write_wav(path, 0.2 * rng.standard_normal(n), sr)
        else:
            pcm = np.round(8000 * rng.standard_normal(n)).astype(np.int64)
            chip_smoke.write_flac(path, pcm, sr, total_samples=name != "v")
    (d / "audio" / "notes.txt").write_text("not audio\n")
    os.makedirs(d / "hi")
    chip_smoke.write_flac(str(d / "hi" / "one.flac"),
                          np.round(8000 * rng.standard_normal(24000)).astype(np.int64), 48000)
    (d / "words.wrd").write_text("hello world\nthe cat <unk> sat\n\nTHE  CAT\n")
    (d / "lex.txt").write_text(LEXICON)
    (d / "align.txt").write_text(ALIGN_LEXICON)
    (d / "t.ltr").write_text("H E L L O | W O R L D |\nF O O | C A T |\nT H E |\n")
    (d / "ms.json").write_text(json.dumps({"HH": [3.0, 1.0], "AH": [6.0, 2.0],
                                           "SIL": [40.0, 30.0]}))
    (d / "phn.txt").write_text("HH AH L OW\nSIL DH AH SIL\n" + "AH " * 300 + "\n")
    (d / "pair.en").write_text("a b c\n\n" + "x " * 40 + "\nd e\n")
    (d / "pair.de").write_text("q r\ns t\nu v\n\n")
    rows = ["id\taudio\tn_frames\ttgt_text"] + [
        f"cv{i}\t/data/cv/clips/c{i}.mp3\t{1000 + 17 * i}\tein Satz {i}" for i in range(4)]
    (d / "st.tsv").write_text("\n".join(rows) + "\n")
    chip_smoke.write_lexicon_lm(str(d), n_words=40)
    fa = [[3, 3, 3, 7, 7, 1], [2, 2, 5, 5, 5, 5, 9]]
    (d / "t2u.audio.tsv").write_text("/data/a\n1089-1-0.wav\t16000\n1089-1-1.wav\t18000\n")
    (d / "t2u.phn").write_text("".join(" ".join(map(str, f)) + "\n" for f in fa))
    (d / "t2u.km").write_text("".join(" ".join(str(9 + i) for i in range(len(f))) + "\n"
                                      for f in fa))
    return d


def _argv(cmd, d, out):
    """The subcommand's arguments, inputs in ``d``, outputs in ``out``."""
    return {
        "manifest": [["manifest", "--audio-root", f"{d}/audio", "--out", f"{out}/all.tsv",
                      "--valid-out", f"{out}/dev.tsv", "--valid-percent", "0.4",
                      "--seed", "3"],
                     ["manifest", "--audio-root", f"{d}/audio", "--out", f"{out}/flac.tsv",
                      "--ext", ".flac"]],
        "wrd2ltr": [["wrd2ltr", "--input", f"{d}/words.wrd", "--output", f"{out}/w.ltr"]],
        "phonemize": [["phonemize", "-i", f"{d}/words.wrd", "-o", f"{out}/p1", "--lexicon",
                       f"{d}/lex.txt", "-s", "0.5", "--surround", "--seed", "4"],
                      ["phonemize", "-i", f"{d}/words.wrd", "-o", f"{out}/p2", "--lexicon",
                       f"{d}/lex.txt", "--oov", "as-is"]],
        "kaldi-phn": [["kaldi-phn", "-i", f"{d}/t.ltr", "-o", f"{out}/k", "--lexicon",
                       f"{d}/align.txt", "--seed", "5"]],
        "repeat-phones": [["repeat-phones", "--input", f"{d}/phn.txt", "--mean-std",
                           f"{d}/ms.json", "--output", f"{out}/r", "--max-len", "600",
                           "--seed", "6"]],
        "filter-paired": [["filter-paired", "-i", f"{d}/pair", "-o", f"{out}/f", "-s", "en",
                           "-t", "de", "-m", "30"]],
        "st-manifest": [["st-manifest", "--tsv", f"{d}/st.tsv", "--out-manifest",
                         f"{out}/st1.tsv", "--out-labels", f"{out}/st1.txt"],
                        ["st-manifest", "--tsv", f"{d}/st.tsv", "--out-manifest",
                         f"{out}/st2.tsv", "--out-labels", f"{out}/st2.txt",
                         "--audio-root", f"{d}/audio"]],
        "letter-lexicon": [["letter-lexicon", "-i", f"{d}/words.wrd", "-o", f"{out}/lex"]],
        "resample": [["resample", "-i", f"{d}/audio/b", "-o", f"{out}/rs"],
                     ["resample", "-i", f"{d}/hi/one.flac", "-o", f"{out}/one.wav",
                      "--sr", "16000"]],
        "lm-binary": [["lm-binary", "--arpa", f"{d}/lm.arpa", "--out", f"{out}/lm.bin"],
                      ["lm-binary", "--arpa", f"{d}/lm.arpa", "--out", f"{out}/lm.kenlm",
                       "--format", "kenlm"]],
        "t2u-manifest": [["t2u-manifest", "--audio-manifest", f"{d}/t2u.audio.tsv", "--phn",
                          f"{d}/t2u.phn", "--km", f"{d}/t2u.km", "--out", f"{out}/t1.tsv"],
                         ["t2u-manifest", "--phn", f"{d}/phn.txt", "--out", f"{out}/t2.tsv"]],
    }[cmd]


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


SUBCOMMANDS = ["manifest", "wrd2ltr", "phonemize", "kaldi-phn", "repeat-phones",
               "filter-paired", "st-manifest", "letter-lexicon", "resample", "lm-binary",
               "t2u-manifest"]


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_cli_subcommand_writes_the_files_jax_writes(inputs, tmp_path, cmd):
    for side, main in (("j", JCLI.main), ("p", PCLI.main)):
        os.makedirs(tmp_path / side)
        for argv in _argv(cmd, inputs, tmp_path / side):
            assert main(argv) == 0
    j, p = _tree(tmp_path / "j"), _tree(tmp_path / "p")
    assert j and sorted(j) == sorted(p)
    for name in j:
        assert p[name] == j[name], name


def test_cli_subcommands_are_the_eleven(capsys):
    def choices(main):
        with pytest.raises(SystemExit):
            main(["no-such-command"])
        listed = capsys.readouterr().err.split("choose from")[1].split(")")[0]
        return sorted(re.findall(r"[a-z0-9-]+", listed))
    assert choices(PCLI.main) == choices(JCLI.main) == sorted(SUBCOMMANDS)


def test_manifest_functions_equal_jax(inputs):
    root = str(inputs / "audio")
    for name in ("a/x.wav", "a/y.flac", "b/z.flac", "b/v.flac", "c/u.wav"):
        path = os.path.join(root, name)
        assert PP.audio_num_samples(path) == JP.audio_num_samples(path)
    assert PP.flac_num_samples(f"{root}/b/v.flac") == 0     # no length in STREAMINFO
    assert PP.wav_num_samples(f"{root}/a/x.wav") == JP.wav_num_samples(f"{root}/a/x.wav")
    for vp, seed in ((0.0, 42), (0.5, 1), (1.0, 2)):
        assert PP.create_audio_manifest(root, valid_percent=vp, seed=seed) == \
            JP.create_audio_manifest(root, valid_percent=vp, seed=seed)
    with pytest.raises(ValueError):
        PP.wav_num_samples(f"{root}/a/y.flac")


def test_transcript_and_lexicon_functions_equal_jax(inputs):
    for line in ("hello world", " the  cat <unk> sat ", "", "a"):
        assert PP.wrd_to_ltr(line) == JP.wrd_to_ltr(line)
        assert PP.ltr_to_words(PP.wrd_to_ltr(line)) == JP.ltr_to_words(JP.wrd_to_ltr(line))
    lex = PP.read_lexicon(str(inputs / "lex.txt"))
    assert lex == JP.read_lexicon(str(inputs / "lex.txt"))
    align = PP.read_lexicon(str(inputs / "align.txt"), kaldi_format=True)
    assert align == JP.read_lexicon(str(inputs / "align.txt"), kaldi_format=True)
    bad = inputs / "bad.txt"
    for text, kaldi in (("A A1\nA A2\n", False), ("A\n", False), ("A B X\n", True)):
        bad.write_text(text)
        for read in (PP.read_lexicon, JP.read_lexicon):
            with pytest.raises(ValueError):
                read(str(bad), kaldi_format=kaldi)
    assert PP.normalize_phn(["AH0", "T", "ER12"]) == JP.normalize_phn(["AH0", "T", "ER12"])
    for line in ("hello world the cat", "hello zebra", "cat"):
        for kw in ({"sil_prob": 0.5, "surround": True}, {"oov": "as-is"}, {"sil_prob": 1.0}):
            got = PP.phonemize_with_sil(line, lex, np.random.default_rng(7), **kw)
            assert got == JP.phonemize_with_sil(line, lex, np.random.default_rng(7), **kw)
        if "zebra" in line:
            for fn in (PP.phonemize_with_sil, JP.phonemize_with_sil):
                with pytest.raises(KeyError):
                    fn(line, lex, np.random.default_rng(0), oov="error")
    for ltr in ("H E L L O | W O R L D |", "F O O | C A T |", "T H E |"):
        for p in (0.0, 0.25, 1.0):
            assert PP.kaldi_phonemize(ltr, align, np.random.default_rng(3), p) == \
                JP.kaldi_phonemize(ltr, align, np.random.default_rng(3), p)


def test_phone_text_and_t2u_functions_equal_jax(inputs, tmp_path):
    ms = {"A": (4.0, 2.0), "B": (1.0, 0.5)}
    for phones, max_len in ((["A", "B", "C"] * 5, 4375), (["A"] * 50, 60), (["B"] * 30, 20)):
        assert PP.repeat_phones(phones, ms, np.random.default_rng(2), max_len=max_len) == \
            JP.repeat_phones(phones, ms, np.random.default_rng(2), max_len=max_len)
    src, tgt = ["a b", "", "c " * 10, "d"], ["x", "y", "z", ""]
    assert PP.filter_paired_by_len(src, tgt, 5) == JP.filter_paired_by_len(src, tgt, 5)
    fa = np.array([4, 4, 1, 1, 1, 9, 4])
    assert np.array_equal(PP.run_length_durations(fa), JP.run_length_durations(fa))
    assert np.array_equal(PP.unique_consecutive(fa), JP.unique_consecutive(fa))
    args = (str(inputs / "t2u.audio.tsv"), str(inputs / "t2u.phn"), str(inputs / "t2u.km"))
    for dur in (True, False):
        rows = PP.t2u_manifest_rows(*args, add_duration=dur)
        assert rows == JP.t2u_manifest_rows(*args, add_duration=dur)
        PP.write_tsv(rows, str(tmp_path / "p.tsv"))
        JP.write_tsv(rows, str(tmp_path / "j.tsv"))
        assert (tmp_path / "p.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    assert PP.t2u_manifest_textonly_rows(str(inputs / "phn.txt"), "lm") == \
        JP.t2u_manifest_textonly_rows(str(inputs / "phn.txt"), "lm")
    (inputs / "t2u.phn").write_text("1 1 2\n")
    for fn in (PP.t2u_manifest_rows, JP.t2u_manifest_rows):
        with pytest.raises(ValueError):
            fn(*args)
    tsv = str(inputs / "st.tsv")
    assert PP.read_columned_tsv(tsv) == JP.read_columned_tsv(tsv)
    for root in (None, str(inputs / "audio")):
        assert PP.convert_st_tsv(tsv, root) == JP.convert_st_tsv(tsv, root)
