"""The port's fairseq-binarized corpora (``data/binarized.py``) and
SentencePiece reader (``data/sentencepiece.py``) held against the JAX
package, and ``TextPretrainDataset`` reading either.

Files written by one side are byte-identical to the other's and read by
both (the mmap ``MMIDIDX`` format and the legacy ``TNTIDX`` one).  The
SentencePiece models are ``ModelProto`` messages serialized here (a
unigram and a BPE model: no ``.model`` file is in the repository); their
ids, pieces and decodes equal JAX's.  Collated pretraining batches over a
binarized prefix or an SPM dictionary are bit-equal to JAX's.
"""

import struct

import numpy as np
import pytest

import chip_smoke
from speecht5_tpu.data import binarized as JB
from speecht5_tpu.data import manifests as JMan
from speecht5_tpu.data import sentencepiece as JS
from speecht5_tpu.data.dictionary import load_cli_dictionary as jload_dict
from speecht5_tpu_torch.data import binarized as PB
from speecht5_tpu_torch.data import manifests as PMan
from speecht5_tpu_torch.data import sentencepiece as PS
from speecht5_tpu_torch.data.dictionary import load_cli_dictionary

SEQS = [[5, 6, 7], [], [8], list(range(4, 60)), [9, 10]]


def _files(prefix):
    return [open(prefix + s, "rb").read() for s in (".bin", ".idx")]


@pytest.mark.parametrize("fmt", ["mmap_uint16", "mmap_int32", "legacy_int32",
                                 "legacy_int64"])
def test_writers_byte_identical_and_each_side_reads_the_others(tmp_path, fmt):
    kind, dtype = fmt.split("_")
    jp, pp = str(tmp_path / "j"), str(tmp_path / "p")
    if kind == "mmap":
        vocab = 100 if dtype == "uint16" else 70000
        JB.write_binarized(jp, SEQS, vocab_size=vocab)
        PB.write_binarized(pp, SEQS, vocab_size=vocab)
    else:
        JB.write_legacy(jp, SEQS, dtype=np.dtype(dtype))
        PB.write_legacy(pp, SEQS, dtype=np.dtype(dtype))
    assert _files(jp) == _files(pp)
    for reader, prefix in ((PB.MMapIndexedDataset, jp), (JB.MMapIndexedDataset, pp),
                           (PB.MMapIndexedDataset, pp)):
        ds = reader(prefix)
        assert ds.dtype == np.dtype(dtype) and len(ds) == len(SEQS)
        assert [ds[i].tolist() for i in range(len(ds))] == SEQS
        assert ds[-1].tolist() == SEQS[-1] and ds[0].dtype == np.int64
    assert PB.exists(pp) and not PB.exists(str(tmp_path / "nope"))


def test_bad_magic_refused_and_dtype_rule(tmp_path):
    p = str(tmp_path / "bad")
    open(p + ".bin", "wb").close()
    with open(p + ".idx", "wb") as f:
        f.write(b"NOTANIDX" + struct.pack("<Q", 1))
    for reader in (PB.MMapIndexedDataset, JB.MMapIndexedDataset):
        with pytest.raises(ValueError, match="magic"):
            reader(p)
    for vocab in (None, 100, 65499, 65500, 70000):
        assert PB.best_fitting_dtype(vocab) == JB.best_fitting_dtype(vocab)
    assert PB.best_fitting_dtype(70000) == np.int32
    assert PB.best_fitting_dtype(81) == np.uint16


def _text(tmp_path):
    text = tmp_path / "text.txt"
    rng = np.random.default_rng(0)
    letters = [chr(ord("A") + i) for i in range(26)]
    lines = []
    for i in range(30):
        words = ["".join(rng.choice(letters, int(rng.integers(2, 8))))
                 for _ in range(int(rng.integers(1, 6)))]
        lines.append(" ".join(" ".join(w) + " |" for w in words) if i % 7 else "")
    text.write_text("\n".join(lines) + "\n")
    return str(text)


def _collate_equal(j, p):
    assert len(j) == len(p) > 3 and np.array_equal(j.sizes, p.sizes)
    for epoch in (0, 1):
        jb = j.collate([j[i] for i in range(3)], epoch=epoch)
        pb = p.collate([p[i] for i in range(3)], epoch=epoch)
        assert set(jb) == set(pb)
        for k in jb:
            np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)


@pytest.mark.parametrize("mode", ["none", "complete", "eos"])
def test_text_pretrain_dataset_on_a_binarized_prefix_equals_jax(tmp_path, mode):
    """The smoke's binarizer (each non-empty line by the dictionary, no EOS)
    writes the corpus; both packages read ``.bin``, ``.idx`` or the bare
    prefix, and the blocks equal those of the raw file."""
    text = _text(tmp_path)
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    bin_path = chip_smoke.binarize_text(text, dict_path)
    prefix = bin_path[:-4]
    jd, _ = jload_dict(dict_path)
    pd, _ = load_cli_dictionary(dict_path)
    kw = dict(tokens_per_sample=24, mask_id=pd.index("<mask>"), seed=3, break_mode=mode)
    raw = PMan.TextPretrainDataset(text_file=text, dictionary=pd, **kw)
    for name in (bin_path, prefix + ".idx", prefix):
        j = JMan.TextPretrainDataset(text_file=name, dictionary=jd, **kw)
        p = PMan.TextPretrainDataset(text_file=name, dictionary=pd, **kw)
        _collate_equal(j, p)
        assert len(p.blocks) == len(raw.blocks)
        assert all(np.array_equal(a, b) for a, b in zip(p.blocks, raw.blocks))


# --------------------------------------------------------------- SentencePiece


def _varint(v):
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        out += bytes([b | (0x80 if v else 0)])
        if not v:
            return out


def _field(num, wire, payload):
    key = _varint((num << 3) | wire)
    if wire == 0:
        return key + _varint(payload)
    if wire == 5:
        return key + struct.pack("<f", payload)
    return key + _varint(len(payload)) + payload


def write_spm(path, pieces, model_type, add_dummy_prefix=True):
    """A ``ModelProto``: pieces (piece, score, type), the trainer spec's
    model_type and the normalizer spec's add_dummy_prefix."""
    msg = b"".join(_field(1, 2, _field(1, 2, p.encode()) + _field(2, 5, s) + _field(3, 0, t))
                   for p, s, t in pieces)
    msg += _field(2, 2, _field(3, 0, model_type) + _field(7, 0, 8000))
    msg += _field(4, 2, _field(1, 2, b"nmt_nfkc") + _field(6, 0, int(add_dummy_prefix)))
    with open(path, "wb") as f:
        f.write(msg)


SPECIAL = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
UNIGRAM = SPECIAL + [(p, -float(i) * 0.37 - 1.0, 1) for i, p in enumerate(
    ["▁the", "▁", "e", "t", "h", "a", "▁cat", "c", "s", "▁a", "at",
     "▁sat", "o", "n", "▁on", "m", "▁mat", "r", "i", "▁is"])]
BPE = SPECIAL + [(p, -float(i), 1) for i, p in enumerate(
    ["▁t", "he", "▁the", "at", "▁c", "▁cat", "▁s", "▁sat",
     "on", "▁on", "▁m", "▁mat"])] + [
    (c, -100.0 - i, 1) for i, c in enumerate("▁thecasonmri")]
TEXTS = ["the cat sat on the mat", "  The  cat\tis on a mat ", "xylophone cat",
         "", "thethe", "a"]


@pytest.mark.parametrize("kind", ["unigram", "bpe"])
def test_sentencepiece_encode_decode_equal_jax(tmp_path, kind):
    path = str(tmp_path / f"{kind}.model")
    write_spm(path, UNIGRAM if kind == "unigram" else BPE, JS.UNIGRAM if kind == "unigram"
              else JS.BPE)
    j, p = JS.SentencePieceModel.load(path), PS.SentencePieceModel.load(path)
    assert len(p) == len(j) and p.model_type == j.model_type and p.unk_id == j.unk_id == 0
    for text in TEXTS:
        assert p.normalize(text) == j.normalize(text)
        ids, pieces = p.encode(text), p.encode(text, out="piece")
        assert ids == j.encode(text) and pieces == j.encode(text, out="piece")
        assert p.decode(ids) == j.decode(ids) and p.decode(pieces) == j.decode(pieces)
    assert p.encode("the cat", out="piece")[0] == "▁the"


def test_text_pretrain_dataset_with_an_spm_dictionary_equals_jax(tmp_path):
    path = str(tmp_path / "u.model")
    write_spm(path, UNIGRAM, JS.UNIGRAM)
    text = tmp_path / "t.txt"
    text.write_text("".join(f"the cat sat on the mat {'a ' * (i % 4)}\n" for i in range(20)))
    kw = dict(tokens_per_sample=16, mask_id=len(UNIGRAM) - 1, seed=2)
    j = JMan.TextPretrainDataset(text_file=str(text), dictionary=JS.SentencePieceModel.load(path),
                                 **kw)
    p = PMan.TextPretrainDataset(text_file=str(text), dictionary=PS.SentencePieceModel.load(path),
                                 **kw)
    _collate_equal(j, p)
