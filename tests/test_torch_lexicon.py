"""The port's lexicon decoding held against the JAX package
(tests/test_lexicon_decode.py is the specification): the port's native
``LexiconDecoder`` (``decode`` and ``decode_nbest``) against JAX's Python
reference (``lexicon_beam_py`` / ``lexicon_beam_nbest_py`` over its
``NGramLM``: tokens equal, scores within 1e-4 relative, the spec's bound
for the native library against the reference) and against JAX's native
decoder on the same library source, with the word LM as ARPA text,
gzipped ARPA, the native and the KenLM binary formats, and without an
LM; ``materialize_arpa`` against JAX's.  The lexicon and the ARPA are
written on the spot (``chip_smoke.write_lexicon_lm``).
"""

import math

import numpy as np
import pytest

from speecht5_tpu.decode import lexicon as J

import chip_smoke
from speecht5_tpu_torch.data.dictionary import load_cli_dictionary
from speecht5_tpu_torch.decode import lexicon as P

N_WORDS = 60


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lex"))
    lexicon, arpa = chip_smoke.write_lexicon_lm(d, N_WORDS, seed=3)
    _, arpa_gz = chip_smoke.write_lexicon_lm(d, N_WORDS, seed=3, gz=True)
    dictionary, _ = load_cli_dictionary(chip_smoke.write_dictionary(d))
    return {"dir": d, "lexicon": lexicon, "arpa": arpa, "arpa_gz": arpa_gz,
            "vocab": list(dictionary.symbols), "sep": dictionary.index("|"),
            "blank": dictionary.index("<ctc_blank>")}


def _lexicon_dict(path, vocab):
    index = {s: i for i, s in enumerate(vocab)}
    out = {}
    for line in open(path, encoding="utf-8"):
        word, spelling = line.rstrip("\n").split("\t")
        out[word] = [index[t] for t in spelling.split()]
    return out


def _posteriors(rng, T, V, peaked=None):
    """Random natural-log posteriors; ``peaked``: token ids that each frame
    in turn prefers, so that lexicon words win the beam."""
    e = rng.random((T, V)) + 1e-3
    if peaked is not None:
        for t in range(T):
            e[t, peaked[t % len(peaked)]] += 20.0
    return np.log(e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_materialize_arpa_equals_jax(files):
    """A plain ARPA passes through; a gzipped one decompresses once into
    build/arpa/ to the same text as the plain file and as JAX's copy."""
    assert P.materialize_arpa(files["arpa"]) == files["arpa"]
    plain = P.materialize_arpa(files["arpa_gz"])
    assert P.materialize_arpa(files["arpa_gz"]) == plain
    text = open(plain).read()
    assert text == open(files["arpa"]).read()
    assert text == open(J.materialize_arpa(files["arpa_gz"])).read()


@pytest.mark.parametrize("with_lm", [True, False])
def test_native_decoder_equals_jax_python_reference(files, with_lm):
    """The port's native decoder against JAX's pure-Python reference of the
    same algorithm: N-best and 1-best tokens equal, scores within 1e-4
    relative (tests/test_lexicon_decode.py:130-178), row 0 the 1-best."""
    lex = _lexicon_dict(files["lexicon"], files["vocab"])
    spell = [t for w in list(lex)[:3] for t in lex[w] + [files["sep"]]]
    rng = np.random.default_rng(1)
    kw = dict(blank=files["blank"], sep=files["sep"], lm_weight=0.5, word_score=1.0,
              beam=12)
    dec = P.LexiconDecoder(files["lexicon"], files["vocab"],
                           arpa_path=files["arpa"] if with_lm else None, **kw)
    lm = J.NGramLM(files["arpa"]) if with_lm else None
    for trial in range(3):
        lp = _posteriors(rng, 14 + trial, len(files["vocab"]), peaked=spell)
        got = dec.decode_nbest(lp, nbest=5)
        want = J.lexicon_beam_nbest_py(lp, lex, lm=lm, nbest=5, **kw)
        assert [t for t, _ in got] == [t for t, _ in want] and got
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-4)
        one, one_want = dec.decode(lp), J.lexicon_beam_py(lp, lex, lm=lm, **kw)
        assert one[0] == one_want[0] == got[0][0]
        assert math.isclose(one[1], one_want[1], rel_tol=1e-4)


@pytest.mark.parametrize("lm_format", ["arpa", "arpa_gz", "native", "kenlm", "none"])
def test_native_lexicon_decoder_equals_jax(files, tmp_path, lm_format):
    """One library source, two loaders: the port's (built under build/native)
    and JAX's give the same tokens and scores for every LM format; the
    binaries are written by the port's ``build_binary_lm``."""
    if lm_format in ("native", "kenlm"):
        lm_path = str(tmp_path / f"lm.{lm_format}.bin")
        P.build_binary_lm(files["arpa"], lm_path, format=lm_format)
    else:
        lm_path = {"arpa": files["arpa"], "arpa_gz": files["arpa_gz"],
                   "none": None}[lm_format]
    kw = dict(arpa_path=lm_path, blank=files["blank"], sep=files["sep"], lm_weight=0.5,
              word_score=1.0, beam=30)
    dec_p = P.LexiconDecoder(files["lexicon"], files["vocab"], **kw)
    dec_j = J.LexiconDecoder(files["lexicon"], files["vocab"], **kw)
    lex = _lexicon_dict(files["lexicon"], files["vocab"])
    spell = [t for w in list(lex)[5:9] for t in lex[w] + [files["sep"]]]
    rng = np.random.default_rng(2)
    for trial in range(4):
        lp = _posteriors(rng, 30 + 7 * trial, len(files["vocab"]), peaked=spell)
        assert dec_p.decode(lp) == dec_j.decode(lp)
        got, want = dec_p.decode_nbest(lp, nbest=6), dec_j.decode_nbest(lp, nbest=6)
        assert got == want and got[0][0] == dec_p.decode(lp)[0]
        assert len({tuple(t) for t, _ in got}) == len(got)
