"""The port's two-pass CTC N-best + attention rescore held against the JAX
package (tests/test_rescore.py is the specification): the N-best prefix
beam (the native ``ctc_nbest`` / ``ctc_nbest_batch`` through the port's
loader against JAX's Python reference, tokens equal and scores within
1e-4, the spec's bound, and equal to JAX's native beam through its own
loader), ``RescoreDecoder`` (tokens equal to
JAX's, pass 2 scores within 1e-5, open-vocabulary and through the lexicon
decoder, with and without the over-length drop) at ``tiny`` and at Base
width with 2 + 2 layers, random weights carried by ``from_jax_params``,
and ``Service(--decoder ctc_rescore)`` against the JAX Service's arm.

Torch runs with TF32 off, JAX at ``highest`` matmul precision
(tests/conftest.py).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import speecht5_tpu.config as JC
from speecht5_tpu.cli import serve as jserve
from speecht5_tpu.decode import nbest as JN
from speecht5_tpu.decode.asr import RescoreDecoder as JRescoreDecoder
from speecht5_tpu.decode.lexicon import LexiconDecoder as JLexiconDecoder
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.cli import serve
from speecht5_tpu_torch.data.dictionary import load_cli_dictionary
from speecht5_tpu_torch.decode import nbest as PN
from speecht5_tpu_torch.decode.asr import RescoreDecoder
from speecht5_tpu_torch.decode.lexicon import LexiconDecoder
from speecht5_tpu_torch.models.speecht5 import init_model
from test_torch_asr_slice import _jax_service
from test_torch_beam import _init_jax, _load

torch.backends.cuda.matmul.allow_tf32 = False
BASE2 = ["encoder.num_layers=2", "decoder.num_layers=2"]


def _posteriors(rng, T, V, blank=None):
    e = rng.random((T, V)) + 1e-3
    if blank is not None:
        e[::2, blank] += 8.0           # every other frame blank-dominated
    return np.log(e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("topk,blank_skip", [(0, 0.0), (3, 0.0), (0, 0.6)])
def test_ctc_nbest_equals_jax(topk, blank_skip):
    """The native beam through the port's loader against JAX's Python
    reference (tokens equal, scores within 1e-4 as
    tests/test_rescore.py:95-97) and equal to JAX's native one, single and
    batched."""
    rng = np.random.default_rng(topk)
    thresh = math.log(blank_skip) if blank_skip else 0.0
    kw = dict(blank=0, beam=8, nbest=5, topk=topk, blank_thresh=thresh)
    lps = [_posteriors(rng, T, 7, blank=0) for T in (9, 6, 12)]
    for lp in lps:
        got, want = PN.ctc_nbest(lp, **kw), JN.ctc_nbest_py(lp, **kw)
        assert [t for t, _ in got] == [t for t, _ in want] and got
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-4,
                                   rtol=0)
        assert got == JN.ctc_nbest(lp, **kw)
    batch = np.zeros((3, 12, 7), np.float32)
    for b, lp in enumerate(lps):
        batch[b, : len(lp)] = lp
    lens = np.array([len(lp) for lp in lps], np.int32)
    got = PN.ctc_nbest_batch(batch, lens, **kw)
    assert got == JN.ctc_nbest_batch(batch, lens, **kw)
    assert got == [PN.ctc_nbest(lp, **kw) for lp in lps]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rescore"))
    lexicon, arpa = chip_smoke.write_lexicon_lm(d, 40, seed=5)
    dict_path = chip_smoke.write_dictionary(d)
    dictionary, _ = load_cli_dictionary(dict_path)
    return {"lexicon": lexicon, "arpa": arpa, "dict": dict_path,
            "vocab": list(dictionary.symbols), "sep": dictionary.index("|")}


def _lexicons(files, blank, beam=16):
    kw = dict(arpa_path=files["arpa"], blank=blank, sep=files["sep"], lm_weight=0.5,
              word_score=1.0, beam=beam)
    return (LexiconDecoder(files["lexicon"], files["vocab"], **kw),
            JLexiconDecoder(files["lexicon"], files["vocab"], **kw))


@pytest.fixture(scope="module", params=["speecht5_tiny", "base_2_layers"])
def preset(request):
    if request.param == "speecht5_tiny":
        jcfg = JC.speecht5_tiny(**chip_smoke.DICT_CFG)
        pcfg = PC.speecht5_tiny(**chip_smoke.DICT_CFG)
    else:
        jcfg = JC.apply_overrides(JC.speecht5_base_asr(**chip_smoke.DICT_CFG), BASE2)
        pcfg = PC.apply_overrides(PC.speecht5_base_asr(**chip_smoke.DICT_CFG), BASE2)
    variables = _init_jax(jcfg, T=8000)
    return jcfg, variables, _load(init_model(pcfg, device="cpu"), variables)


def _audio(seed=7):
    wav = np.stack([chip_smoke.synth_audio(0.5, seed), chip_smoke.synth_audio(0.5, seed + 1)])
    return wav, np.array([8000, 5200], np.int32)


@pytest.mark.parametrize("lexicon,max_len", [(False, None), (False, 4), (True, None)])
def test_rescore_decoder_equals_jax(preset, files, lexicon, max_len):
    jcfg, variables, model = preset
    kw = dict(blank_id=jcfg.blank_id, eos_id=jcfg.eos_id, pad_id=jcfg.pad_id, nbest=4,
              beam=8, ctc_weight=0.3, max_len=max_len)
    lex_p, lex_j = _lexicons(files, jcfg.blank_id) if lexicon else (None, None)
    pdec = RescoreDecoder(model, lexicon=lex_p, device="cpu", **kw)
    jdec = JRescoreDecoder(JModel(jcfg), variables, lexicon=lex_j, **kw)
    wav, lens = _audio()
    got = pdec(wav, lens)
    assert got == jdec(jnp.asarray(wav), jnp.asarray(lens))
    # pass 2 on the same hypotheses: the port's scores against JAX's
    enc, lp, frames = pdec.encode(wav, lens)
    hyps, ctc = pdec.candidates(pdec.nbest_lists(lp, frames))
    assert all(len(row) == 4 for row in hyps)
    if max_len is not None:
        assert all(len(h) <= max_len for row in hyps for h in row)
    prev, tgt, tmask = pdec.teacher_forcing(hyps)
    assert prev.shape[-1] % pdec.len_step == 0
    got_scores = pdec.score(enc, *(torch.from_numpy(a) for a in (prev, tgt, tmask))).numpy()
    enc_out, enc_valid, jlp, _ = jdec._enc(variables, (jnp.asarray(wav), jnp.asarray(lens)))
    np.testing.assert_allclose(lp, np.asarray(jlp), atol=1e-5)
    want = np.asarray(jdec._score(variables, enc_out, enc_valid,
                                  *(jnp.asarray(a.astype(np.int32)) for a in (prev, tgt)),
                                  jnp.asarray(tmask)))
    np.testing.assert_allclose(got_scores, want, rtol=1e-5, atol=1e-5)
    assert set(pdec.last_ms) == {"encode", "nbest", "rescore"}


@pytest.mark.parametrize("lexicon", [False, True])
def test_service_ctc_rescore_equals_jax_service(files, lexicon):
    """Service(--decoder ctc_rescore) against the JAX Service's arm on the
    same weights, request by request (one chunked): equal texts."""
    jcfg = JC.speecht5_tiny(**chip_smoke.DICT_CFG)
    variables = _init_jax(jcfg)
    model = _load(init_model(PC.speecht5_tiny(**chip_smoke.DICT_CFG), device="cpu"),
                  variables)
    extra = ["--lexicon", files["lexicon"], "--lm-path", files["arpa"], "--lm-weight",
             "0.5", "--word-score", "1"] if lexicon else []
    args = serve.build_parser().parse_args([
        "--arch", "speecht5_tiny", "--ckpt", "unused", "--dict", files["dict"],
        "--dtype", "float32", "--asr-buckets", "2", "--decoder", "ctc_rescore",
        "--device", "cpu", *extra])
    assert (args.rescore_nbest, args.ctc_beam_size, args.ctc_topk) == (8, 50, 0)
    svc = serve.Service(args, model=model, cfg=PC.speecht5_tiny(**chip_smoke.DICT_CFG),
                        device="cpu")
    jsvc = _jax_service(jcfg, variables, files["dict"], args)
    lex_j = _lexicons(files, jcfg.blank_id, args.ctc_beam_size)[1] if lexicon else None
    jsvc.asr = jserve._CTCAdapter(JRescoreDecoder(
        JModel(jcfg), variables, blank_id=jcfg.blank_id, eos_id=jcfg.eos_id,
        pad_id=jcfg.pad_id, nbest=args.rescore_nbest, beam=args.ctc_beam_size,
        topk=args.ctc_topk, ctc_weight=args.ctc_weight, max_len=args.max_len,
        lexicon=lex_j))
    for i, secs in enumerate((0.4, 2.5)):
        wav = chip_smoke.synth_audio(secs, seed=60 + i)
        assert svc.transcribe(wav) == jsvc.transcribe(wav)
    assert svc.asr_requests == jsvc.asr_requests == 3


def test_chip_smoke_rescore_phases_run_on_cpu_with_twins():
    """Phases 20 and 21 at the tiny preset on the CPU: both Service runs
    (open-vocabulary and lexicon), each chunk's pass times, no launches;
    the parity phase's pass 2 scores agree on the same hypotheses."""
    from speecht5_tpu_torch import config as C

    runs = chip_smoke.phase_serve_rescore(C.speecht5_tiny(), device="cpu", dtype="float32",
                                          requests_s=(0.3, 2.1), buckets="1,2", n_words=50)
    for name in ("open", "lexicon"):
        reqs = runs[name]["requests"]
        assert [r["chunks"] for r in reqs] == [1, 2]
        assert all(r["pass1_host_ms"] > 0 and r["pass2_ms"] > 0 for r in reqs)
        assert set(runs[name]["counts"].values()) == {0}
    parity = chip_smoke.phase_rescore_parity(C.speecht5_tiny(), device="cpu",
                                             requests_s=(0.3, 1.1), buckets="1,2")
    assert parity["equal_picks"] == 2 and parity["worst_pass2_rel_diff"] < 1e-5
