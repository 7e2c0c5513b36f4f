"""The port's joint CTC/attention beam decoder and its serving held
against the JAX package (tests/test_beam.py is the specification):
``ASRDecoder`` at ``tiny`` through weights from ``from_jax_params`` (the
whole [B, K, L+1] token array equal, scores 1e-5; CTC weight 0 and 0.3,
batch 2 of unequal lengths, "ancestry" and "gather", ``steps_per_iter`` 1
and 4, the decode-step kernel's twin on and off, an ensemble),
``Service(--decoder beam)`` against the JAX ``Service.transcribe``, and the
serve entry point's default (beam) answering over HTTP on localhost.  The
parts (prefix scorer, search, decode steps) are in
``test_torch_beam_core.py``.

Torch runs with TF32 off, JAX at ``highest`` matmul precision
(tests/conftest.py).  The JAX decoders are built once per module.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import speecht5_tpu.config as JC
from speecht5_tpu.decode.asr import ASRDecoder as JASRDecoder
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.cli import serve
from speecht5_tpu_torch.decode.asr import ASRDecoder
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.utils.convert import from_jax_params
from test_torch_asr_slice import _flat, _jax_service

torch.backends.cuda.matmul.allow_tf32 = False
DECODE_FLAG = ["decoder.use_pallas_attn=True"]
# sub-nets of the port's model that the s2t path (and so the beam) never
# runs; their weights stay the port's own random ones
T2S_ONLY = ("text_encoder_prenet.", "speech_decoder_prenet.", "speech_decoder_postnet.",
            "spkembs_projection.")


def _init_jax(cfg, T=4000):
    """JAX parameters of the s2t forward, the sub-nets the beam runs (one
    jitted init: the same values as an eager one, compiled once)."""
    def s2t(m, wav, lens, prev):
        return m.forward_s2t(wav, lens, prev, mask=False, deterministic=True)

    return jax.jit(lambda key: JModel(cfg).init(
        {"params": key}, jnp.zeros((1, T), jnp.float32),
        jnp.full((1,), T, jnp.int32), jnp.full((1, 4), cfg.eos_id, jnp.int32),
        method=s2t))(jax.random.PRNGKey(0))


def _load(model, variables):
    """Load the s2t parameters; every port parameter they leave out
    belongs to a t2s-only sub-net."""
    missing, unexpected = model.load_state_dict(from_jax_params(_flat(variables)),
                                                strict=False)
    assert not unexpected and all(k.startswith(T2S_ONLY) for k in missing), missing
    return model


def _port(variables, overrides=(), **kw):
    cfg = PC.apply_overrides(PC.speecht5_tiny(**chip_smoke.DICT_CFG, **kw),
                             list(overrides))
    return cfg, _load(init_model(cfg, device="cpu"), variables)


@pytest.fixture(scope="module")
def tiny():
    cfg = JC.speecht5_tiny(**chip_smoke.DICT_CFG)
    return cfg, _init_jax(cfg)


# ------------------------------------------------------------------ ASRDecoder


def _audio(B=2, T=4000, seed=1):
    wav = (np.random.default_rng(seed).standard_normal((B, T)) * 0.1).astype(np.float32)
    return wav, np.array([4000, 2500][:B], np.int32)


@pytest.fixture(scope="module")
def jax_decodes(tiny):
    """JAX ASRDecoder results at tiny, batch 2 of unequal lengths, beam 4,
    max_len 12, min_len 3, for CTC weights 0 and 0.3 (test_beam.py's
    ancestry and steps_per_iter cases)."""
    cfg, variables = tiny
    wav, lens = _audio()
    out = {}
    for w in (0.0, 0.3):
        dec = JASRDecoder(JModel(cfg), variables, beam_size=4, max_len=12,
                          ctc_weight=w, min_len=3)
        out[w] = dec(jnp.asarray(wav), jnp.asarray(lens))
    return out


@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
@pytest.mark.parametrize("cache_reorder,steps_per_iter,flags", [
    ("ancestry", 4, []), ("ancestry", 1, []), ("gather", 4, []),
    ("ancestry", 4, DECODE_FLAG), ("gather", 1, DECODE_FLAG),
])
def test_asr_decoder_matches_jax(tiny, jax_decodes, ctc_weight, cache_reorder,
                                 steps_per_iter, flags):
    cfg, variables = tiny
    _, model = _port(variables, flags)
    dec = ASRDecoder(model, beam_size=4, max_len=12, ctc_weight=ctc_weight, min_len=3,
                     cache_reorder=cache_reorder, steps_per_iter=steps_per_iter,
                     device="cpu")
    K.reset_launch_counts()
    res = dec(*_audio())
    _same_result_tol(res, jax_decodes[ctc_weight])
    assert K.flash_attention_bias.launches == 0      # the CPU takes the twin
    assert 0 < dec.steps_run <= 12


def _same_result_tol(res, jres):
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(jres.scores),
                               atol=1e-5, rtol=1e-5)


def test_ensemble_matches_jax(tiny):
    """Two models: decoder log probs averaged in probability space, CTC
    from the first (test_beam.py:145-187)."""
    cfg, variables = tiny
    other = jax.tree_util.tree_map(lambda a: a * 0.9, variables)
    wav, lens = _audio(seed=4)
    kw = dict(beam_size=3, max_len=8, ctc_weight=0.3)
    jres = JASRDecoder(JModel(cfg), [variables, other], **kw)(jnp.asarray(wav),
                                                               jnp.asarray(lens))
    _, m1 = _port(variables)
    _, m2 = _port(other)
    res = ASRDecoder([m1, m2], device="cpu", **kw)(wav, lens)
    _same_result_tol(res, jres)


def test_asr_decoder_refuses_lm_fusion(tiny):
    """LM fusion is ported (tests/test_torch_lm.py); what is refused is a
    fusion LM over another vocabulary than the model's."""
    from speecht5_tpu_torch.models.lm import TransformerLM, lm_tiny

    _, model = _port(tiny[1])
    with pytest.raises(ValueError, match="vocabulary"):
        ASRDecoder(model, lm=TransformerLM(lm_tiny()), lm_weight=0.5, device="cpu")


# ---------------------------------------------------------------------- serve


def _beam_args(ckpt, dict_path, *extra):
    return serve.build_parser().parse_args([
        "--arch", "speecht5_tiny", "--ckpt", ckpt, "--dict", dict_path,
        "--dtype", "float32", "--asr-buckets", "2", "--max-len", "8",
        "--device", "cpu", *extra])


def test_service_beam_matches_jax_service(tiny, tmp_path):
    """Service(--decoder beam) against the JAX Service's beam arm on the
    same weights, request by request (one chunked): equal texts."""
    cfg, variables = tiny
    pcfg, model = _port(variables, chip_smoke.BEAM_OVERRIDES)
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    args = _beam_args("unused", dict_path)
    assert (args.decoder, args.beam, args.ctc_weight) == ("beam", 5, 0.3)
    assert serve.build_parser().get_default("max_len") == 200
    svc = serve.Service(args, model=model, cfg=pcfg, device="cpu")
    jsvc = _jax_service(cfg, variables, dict_path, args)
    jsvc.asr = JASRDecoder(JModel(cfg), variables, beam_size=args.beam,
                           max_len=args.max_len, ctc_weight=args.ctc_weight)
    texts = []
    for i, secs in enumerate((0.4, 1.3, 2.5)):
        wav = chip_smoke.synth_audio(secs, seed=40 + i)
        texts.append(svc.transcribe(wav))
        assert texts[-1] == jsvc.transcribe(wav)
    assert svc.asr_requests == jsvc.asr_requests == 4
    assert any(texts)


def test_service_beam_micro_batches_chunks_of_one_request(tiny, tmp_path):
    """--max-batch 2: the collector decodes both same-bucket windows of a
    chunked request as one beam batch, with the text of --max-batch 1."""
    cfg, variables = tiny
    pcfg, model = _port(variables, chip_smoke.BEAM_OVERRIDES)
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    one = serve.Service(_beam_args("unused", dict_path), model=model, cfg=pcfg,
                        device="cpu")
    two = serve.Service(_beam_args("unused", dict_path, "--max-batch", "2",
                                   "--batch-window-ms", "200"),
                        model=model, cfg=pcfg, device="cpu")
    wav = chip_smoke.synth_audio(3.5, seed=20)   # windows [0, 2] and [1.5, 3.5] s
    assert two.transcribe(wav) == one.transcribe(wav)
    assert (two.asr_calls, two.asr_requests) == (1, 2)


def test_serve_main_defaults_to_beam_and_answers(tiny, tmp_path, capsys, monkeypatch):
    """``cli/serve.main`` with no --decoder restores a port checkpoint,
    warms its buckets through the beam (printing the decode steps) and
    answers /healthz and one /asr request over HTTP on localhost with the
    text of a Service built from the same arguments."""
    cfg, variables = tiny
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    _, model = _port(variables)
    torch.save({"model": model.state_dict()}, ckpt / "checkpoint_3.pt")
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    argv = ["--arch", "speecht5_tiny", "--ckpt", str(ckpt), "--dict", dict_path,
            "--dtype", "float32", "--asr-buckets", "1", "--max-len", "8",
            "--device", "cpu", "--port", "0"]
    served = []

    def serve_two(self):             # /healthz, then /asr, then return
        served.append(self.server_address[1])
        self.handle_request()
        self.handle_request()
        self.server_close()

    monkeypatch.setattr(serve.ThreadingHTTPServer, "serve_forever", serve_two)
    thread = threading.Thread(target=serve.main, args=(argv,), daemon=True)
    thread.start()
    out, deadline = "", time.monotonic() + 120
    while '"serving": true' not in out and thread.is_alive() and time.monotonic() < deadline:
        thread.join(0.2)
        out += capsys.readouterr().out
    port = json.loads(out.strip().splitlines()[-1])["port"]
    assert "loaded checkpoint step 3" in out
    assert "warmed ASR bucket 1s batch 1 (" in out and "decode steps)" in out
    base = f"http://127.0.0.1:{port}"
    health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=60).read())
    assert health["decoder"] == "beam"
    wav = chip_smoke.synth_audio(0.7, seed=50)
    wav_path = tmp_path / "req.wav"
    from speecht5_tpu_torch.data.audio import write_wav

    write_wav(str(wav_path), wav)
    req = urllib.request.Request(base + "/asr", data=wav_path.read_bytes(), method="POST")
    text = json.loads(urllib.request.urlopen(req, timeout=120).read())["text"]
    thread.join(60)
    assert not thread.is_alive() and served == [port]
    svc = serve.Service(serve.build_parser().parse_args(argv[:-2] + ["--device", "cpu"]),
                        device="cpu")
    assert text == svc.transcribe(serve._parse_wav(wav_path.read_bytes()))


def test_service_refuses_ctc_rescore(tiny, tmp_path):
    """ctc_rescore is ported (tests/test_torch_rescore.py); what is refused
    is a word LM without a lexicon, which would be silently ignored."""
    pcfg, model = _port(tiny[1])
    args = _beam_args("unused", chip_smoke.write_dictionary(str(tmp_path)),
                      "--decoder", "ctc_rescore", "--lm-path", "lm.arpa")
    with pytest.raises(ValueError, match="--lm-path requires --lexicon"):
        serve.Service(args, model=model, cfg=pcfg, device="cpu")
