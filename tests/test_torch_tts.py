"""The port's TTS path held against the JAX package: the speech decode step,
``TTSDecoder.text_to_speech``, the decode-step kernel's max-probability
output (its twin), HiFi-GAN and its converter, Griffin-Lim, and ``/tts``
served over HTTP on localhost.

One set of JAX variables (tiny preset, the 81-symbol letter vocabulary,
BatchNorm statistics moved off their init) crosses into the port through
``utils/convert.from_jax_params`` / ``from_jax_batch_stats``.  Torch runs
with TF32 off; JAX at ``highest`` matmul precision (tests/conftest.py).

The Tacotron prenet's dropout stays on at inference on both sides, but the
two frameworks draw different numbers: the single decode step takes JAX's
own draws (recorded from ``jax.random.bernoulli``) as keep masks; the whole
decode, whose JAX loop draws inside a compiled ``while_loop``, runs with
the prenet's dropout rate at 0 on both sides.  Tolerances: 1e-4 absolute
for mel, mel_before, stop probabilities and focus rate (f32; the observed
gaps are ~2e-6), lengths equal; the max-probability twin 1e-6 against a
dense softmax and 2e-4 against Pallas (interpret mode); HiFi-GAN 1e-4 on
the waveform, converted tensors within 1e-6 (both sides compute the same
float64 norms); Griffin-Lim 1e-5 (float64 on both sides).
"""

import io
import json
import threading
import urllib.error
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

import speecht5_tpu.config as JC
from speecht5_tpu.decode.tts import TTSDecoder as JTTSDecoder
from speecht5_tpu.models.hifigan import (HiFiGANConfig as JHiFiGANConfig,
                                         HiFiGANGenerator as JHiFiGAN)
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel
from speecht5_tpu.ops.mel import log_mel_numpy, mel_to_audio as jmel_to_audio
from speecht5_tpu.ops.pallas_kernels import flash_attention_bias as pallas_flash
from speecht5_tpu.utils.convert import (convert_hifigan_state_dict as
                                        jconvert_hifigan)

import torch

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.cli import serve
from speecht5_tpu_torch.decode.tts import TTSDecoder
from speecht5_tpu_torch.models.hifigan import (HiFiGANConfig, HiFiGANGenerator,
                                               init_hifigan)
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.ops.mel import mel_to_audio
from speecht5_tpu_torch.utils.checkpoint import save_model_only
from speecht5_tpu_torch.utils.convert import (convert_hifigan_state_dict,
                                              from_jax_batch_stats, from_jax_params)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TOL = 1e-4
NO_PRENET_DROPOUT = ["speech_prenet.dropout=0.0"]


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _init_both(m, wav, lens, prev, tokens, prev_mel, tgt_lengths, spk):
    m.forward_t2s(tokens, prev_mel, tgt_lengths, spk, deterministic=True)
    return m.forward_s2t(wav, lens, prev, mask=False, deterministic=True)


def setup_models(overrides=(), port_overrides=()):
    """JAX model and variables (every sub-net) and the port model with the
    same parameters and BatchNorm statistics, f32, tiny."""
    kw = {**chip_smoke.DICT_CFG, "dtype": "float32"}
    jcfg = JC.apply_overrides(JC.speecht5_tiny(**kw), list(overrides))
    jm = JModel(jcfg)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4000)),
        jnp.full((1,), 4000, jnp.int32), jnp.full((1, 4), 2, jnp.int32),
        jnp.full((1, 4), 2, jnp.int32), jnp.zeros((1, 2, jcfg.n_mels)),
        jnp.full((1,), 2, jnp.int32), jnp.ones((1, jcfg.spk_embed_dim)),
        method=_init_both))()
    rng = np.random.default_rng(5)
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.abs(rng.standard_normal(x.shape)) + 0.5, jnp.float32),
        variables["batch_stats"])}
    pcfg = PC.apply_overrides(PC.speecht5_tiny(**kw),
                              list(overrides) + list(port_overrides))
    model = init_model(pcfg, device="cpu")
    model.load_state_dict({**from_jax_params(_flat(variables["params"])),
                           **from_jax_batch_stats(_flat(variables["batch_stats"]))})
    return jcfg, jm, variables, pcfg, model


def _text(cfg, seed=0):
    """tokens [2, 9] (the second row 7 long, then padding), x-vectors."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, 30, (2, 9))
    tokens[0, -1] = cfg.eos_id
    tokens[1, 6], tokens[1, 7:] = cfg.eos_id, cfg.pad_id
    return tokens, rng.standard_normal((2, cfg.spk_embed_dim)).astype(np.float32)


# ---------------------------------------------------------------- decode


def test_speech_decode_step_matches_jax_with_jax_prenet_draws(monkeypatch):
    """Three cached steps: frames, stop probabilities and each layer's
    largest cross-attention probability, with the Tacotron prenet's dropout
    on (rate 0.5) and JAX's own keep masks handed to the port."""
    jcfg, jm, variables, pcfg, model = setup_models()
    tokens, spk = _text(jcfg)
    draws = []
    real = jax.random.bernoulli

    def record(key, p, shape):
        keep = real(key, p, shape)
        draws.append(np.asarray(keep))
        return keep

    monkeypatch.setattr(jax.random, "bernoulli", record)
    enc = jm.apply(variables, jnp.asarray(tokens), method="encode_text")
    jcache = jm.apply(variables, enc, 2, 9, spkembs=jnp.asarray(spk),
                      method="init_speech_cache")
    penc = model.encode_text(torch.from_numpy(tokens))
    pcache = model.init_speech_cache(penc, 2, 9, spkembs=torch.from_numpy(spk))
    prev = np.zeros((2, 1, jcfg.n_mels), np.float32)
    for step in range(3):
        n0 = len(draws)
        frames, probs, jcache, attn = jm.apply(
            variables, jnp.asarray(prev), jcache, spkembs=jnp.asarray(spk),
            enc_valid=enc["valid_mask"], need_attn=True, method="speech_decode_step",
            rngs={"prenet": jax.random.PRNGKey(step)})
        masks = [torch.from_numpy(d) for d in draws[n0:]]
        assert len(masks) == pcfg.speech_prenet.layers
        with torch.no_grad():
            pf, pp, pcache, pattn = model.speech_decode_step(
                torch.from_numpy(prev), pcache, spkembs=torch.from_numpy(spk),
                enc_valid=penc["valid_mask"], need_attn=True, keep_masks=masks)
        np.testing.assert_allclose(pf.numpy(), np.asarray(frames), atol=TOL)
        np.testing.assert_allclose(pp.numpy(), np.asarray(probs), atol=TOL)
        np.testing.assert_allclose(pattn.numpy(), np.asarray(attn).max(-1), atol=TOL)
        assert int(pcache["index"]) == step + 1
        prev = np.asarray(frames)[:, -1:]


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("threshold,min_ratio,max_ratio", [(0.9, 0.0, 6.0),
                                                           (0.5, 2.0, 10.0)])
def test_text_to_speech_matches_jax(kernels, threshold, min_ratio, max_ratio):
    """The whole decode against JAX's ``TTSDecoder`` (prenet dropout 0 on
    both sides), a padded row in the batch: lengths equal; mel, mel_before,
    stop probabilities and focus rate within 1e-4.  ``kernels``: the
    decoder's kernel route (on the CPU its twins: the decode-step
    attention with its max-probability output, read every 4 steps)."""
    port_ov = ["decoder.use_pallas_attn=True", "encoder.use_pallas_attn=True"] \
        if kernels else []
    jcfg, jm, variables, pcfg, model = setup_models(NO_PRENET_DROPOUT, port_ov)
    tokens, spk = _text(jcfg)
    kw = dict(max_frames=64, threshold=threshold, min_len_ratio=min_ratio,
              max_len_ratio=max_ratio)
    j = JTTSDecoder(jm, variables, **kw).text_to_speech(jnp.asarray(tokens),
                                                        jnp.asarray(spk))
    dec = TTSDecoder(model, device="cpu", **kw)
    K.reset_launch_counts()
    p = dec.text_to_speech(torch.from_numpy(tokens), torch.from_numpy(spk))
    assert not any(K.launch_counts().values())     # the CPU takes the twins
    np.testing.assert_array_equal(p.lengths.numpy(), np.asarray(j.lengths))
    for field in ("mel", "mel_before", "stop_probs", "focus_rate"):
        a, b = np.asarray(getattr(j, field)), getattr(p, field).numpy()
        assert a.shape == b.shape, field
        np.testing.assert_allclose(b, a, atol=TOL, err_msg=field)
    assert p.wav is None and j.wav is None
    assert 0 < dec.steps_run <= 32


def test_text_to_speech_draws_the_prenet_dropout_from_its_generator():
    """With the dropout on, the same seed gives the same mel, another seed
    another one; speech_to_speech (VC) draws from its generator alike."""
    _, _, _, pcfg, model = setup_models()
    tokens, spk = _text(pcfg)
    dec = TTSDecoder(model, max_frames=16, threshold=1.1, device="cpu")
    a, b = (dec.text_to_speech(torch.from_numpy(tokens), torch.from_numpy(spk)).mel
            for _ in range(2))
    assert torch.equal(a, b)
    c = dec.text_to_speech(torch.from_numpy(tokens), torch.from_numpy(spk),
                           generator=torch.Generator().manual_seed(9)).mel
    assert not torch.equal(a, c)
    wav = np.random.default_rng(2).standard_normal((1, 3200)).astype(np.float32) * 0.1
    a, b = (dec.speech_to_speech(wav, [3200], spk[:1]).mel for _ in range(2))
    c = dec.speech_to_speech(wav, [3200], spk[:1],
                             generator=torch.Generator().manual_seed(9)).mel
    assert torch.equal(a, b) and not torch.equal(a, c)


# ------------------------------------------------- the max-probability twin


@pytest.mark.parametrize("N,Tq,Tk,D,valid", [(4, 1, 16, 16, [16, 9, 1, 16]),
                                            (3, 5, 12, 16, [12, 7, 3])])
def test_max_prob_twin_matches_dense_softmax_and_pallas(N, Tq, Tk, D, valid):
    """The twin's largest probability equals a dense f32 softmax's (1e-6)
    and the Pallas kernel's probabilities (interpret mode), read off its
    output with V the identity, so that out[i, j] is p[i, j] (2e-4)."""
    rng = np.random.default_rng(N + Tk)
    q = rng.standard_normal((N, Tq, D)).astype(np.float32)
    k = rng.standard_normal((N, Tk, D)).astype(np.float32)
    v = np.eye(Tk, D, dtype=np.float32)[None].repeat(N, 0)
    mask = np.arange(Tk)[None, :] < np.asarray(valid)[:, None]
    out, maxp = K.flash_attention_bias_plain(torch.from_numpy(q), torch.from_numpy(k),
                                             torch.from_numpy(v), None,
                                             torch.from_numpy(mask), return_max_prob=True)
    s = np.einsum("nqd,nkd->nqk", q, k).astype(np.float64)
    s = np.where(mask[:, None, :], s, -1e9)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(maxp.numpy(), p.max(-1), atol=1e-6)
    pal = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.zeros((N, Tq, Tk)), jnp.asarray(mask),
                                  block_q=8, block_k=16))
    np.testing.assert_allclose(maxp.numpy(), pal[..., :Tk].max(-1), atol=2e-4)
    np.testing.assert_allclose(out.numpy(), pal, atol=2e-4)
    # the cached entry on [B, T, H, D] rows gives the same
    q4 = torch.from_numpy(q).view(1, N, Tq, D).transpose(1, 2)
    k4, v4 = (torch.from_numpy(t).view(1, N, Tk, D).transpose(1, 2) for t in (k, v))
    _, maxp4 = K.flash_attention_bias_cached(q4, k4, v4, torch.from_numpy(mask),
                                             return_max_prob=True)
    assert torch.equal(maxp4, maxp)


# -------------------------------------------------------------- HiFi-GAN

SMALL_VOC = dict(in_dim=8, upsample_initial_channel=16, upsample_rates=(2, 3),
                 upsample_kernel_sizes=(4, 7), resblock_kernel_sizes=(3, 5),
                 resblock_dilations=((1, 3), (1, 2)))


def _torch_hifigan_sd(naming, seed=0):
    """A seeded torch HiFi-GAN generator state dict at SMALL_VOC: "hf" (the
    smoke's: ``upsampler.<i>``, parametrized weight norm, mean / scale
    buffers) or "original" (the same weights as ``ups.<i>`` with legacy
    weight_g / weight_v pairs, conv_pre stored plain, no buffers)."""
    sd = chip_smoke.hifigan_hf_state_dict(HiFiGANConfig(**SMALL_VOC), seed)
    if naming == "hf":
        return sd
    out = {}
    for key, value in sd.items():
        if key in ("mean", "scale") or key.startswith("conv_pre.parametrizations"):
            continue
        key = key.replace("upsampler.", "ups.")
        key = key.replace("parametrizations.weight.original0", "weight_g")
        out[key.replace("parametrizations.weight.original1", "weight_v")] = value
    g0, v = (sd[f"conv_pre.parametrizations.weight.original{i}"] for i in (0, 1))
    out["conv_pre.weight"] = g0 * v / v.pow(2).sum((1, 2), keepdim=True).sqrt()
    return out


@pytest.mark.parametrize("naming", ["hf", "original"])
def test_hifigan_and_its_converter_match_jax(naming):
    """convert_hifigan_state_dict gives JAX's tensors (in torch layout,
    1e-6), and the port's generator the JAX generator's waveform (1e-4)."""
    sd = _torch_hifigan_sd(naming)
    port_sd = convert_hifigan_state_dict(sd)
    jparams = jconvert_hifigan({k: v.numpy() for k, v in sd.items()})
    jflat = _flat(jparams)
    for key, value in jflat.items():
        path = key.split("/")
        name = ".".join(path)
        if path[-1] == "weight_v":
            transposed = path[0].startswith("ups_")
            # flax [k, in, out] -> torch [out, in, k] / ConvTranspose [in, out, k]
            value = value.transpose(1, 2, 0) if transposed else value.transpose(2, 1, 0)
        np.testing.assert_allclose(port_sd[name].numpy(), value, atol=1e-6, err_msg=name)
    assert len(jflat) == len(port_sd)
    voc = HiFiGANGenerator(HiFiGANConfig(**SMALL_VOC,
                                         normalize_before=naming == "hf"))
    missing = voc.load_state_dict(port_sd, strict=False)
    assert not missing.unexpected_keys
    assert set(missing.missing_keys) <= {"mel_mean", "mel_scale"}
    jvoc = JHiFiGAN(JHiFiGANConfig(**SMALL_VOC, normalize_before=naming == "hf"))
    mel = np.random.default_rng(3).standard_normal((2, 11, 8)).astype(np.float32)
    want = np.asarray(jvoc.apply({"params": jparams}, jnp.asarray(mel)))
    with torch.no_grad():
        got = voc(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 11 * 6)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("seconds", [0.6, 0.02])
def test_mel_to_audio_matches_jax(seconds):
    """Griffin-Lim on torch.stft / torch.istft against JAX's numpy loop:
    the same iterations and initial phase (float64 both, 1e-5), also for a
    mel of two frames (a signal shorter than the reflect padding)."""
    wav = chip_smoke.synth_audio(seconds, seed=4)
    mel = log_mel_numpy(wav)
    want = jmel_to_audio(mel, n_iter=12, seed=3)
    got = mel_to_audio(torch.from_numpy(mel), n_iter=12, seed=3)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ------------------------------------------------------------------ /tts


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_tts_is_served_over_http(tmp_path):
    """``--task both`` on localhost: /tts returns a WAV through HiFi-GAN
    (a converted checkpoint) and, in another service, through Griffin-Lim;
    without either it answers with JAX's error; /healthz counts the
    calls."""
    _, _, _, pcfg, model = setup_models()
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    # the served vocoder: the released geometry at the model's mels, seeded
    voc_dir = str(tmp_path / "voc")
    save_model_only(voc_dir, init_hifigan(HiFiGANConfig(in_dim=pcfg.n_mels),
                                          device="cpu").state_dict())
    base = ["--ckpt", "random-init", "--dict", dict_path, "--arch", "speecht5_tiny",
            "--dtype", "float32", "--decoder", "ctc_greedy", "--asr-buckets", "1",
            "--max-frames", "32", "--tts-bucket-tokens", "24"]
    servers = []
    try:
        results = {}
        for name, extra in (("hifigan", ["--task", "both", "--vocoder-ckpt", voc_dir]),
                            ("griffin", ["--task", "t2s", "--griffin-lim"]),
                            ("none", ["--task", "t2s"])):
            args = serve.build_parser().parse_args(base + extra)
            svc = serve.Service(args, model=model, cfg=pcfg, device="cpu")
            server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
            servers.append(server)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            port = server.server_address[1]
            try:
                results[name] = _post(port, "/tts", json.dumps({"text": "hi there"}).encode())
            except urllib.error.HTTPError as e:
                results[name] = (e.code, None, e.read())
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
                results[name + "_health"] = json.loads(r.read())
        for name, hop in (("hifigan", 256), ("griffin", 256)):
            status, ctype, body = results[name]
            assert status == 200 and ctype == "audio/wav", (name, status, body[:200])
            with wave.open(io.BytesIO(body)) as w:
                assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (16000, 1, 2)
                n = w.getnframes()
            assert n > 0 and n % hop == 0, (name, n)
            health = results[name + "_health"]
            assert health["tts"] and health["tts_calls"] == health["tts_requests"] == 1
        assert results["hifigan_health"]["asr"] and not results["griffin_health"]["asr"]
        status, _, body = results["none"]
        assert status == 500 and b"--vocoder-ckpt" in body and b"--griffin-lim" in body
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def test_tts_batcher_coalesces_concurrent_requests(tmp_path):
    """--max-batch 2: two concurrent /tts requests inside the batch window
    become one decode of two rows (warmed at batch 1 and 2)."""
    _, _, _, pcfg, model = setup_models()
    with torch.no_grad():     # no early stop: each row runs to its length bound
        model.speech_decoder_postnet.prob_out.bias.fill_(chip_smoke.TTS_STOP_BIAS)
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    args = serve.build_parser().parse_args([
        "--task", "t2s", "--ckpt", "random-init", "--dict", dict_path, "--arch",
        "speecht5_tiny", "--dtype", "float32", "--griffin-lim", "--max-batch", "2",
        "--batch-window-ms", "2000", "--max-frames", "128", "--tts-bucket-tokens", "24"])
    svc = serve.Service(args, model=model, cfg=pcfg, device="cpu")
    out = {}
    threads = [threading.Thread(target=lambda t=t: out.__setitem__(t, svc.synthesize(t)))
               for t in ("a b", "hello")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert svc.tts_calls == 1 and svc.tts_requests == 2
    # lengths follow each row's own text: 4 and 6 tokens, 10 frames a token / r
    assert [len(out[t]) for t in ("a b", "hello")] == [40 * 256, 60 * 256]
