"""The port's CTC-greedy ASR slice held against the JAX package.

One set of JAX parameters (tiny preset with the 81-symbol letter
vocabulary) crosses into the port through ``utils/convert.from_jax_params``;
then the same numpy inputs go through each module of the slice in both
packages: the speech prenet (every conv ``impl``), the encoder with the
fused-attention flag on and off, the CTC head, the greedy decoder's frame
ids, and ``Service.transcribe`` (one request chunked).  One case runs the
Base width with one layer and 0.4 s of audio.

Torch runs with TF32 off; JAX at ``highest`` matmul precision
(tests/conftest.py).  Tolerance: f32 2e-4 absolute, as the JAX parity tests
use; decoded ids and texts must be equal.
"""

import dataclasses
import threading
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict
import torch

import speecht5_tpu.config as JC
from speecht5_tpu.cli import serve as jserve
from speecht5_tpu.data.dictionary import load_cli_dictionary as jload_dict
from speecht5_tpu.data.dictionary import letters_to_text as jletters_to_text
from speecht5_tpu.decode.asr import CTCDecoder as JCTCDecoder
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.decode.asr import CTCDecoder
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.utils.convert import from_jax_batch_stats, from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = 2e-4
KERNEL_FLAGS = ["encoder.use_pallas_attn=True", "conv_features.impl='pallas'"]


def _wav(B, T, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T)) * 0.1).astype(np.float32)


def _init_jax(cfg, T=4000):
    """Parameters (and BatchNorm statistics) of every sub-net the port has:
    the s2t and t2s forwards' and the HuBERT head's."""
    def both(m, wav, lens, prev, tokens, prev_mel, tgt_lengths, spk):
        m.forward_t2s(tokens, prev_mel, tgt_lengths, spk, deterministic=True)
        m.hubert_logits(m.encode_speech(wav, lens))
        return m.forward_s2t(wav, lens, prev, mask=False, deterministic=True)

    wav = jnp.zeros((1, T), jnp.float32)
    lens = jnp.full((1,), T, jnp.int32)
    prev = jnp.full((1, 4), cfg.eos_id, jnp.int32)
    # one jitted init: the values of an eager one, compiled once instead of
    # op by op
    return jax.jit(lambda key: JModel(cfg).init(
        {"params": key}, wav, lens, prev, prev,
        jnp.zeros((1, 2, cfg.n_mels)), jnp.full((1,), 2, jnp.int32),
        jnp.ones((1, cfg.spk_embed_dim)), method=both))(jax.random.PRNGKey(0))


def _flat(variables, collection="params"):
    return {k: np.asarray(v) for k, v in
            flatten_dict(variables[collection], sep="/").items()}


def _state_dict(variables):
    """The port state dict of JAX variables: parameters and BN statistics."""
    return {**from_jax_params(_flat(variables)),
            **from_jax_batch_stats(_flat(variables, "batch_stats"))}


def _port(overrides=(), base=None, **kw):
    cfg = PC.apply_overrides(base or PC.speecht5_tiny(**kw), list(overrides))
    return cfg, init_model(cfg, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    """JAX tiny model + variables at the letter vocabulary, and the same
    parameters flattened for the port."""
    cfg = JC.speecht5_tiny(**chip_smoke.DICT_CFG)
    variables = _init_jax(cfg)
    return cfg, variables, _state_dict(variables)


@pytest.mark.parametrize("preset", ["speecht5_base", "speecht5_base_asr",
                                    "speecht5_tiny", "speecht5_large"])
def test_config_presets_match_jax(preset):
    a = dataclasses.asdict(getattr(PC, preset)())
    b = dataclasses.asdict(getattr(JC, preset)())
    assert a == b
    ov = KERNEL_FLAGS + ["encoder.num_layers=3"]
    assert (dataclasses.asdict(PC.apply_overrides(getattr(PC, preset)(), ov))
            == dataclasses.asdict(JC.apply_overrides(getattr(JC, preset)(), ov)))


def test_from_jax_params_fills_the_port_state_dict(tiny):
    _, _, sd = tiny
    _, model = _port(**chip_smoke.DICT_CFG)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("impl", ["xla", "polyphase", "pallas"])
def test_speech_prenet_matches_jax(tiny, impl):
    cfg, variables, sd = tiny
    ov = [f"conv_features.impl={impl!r}"]
    _, model = _port(ov, **chip_smoke.DICT_CFG)
    model.load_state_dict(sd)
    wav, lens = _wav(2, 4000), np.array([4000, 2500], np.int32)
    jx, jvalid, _, _ = JModel(JC.apply_overrides(cfg, ov)).apply(
        variables, jnp.asarray(wav), jnp.asarray(lens),
        method=lambda m, w, l: m.speech_encoder_prenet(w, l))
    with torch.no_grad():
        x, valid, *_ = model.speech_encoder_prenet(torch.from_numpy(wav),
                                                   torch.from_numpy(lens))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=ATOL)


@pytest.mark.parametrize("flags", [[], KERNEL_FLAGS],
                         ids=["plain", "kernels"])
def test_encoder_and_ctc_logits_match_jax(tiny, flags):
    cfg, variables, sd = tiny
    _, model = _port(flags, **chip_smoke.DICT_CFG)
    model.load_state_dict(sd)
    wav, lens = _wav(2, 4000, seed=1), np.array([4000, 1700], np.int32)
    jm = JModel(JC.apply_overrides(cfg, flags))
    jenc = jm.apply(variables, jnp.asarray(wav), jnp.asarray(lens),
                    method="encode_speech")
    jlogits = jm.apply(variables, jenc, method="ctc_logits")
    with torch.no_grad():
        enc = model.encode_speech(torch.from_numpy(wav), torch.from_numpy(lens))
        logits = model.ctc_logits(enc)
    np.testing.assert_allclose(enc["encoder_out"].numpy(),
                               np.asarray(jenc["encoder_out"]), atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)


def test_ctc_decoder_ids_match_jax(tiny):
    cfg, variables, sd = tiny
    _, model = _port(KERNEL_FLAGS, **chip_smoke.DICT_CFG)
    model.load_state_dict(sd)
    wav, lens = _wav(3, 8000, seed=2), np.array([8000, 5000, 900], np.int32)
    jdec = JCTCDecoder(JModel(cfg), variables, blank_id=cfg.blank_id)
    dec = CTCDecoder(model, blank_id=cfg.blank_id, device="cpu")
    jids, jlens = jdec._enc_argmax(variables, (jnp.asarray(wav), jnp.asarray(lens)))
    ids, frame_lens = dec.frame_ids(wav, lens)
    np.testing.assert_array_equal(frame_lens, np.asarray(jlens))
    for b in range(3):
        n = int(frame_lens[b])
        np.testing.assert_array_equal(ids[b, :n], np.asarray(jids)[b, :n])
    assert dec(wav, lens) == jdec(jnp.asarray(wav), jnp.asarray(lens))


def _jax_service(cfg, variables, dict_path, args):
    """The JAX Service's ASR path around an in-memory model (its constructor
    needs a checkpoint): the same request methods, decoder and detokenizer."""
    svc = object.__new__(jserve.Service)
    svc._jnp = jnp
    svc._letters_to_text = jletters_to_text
    svc.lock = threading.Lock()
    svc.args = args
    svc.dictionary, _ = jload_dict(dict_path, None)
    svc.max_batch = 1
    svc.asr_calls = svc.asr_requests = 0
    svc.asr = jserve._CTCAdapter(JCTCDecoder(JModel(cfg), variables,
                                             blank_id=cfg.blank_id))
    return svc


def test_service_transcribe_matches_jax(tiny, tmp_path):
    cfg, variables, sd = tiny
    pcfg, model = _port(KERNEL_FLAGS, **chip_smoke.DICT_CFG)
    model.load_state_dict(sd)
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    svc = chip_smoke.make_service(pcfg, model, dict_path, "cpu", "1,2")
    jsvc = _jax_service(cfg, variables, dict_path, svc.args)
    for i, secs in enumerate((0.4, 1.3, 2.5)):
        wav = chip_smoke.synth_audio(secs, seed=10 + i)
        assert len(svc._chunk(wav)) == len(jsvc._chunk(wav))
        assert svc.transcribe(wav) == jsvc.transcribe(wav)
    assert svc.asr_requests == jsvc.asr_requests == 4   # 2.5 s -> 2 chunks


def test_base_width_one_layer_matches_jax():
    """speecht5_base_asr at full width (d 768, 12 heads, 512-channel conv
    stack, max distance 160), one encoder layer, 0.4 s of audio, both
    kernel flags on."""
    kw = dict(chip_smoke.DICT_CFG)
    jcfg = JC.apply_overrides(JC.speecht5_base_asr(**kw),
                              KERNEL_FLAGS + ["encoder.num_layers=1"])
    variables = _init_jax(jcfg, T=6400)
    pcfg = PC.apply_overrides(PC.speecht5_base_asr(**kw),
                              KERNEL_FLAGS + ["encoder.num_layers=1"])
    model = init_model(pcfg, device="cpu")
    model.load_state_dict(_state_dict(variables))
    wav, lens = _wav(1, 6400, seed=3), np.array([6400], np.int32)
    jm = JModel(jcfg)
    jout, jlogits = jax.jit(lambda v, w, n: jm.apply(
        v, w, n, method=lambda m, w, n: (lambda e: (e["encoder_out"], m.ctc_logits(e)))(
            m.encode_speech(w, n))))(variables, jnp.asarray(wav), jnp.asarray(lens))
    with torch.no_grad():
        enc = model.encode_speech(torch.from_numpy(wav), torch.from_numpy(lens))
        logits = model.ctc_logits(enc)
    np.testing.assert_allclose(enc["encoder_out"].numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)


def test_service_micro_batches_chunks_of_one_request(tiny, tmp_path):
    """--max-batch 2: the collector thread decodes both same-bucket windows
    of a chunked request as one batch, with the texts of --max-batch 1."""
    cfg, _, sd = tiny
    pcfg, model = _port(KERNEL_FLAGS, **chip_smoke.DICT_CFG)
    model.load_state_dict(sd)
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    args = chip_smoke.make_service(pcfg, model, dict_path, "cpu", "1,2").args
    one = chip_smoke.make_service(pcfg, model, dict_path, "cpu", "1,2")
    from speecht5_tpu_torch.cli.serve import Service

    args.max_batch, args.batch_window_ms = 2, 200.0
    two = Service(args, model=model, cfg=pcfg, device="cpu")
    wav = chip_smoke.synth_audio(3.5, seed=20)   # windows [0, 2] and [1.5, 3.5] s
    assert two.transcribe(wav) == one.transcribe(wav)
    assert (two.asr_calls, two.asr_requests) == (1, 2)
