"""HF ``transformers`` SpeechT5 checkpoints into the port, held against the
JAX package's converter and against the HF models themselves.

Random-init ``SpeechT5ForSpeechToText`` / ``SpeechT5ForTextToSpeech`` /
``SpeechT5HifiGan`` at a tiny geometry (the installed transformers; the
card machine has none, so this file skips there):
- the port's ``convert_hf_state_dict`` equals JAX ``convert_hf_state_dict``
  -> ``from_jax_params`` / ``from_jax_batch_stats``, tensor for tensor
  (exact), with the same unknown keys, for both weight-norm namings of the
  positional conv;
- ``hf_config_to_ours`` on the ``config.json`` dict equals JAX's on the
  config object, field for field;
- the converted port model's logits / mels (TTS and VC) equal HF's within
  1e-4 (absolute, f32, TF32 off), and so does the HiFi-GAN waveform;
- ``load_hf_checkpoint`` reads a ``config.json`` + ``pytorch_model.bin``
  directory and refuses a ``model.safetensors`` one.
"""

import dataclasses
import json

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")

from flax.traverse_util import flatten_dict

from speecht5_tpu.utils import convert_hf as JH

import torch

from speecht5_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.utils.checkpoint import partial_load
from speecht5_tpu_torch.utils.convert import (convert_hifigan_state_dict,
                                              from_jax_batch_stats, from_jax_params)
from speecht5_tpu_torch.utils.convert_hf import (convert_hf_state_dict, hf_config_to_ours,
                                                 load_hf_checkpoint)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ATOL = 1e-4


def tiny_hf_config(**kw):
    base = dict(vocab_size=41, hidden_size=32, encoder_layers=2, encoder_attention_heads=2,
                encoder_ffn_dim=48, decoder_layers=2, decoder_attention_heads=2,
                decoder_ffn_dim=48, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=16, encoder_max_relative_position=8,
                speech_decoder_prenet_layers=2, speech_decoder_prenet_units=16,
                speech_decoder_postnet_layers=2, speech_decoder_postnet_units=12,
                speech_decoder_postnet_kernel=5, speaker_embedding_dim=8,
                max_speech_positions=512, max_text_positions=64, positional_dropout=0.0,
                hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, speech_decoder_prenet_dropout=0.0,
                speech_decoder_postnet_dropout=0.0, apply_spec_augment=False)
    base.update(kw)
    return transformers.SpeechT5Config(**base)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _hf(cls, seed):
    torch.manual_seed(seed)
    return getattr(transformers, cls)(tiny_hf_config()).eval()


def _port_model(hf):
    cfg, state, unknown = load_hf_checkpoint(hf)
    assert unknown == []
    model = init_model(cfg, device="cpu")
    model.load_state_dict(partial_load(model.state_dict(), state))
    return cfg, state, model


@pytest.mark.parametrize("cls", ["SpeechT5ForSpeechToText", "SpeechT5ForTextToSpeech",
                                 "SpeechT5ForSpeechToSpeech"])
@pytest.mark.parametrize("legacy_weight_norm", [False, True])
def test_conversion_equals_jax_tensor_for_tensor(cls, legacy_weight_norm):
    hf = _hf(cls, 0)
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    if legacy_weight_norm:      # the pre-4.30 naming of the positional conv
        renamed = [k for k in sd if ".parametrizations.weight.original" in k]
        for key in renamed:
            new = key.replace("parametrizations.weight.original0", "weight_g")
            sd[new.replace("parametrizations.weight.original1", "weight_v")] = sd.pop(key)
        assert len(renamed) == (0 if cls == "SpeechT5ForTextToSpeech" else 2)
    got, unknown = convert_hf_state_dict(sd)
    params, stats, junknown = JH.convert_hf_state_dict({k: v.numpy() for k, v in sd.items()})
    want = {**from_jax_params(_flat(params)), **from_jax_batch_stats(_flat(stats))}
    assert unknown == junknown == []
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    # every converted key is one of the port model's, at its shape
    target = init_model(hf_config_to_ours(hf.config.to_dict()), device="cpu").state_dict()
    assert all(tuple(target[k].shape) == tuple(v.shape) for k, v in got.items())


def test_config_equals_jax():
    hf_cfg = tiny_hf_config()
    ours = hf_config_to_ours(json.loads(hf_cfg.to_json_string()))
    theirs = JH.hf_config_to_ours(hf_cfg)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_asr_logits_equal_hf():
    hf = _hf("SpeechT5ForSpeechToText", 0)
    cfg, _, model = _port_model(hf)
    rng = np.random.default_rng(1)
    B, T = 2, 3200
    lengths = np.array([T, 2100])
    wav = rng.standard_normal((B, T)).astype(np.float32) * 0.1
    wav[1, lengths[1]:] = 0.0
    attn = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int64)
    prev = rng.integers(4, cfg.vocab_size, size=(B, 7))
    prev[:, 0] = cfg.eos_id
    with torch.no_grad():
        ref = hf(input_values=torch.from_numpy(wav), attention_mask=torch.from_numpy(attn),
                 decoder_input_ids=torch.from_numpy(prev)).logits
        enc = model.encode_speech(torch.from_numpy(wav), torch.from_numpy(lengths))
        got = model.decode_text(enc, torch.from_numpy(prev))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


def test_tts_mels_equal_hf(monkeypatch):
    """HF's always-on prenet dropout patched to identity (rate 0 here too)."""
    from transformers.models.speecht5 import modeling_speecht5 as hf_mod

    monkeypatch.setattr(hf_mod.SpeechT5SpeechDecoderPrenet, "_consistent_dropout",
                        lambda self, x, p: x)
    hf = _hf("SpeechT5ForTextToSpeech", 1)
    cfg, _, model = _port_model(hf)
    rng = np.random.default_rng(2)
    tokens = rng.integers(4, cfg.vocab_size, size=(2, 9))
    mel = rng.standard_normal((2, 12, cfg.n_mels)).astype(np.float32)
    spk = rng.standard_normal((2, cfg.spk_embed_dim)).astype(np.float32)
    thinned = mel[:, cfg.reduction_factor - 1::cfg.reduction_factor]
    prev = np.zeros_like(thinned)
    prev[:, 1:] = thinned[:, :-1]
    with torch.no_grad():
        h = hf.speecht5(input_values=torch.from_numpy(tokens),
                        decoder_input_values=torch.from_numpy(prev),
                        speaker_embeddings=torch.from_numpy(spk)).last_hidden_state
        ref = hf.speech_decoder_postnet(h)
        enc = model.encode_text(torch.from_numpy(tokens))
        got = model.decode_speech(enc, torch.from_numpy(prev), None, torch.from_numpy(spk))
    for g, r in zip(got[:3], ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=ATOL)


def test_vc_mels_equal_hf(monkeypatch):
    """The random-init SpeechT5ForSpeechToSpeech through load_hf_checkpoint:
    the port's forward_s2s (speech encoder, x-vector, speech decoder,
    postnet) against HF's own on padded source audio; HF's always-on prenet
    dropout patched to identity (rate 0 here too)."""
    from transformers.models.speecht5 import modeling_speecht5 as hf_mod

    monkeypatch.setattr(hf_mod.SpeechT5SpeechDecoderPrenet, "_consistent_dropout",
                        lambda self, x, p: x)
    hf = _hf("SpeechT5ForSpeechToSpeech", 2)
    cfg, _, model = _port_model(hf)
    rng = np.random.default_rng(4)
    B, T = 2, 3200
    lengths = np.array([T, 2300])
    wav = rng.standard_normal((B, T)).astype(np.float32) * 0.1
    wav[1, lengths[1]:] = 0.0
    attn = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int64)
    mel = rng.standard_normal((B, 12, cfg.n_mels)).astype(np.float32)
    spk = rng.standard_normal((B, cfg.spk_embed_dim)).astype(np.float32)
    thinned = mel[:, cfg.reduction_factor - 1::cfg.reduction_factor]
    prev = np.zeros_like(thinned)
    prev[:, 1:] = thinned[:, :-1]
    with torch.no_grad():
        h = hf.speecht5(input_values=torch.from_numpy(wav),
                        attention_mask=torch.from_numpy(attn),
                        decoder_input_values=torch.from_numpy(prev),
                        speaker_embeddings=torch.from_numpy(spk)).last_hidden_state
        ref = hf.speech_decoder_postnet(h)
        got = model.forward_s2s(torch.from_numpy(wav), torch.from_numpy(lengths),
                                torch.from_numpy(prev), None, torch.from_numpy(spk))
    for g, r in zip(got[:3], ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=ATOL)


def test_hifigan_waveform_equals_hf():
    kw = dict(upsample_initial_channel=16, upsample_rates=(4, 4),
              upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
              resblock_dilations=((1, 3), (1, 3)))
    torch.manual_seed(3)
    hf = transformers.SpeechT5HifiGan(transformers.SpeechT5HifiGanConfig(
        model_in_dim=8, upsample_initial_channel=16, upsample_rates=[4, 4],
        upsample_kernel_sizes=[8, 8], resblock_kernel_sizes=[3, 5],
        resblock_dilation_sizes=[[1, 3], [1, 3]], normalize_before=True)).eval()
    with torch.no_grad():     # statistics off their init, as a trained vocoder has
        hf.mean.normal_()
        hf.scale.uniform_(0.5, 1.5)
    voc = HiFiGANGenerator(HiFiGANConfig(in_dim=8, **kw))
    voc.load_state_dict(convert_hifigan_state_dict(hf.state_dict()))
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 20, 8)).astype(np.float32))
    with torch.no_grad():
        ref, got = hf(mel), voc(mel)
    assert got.shape == ref.shape == (2, 20 * 16)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


def test_load_hf_checkpoint_from_a_directory(tmp_path):
    hf = _hf("SpeechT5ForSpeechToText", 0)
    hf.save_pretrained(tmp_path, safe_serialization=False)
    cfg, state, unknown = load_hf_checkpoint(tmp_path)
    cfg2, state2, _ = load_hf_checkpoint(hf)
    assert unknown == [] and cfg == cfg2 and set(state) == set(state2)
    assert all(torch.equal(state[k], state2[k]) for k in state)
    (tmp_path / "pytorch_model.bin").unlink()
    (tmp_path / "model.safetensors").write_bytes(b"")
    with pytest.raises(ValueError, match="safetensors"):
        load_hf_checkpoint(tmp_path)
