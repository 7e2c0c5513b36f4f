"""WavLLM's component converters in the port, held against the JAX
package's and against ``transformers``.

- On HF-layout state dicts written on the spot (WavLM Base and Large, in
  both weight-norm namings; Whisper with and without the ``model.encoder.``
  prefix, its decoder keys and its bias-free ``k_proj``; LLaMA with its
  rotary buffer and an unknown key): the port's
  ``utils/convert_components`` output equals what
  ``utils/convert.wavllm_from_jax_params`` makes of JAX's converters'
  output, the RoPE un-permutation included, the unknown keys are JAX's,
  and each result loads strictly into the port's module.
- Where ``transformers`` imports: the random-init HF ``WavLMModel`` (Base
  and Large), Whisper encoder and ``LlamaForCausalLM`` against the port's
  modules on the converted weights, at the tolerances
  tests/test_wavllm_hf.py holds JAX's to.
- ``cli/convert.py --component``: an HF directory (``config.json`` +
  ``pytorch_model.bin``) and a bare state-dict file; a bare LLaMA file
  without ``--llama-heads`` and a ``model.safetensors`` directory refused.
"""

import json

import numpy as np
import pytest

from flax.traverse_util import flatten_dict

from speecht5_tpu.utils import convert_components as JCC

import torch

import torch_cpu  # noqa: F401  (one torch thread a process)
import speecht5_tpu_torch.models.wavllm as PW
import speecht5_tpu_torch.models.wavlm as PWL
from speecht5_tpu_torch.cli import convert as cli_convert
from speecht5_tpu_torch.utils import convert_components as PCC
from speecht5_tpu_torch.utils.checkpoint import partial_load, restore_model
from speecht5_tpu_torch.utils.convert import wavllm_from_jax_params

# the tiny geometry of the presets: WavLM d 32 / 4 heads / FFN 48 / conv 16,
# Whisper d 32 / 4 heads / FFN 64 / 80 mels / 64 positions, LLaMA d 32 / 4
# heads / FFN 64 / vocab 48, two layers each
WAVLM_HF = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=48, conv_dim=(16, 16, 16), conv_kernel=(10, 3, 2),
                conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4, num_buckets=16, max_bucket_distance=40,
                do_stable_layer_norm=False, feat_extract_norm="group", conv_bias=False,
                layer_norm_eps=1e-5, hidden_dropout=0.0, attention_dropout=0.0,
                activation_dropout=0.0)
LARGE = dict(do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True)


def wavlm_state(cfg: dict, parametrized=False, seed=0) -> dict:
    """An HF WavLMModel state dict of ``cfg``'s shapes, random values, plus
    the buffers and pretraining keys a released file holds."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    D, H, F = cfg["hidden_size"], cfg["num_attention_heads"], cfg["intermediate_size"]
    sd, c_in = {}, 1
    layer_ln = cfg["feat_extract_norm"] == "layer"
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[f"{pre}.conv.weight"] = r(c, c_in, k)
        if cfg["conv_bias"]:
            sd[f"{pre}.conv.bias"] = r(c)
        if layer_ln or i == 0:
            sd[f"{pre}.layer_norm.weight"], sd[f"{pre}.layer_norm.bias"] = 1 + r(c), r(c)
        c_in = c
    sd["feature_projection.layer_norm.weight"], sd["feature_projection.layer_norm.bias"] = (
        1 + r(c_in), r(c_in))
    sd["feature_projection.projection.weight"], sd["feature_projection.projection.bias"] = (
        r(D, c_in), r(D))
    kpos, g = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    wn = (("parametrizations.weight.original0", "parametrizations.weight.original1")
          if parametrized else ("weight_g", "weight_v"))
    sd[f"encoder.pos_conv_embed.conv.{wn[0]}"] = 1 + r(1, 1, kpos)
    sd[f"encoder.pos_conv_embed.conv.{wn[1]}"] = r(D, D // g, kpos)
    sd["encoder.pos_conv_embed.conv.bias"] = r(D)
    sd["encoder.layer_norm.weight"], sd["encoder.layer_norm.bias"] = 1 + r(D), r(D)
    for l in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{l}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}.attention.{proj}.weight"], sd[f"{pre}.attention.{proj}.bias"] = (
                r(D, D), r(D))
        sd[f"{pre}.attention.gru_rel_pos_linear.weight"] = r(8, D // H)
        sd[f"{pre}.attention.gru_rel_pos_linear.bias"] = r(8)
        sd[f"{pre}.attention.gru_rel_pos_const"] = 1 + r(1, H, 1, 1)
        if l == 0:
            sd[f"{pre}.attention.rel_attn_embed.weight"] = r(cfg["num_buckets"], H)
        for ln in ("layer_norm", "final_layer_norm"):
            sd[f"{pre}.{ln}.weight"], sd[f"{pre}.{ln}.bias"] = 1 + r(D), r(D)
        sd[f"{pre}.feed_forward.intermediate_dense.weight"] = r(F, D)
        sd[f"{pre}.feed_forward.intermediate_dense.bias"] = r(F)
        sd[f"{pre}.feed_forward.output_dense.weight"] = r(D, F)
        sd[f"{pre}.feed_forward.output_dense.bias"] = r(D)
    sd["masked_spec_embed"] = r(D)
    sd["encoder.layers.0.attention.extra_buffer.num_batches_tracked"] = np.zeros((), np.int64)
    sd["encoder.unexpected.weight"] = r(3)
    return sd


def whisper_state(prefix="", seed=1, D=32, F=64, mels=80, pos=64, layers=2) -> dict:
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    sd = {"conv1.weight": r(D, mels, 3), "conv1.bias": r(D), "conv2.weight": r(D, D, 3),
          "conv2.bias": r(D), "embed_positions.weight": r(pos, D),
          "layer_norm.weight": 1 + r(D), "layer_norm.bias": r(D)}
    for l in range(layers):
        pre = f"layers.{l}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}.self_attn.{proj}.weight"] = r(D, D)
            if proj != "k_proj":                       # Whisper's k_proj has no bias
                sd[f"{pre}.self_attn.{proj}.bias"] = r(D)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{pre}.{ln}.weight"], sd[f"{pre}.{ln}.bias"] = 1 + r(D), r(D)
        sd[f"{pre}.fc1.weight"], sd[f"{pre}.fc1.bias"] = r(F, D), r(F)
        sd[f"{pre}.fc2.weight"], sd[f"{pre}.fc2.bias"] = r(D, F), r(D)
    sd = {prefix + k: v for k, v in sd.items()}
    if prefix:
        sd["model.decoder.layers.0.fc1.weight"] = r(4, 4)
        sd["model.encoder.unexpected"] = r(2)
    return sd


def llama_state(seed=2, D=32, F=64, V=48, layers=2) -> dict:
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    sd = {"model.embed_tokens.weight": r(V, D), "model.norm.weight": 1 + r(D),
          "lm_head.weight": r(V, D)}
    for l in range(layers):
        pre = f"model.layers.{l}"
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[f"{pre}.self_attn.{proj}.weight"] = r(D, D)
        sd[f"{pre}.mlp.gate_proj.weight"], sd[f"{pre}.mlp.up_proj.weight"] = r(F, D), r(F, D)
        sd[f"{pre}.mlp.down_proj.weight"] = r(D, F)
        sd[f"{pre}.input_layernorm.weight"] = 1 + r(D)
        sd[f"{pre}.post_attention_layernorm.weight"] = 1 + r(D)
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = r(4)
    sd["model.unexpected.weight"] = r(2)
    return sd


def equal_to_jax(port: dict, jax_tree: dict):
    want = wavllm_from_jax_params({k: np.asarray(v) for k, v in
                                   flatten_dict(jax_tree, sep="/").items()})
    assert set(port) == set(want)
    for k, v in want.items():
        assert port[k].dtype == torch.float32, k
        np.testing.assert_array_equal(port[k].numpy(), v.numpy(), err_msg=k)


def hf_obj(cfg: dict):
    """The attribute view JAX's ``wavlm_config_from_hf`` reads."""
    return type("HFConfig", (), dict(cfg))()


# --------------------------------------------------------- against JAX's


@pytest.mark.parametrize("variant", ["base", "large", "base_parametrized"])
def test_wavlm_converter_equals_jax(variant):
    cfg = {**WAVLM_HF, **(LARGE if variant == "large" else {})}
    sd = wavlm_state(cfg, parametrized=variant.endswith("parametrized"))
    port, unknown = PCC.convert_wavlm_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jtree, junknown = JCC.convert_wavlm_state_dict(sd)
    equal_to_jax(port, jtree)
    assert unknown == junknown == ["encoder.unexpected.weight"]
    pcfg = PCC.wavlm_config_from_hf(cfg)
    jcfg = JCC.wavlm_config_from_hf(hf_obj(cfg))
    for f in ("hidden_size", "num_layers", "num_heads", "ffn_dim", "num_buckets",
              "max_bucket_distance", "stable_layer_norm", "conv_pos", "conv_pos_groups",
              "layer_norm_eps", "dropout", "attention_dropout", "activation_dropout"):
        assert getattr(pcfg, f) == getattr(jcfg, f), f
    assert (pcfg.conv.layers, pcfg.conv.mode, pcfg.conv.bias) == (
        jcfg.conv.layers, jcfg.conv.mode, jcfg.conv.bias)
    PWL.WavLMEncoderModel(pcfg).load_state_dict(port, strict=True)


@pytest.mark.parametrize("prefix", ["", "model.encoder."])
def test_whisper_converter_equals_jax(prefix):
    sd = whisper_state(prefix)
    port, unknown = PCC.convert_whisper_encoder_state_dict(sd)
    jtree, junknown = JCC.convert_whisper_encoder_state_dict(sd)
    equal_to_jax(port, jtree)
    assert unknown == junknown == (["model.encoder.unexpected"] if prefix else [])
    assert float(port["layers.0.self_attn.k_proj.bias"].abs().max()) == 0.0
    PW.WhisperStyleEncoder(PW.wavllm_tiny(n_mels=80)).load_state_dict(port, strict=True)


def test_llama_converter_equals_jax_with_the_rope_unpermutation():
    sd = llama_state()
    port, unknown = PCC.convert_llama_state_dict(sd, num_heads=4)
    jtree, junknown = JCC.convert_llama_state_dict(sd, num_heads=4)
    equal_to_jax(port, jtree)
    assert unknown == junknown == ["model.unexpected.weight"]
    # rows of each head interleaved: ours[h, 2i] = hf[h, i], ours[h, 2i+1] = hf[h, 4 + i]
    w, hf = port["llama_layers.1.wk.weight"].numpy(), sd["model.layers.1.self_attn.k_proj.weight"]
    np.testing.assert_array_equal(w.reshape(4, 8, 32)[:, 0::2], hf.reshape(4, 8, 32)[:, :4])
    np.testing.assert_array_equal(w.reshape(4, 8, 32)[:, 1::2], hf.reshape(4, 8, 32)[:, 4:])
    np.testing.assert_array_equal(port["llama_layers.0.wv.weight"].numpy(),
                                  sd["model.layers.0.self_attn.v_proj.weight"])
    model = PW.WavLLMModel(PW.wavllm_tiny())
    missing, extra = model.load_state_dict(port, strict=False)
    assert extra == [] and not any(k.startswith(("llama_layers", "tok_", "norm", "output"))
                                   and not k.endswith(("lora_A", "lora_B")) for k in missing)


# ---------------------------------------------------- against transformers


def test_hf_modules_equal_the_port_on_converted_weights(monkeypatch):
    """The random-init HF WavLM (Base and Large), Whisper encoder and LLaMA
    against the port's modules on their converted weights (the tolerances of
    tests/test_wavllm_hf.py: 2e-4; 6e-4 for the pre-LN Large, whose
    per-conv LayerNorm takes flax's epsilon 1e-6 where HF's has 1e-5)."""
    monkeypatch.setenv("USE_TF", "0")     # the torch modules only: no TensorFlow import
    transformers = pytest.importorskip("transformers")
    sd = lambda m: {k: v.detach().clone() for k, v in m.state_dict().items()}
    rng = np.random.default_rng(0)
    wav = torch.from_numpy((rng.standard_normal((2, 1000)) * 0.1).astype(np.float32))
    lengths = torch.tensor([1000, 640])
    for extra, atol in (({}, 2e-4), (LARGE, 6e-4)):
        torch.manual_seed(0)
        cfg = {**WAVLM_HF, **extra, "feat_proj_dropout": 0.0, "layerdrop": 0.0,
               "apply_spec_augment": False}
        hf = transformers.WavLMModel(transformers.WavLMConfig(**cfg)).eval()
        state, unknown = PCC.convert_wavlm_state_dict(sd(hf))
        assert unknown == []
        ours = PWL.WavLMEncoderModel(PCC.wavlm_config_from_hf(hf.config.to_dict()))
        ours.load_state_dict(state, strict=True)
        mask = (torch.arange(1000)[None] < lengths[:, None]).long()
        with torch.no_grad():
            theirs = hf(wav, attention_mask=mask).last_hidden_state
            got, valid = ours.eval()(wav, lengths)
        np.testing.assert_allclose(got[valid].numpy(), theirs[valid].numpy(), atol=atol)

    torch.manual_seed(0)
    wcfg = transformers.WhisperConfig(
        d_model=32, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_layers=1, decoder_attention_heads=4, decoder_ffn_dim=64, num_mel_bins=80,
        max_source_positions=64, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    hf = transformers.WhisperModel(wcfg).get_encoder().eval()
    state, unknown = PCC.convert_whisper_encoder_state_dict(sd(hf))
    assert unknown == []
    enc = PW.WhisperStyleEncoder(PW.wavllm_tiny(n_mels=80, whisper_ffn=64))
    enc.load_state_dict(state, strict=True)
    mel = torch.from_numpy(rng.standard_normal((2, 128, 80)).astype(np.float32))
    with torch.no_grad():
        theirs = hf(mel.transpose(1, 2)).last_hidden_state
        got, out_lengths = enc.eval()(mel, torch.tensor([128, 128]))
    assert int(out_lengths[0]) == theirs.shape[1]
    np.testing.assert_allclose(got.numpy(), theirs.numpy(), atol=2e-4)

    torch.manual_seed(0)
    lcfg = transformers.LlamaConfig(
        vocab_size=48, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=4, intermediate_size=64, max_position_embeddings=128,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=False, attention_bias=False)
    hf = transformers.LlamaForCausalLM(lcfg).eval()
    state, unknown = PCC.convert_llama_state_dict(sd(hf), num_heads=4)
    assert unknown == []
    model = PW.init_wavllm(PW.wavllm_tiny(), device="cpu")     # LoRA B = 0: the base LLaMA
    model.load_state_dict(partial_load(model.state_dict(), state))
    tokens = torch.tensor([[1, 5, 9, 13, 2], [1, 7, 11, 3, 2]])
    with torch.no_grad():
        theirs = hf(tokens).logits
        x = model.tok_embeddings(tokens)
        pos = torch.arange(5)[None].expand(2, 5)
        got = model.logits(model._llama(x, pos, model._causal(torch.ones(2, 5, dtype=bool))))
    np.testing.assert_allclose(got.numpy(), theirs.numpy(), atol=2e-4)


# --------------------------------------------------------------------- CLI


def write_hf_dir(d, sd: dict, cfg: dict, safetensors=False):
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg), encoding="utf-8")
    if safetensors:
        (d / "model.safetensors").write_bytes(b"")
    else:
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                   d / "pytorch_model.bin")


def test_cli_converts_each_component_from_a_directory_or_a_bare_file(tmp_path):
    wl = {k: v for k, v in wavlm_state(WAVLM_HF).items()
          if k not in ("encoder.unexpected.weight",)}
    write_hf_dir(tmp_path / "wavlm", wl, {**WAVLM_HF, "architectures": ["WavLMModel"]})
    rep = cli_convert.main(["--format", "hf", "--component", "wavlm", "--pt",
                            str(tmp_path / "wavlm"), "--out", str(tmp_path / "o_wavlm"),
                            "--strict"])
    assert rep["unknown_keys"] == [] and rep["component"] == "wavlm"
    state, step = restore_model(tmp_path / "o_wavlm")
    want, _ = PCC.convert_wavlm_state_dict(wl)
    assert step == 0 and set(state) == {f"wavlm.{k}" for k in want}

    llama = llama_state()
    torch.save({k: torch.from_numpy(v) for k, v in llama.items()}, tmp_path / "llama.bin")
    with pytest.raises(SystemExit, match="--llama-heads"):
        cli_convert.main(["--format", "hf", "--component", "llama", "--pt",
                          str(tmp_path / "llama.bin"), "--out", str(tmp_path / "o_llama")])
    rep = cli_convert.main(["--format", "hf", "--component", "llama", "--llama-heads", "4",
                            "--pt", str(tmp_path / "llama.bin"), "--out",
                            str(tmp_path / "o_llama")])
    assert rep["unknown_keys"] == ["model.unexpected.weight"]
    state, _ = restore_model(tmp_path / "o_llama")
    want, _ = PCC.convert_llama_state_dict(llama, num_heads=4)
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    # a directory's config.json gives the head count
    write_hf_dir(tmp_path / "llama_dir", llama, {"num_attention_heads": 4})
    rep = cli_convert.main(["--format", "hf", "--component", "llama", "--pt",
                            str(tmp_path / "llama_dir"), "--out", str(tmp_path / "o_llama2")])
    assert torch.equal(restore_model(tmp_path / "o_llama2")[0]["llama_layers.0.wq.weight"],
                       want["llama_layers.0.wq.weight"])

    wh = whisper_state("model.encoder.")
    torch.save({k: torch.from_numpy(v) for k, v in wh.items()}, tmp_path / "whisper.bin")
    with pytest.raises(SystemExit, match="unknown_keys"):
        cli_convert.main(["--format", "hf", "--component", "whisper", "--pt",
                          str(tmp_path / "whisper.bin"), "--out", str(tmp_path / "o_w"),
                          "--strict"])
    cli_convert.main(["--format", "hf", "--component", "whisper", "--pt",
                      str(tmp_path / "whisper.bin"), "--out", str(tmp_path / "o_w")])
    state, _ = restore_model(tmp_path / "o_w")
    model = PW.WavLLMModel(PW.wavllm_tiny(n_mels=80))
    merged = partial_load(model.state_dict(), state, strict_shapes=True)
    assert all(torch.equal(merged[k], v) for k, v in state.items())
    assert all(k.startswith("whisper.") for k in state)

    write_hf_dir(tmp_path / "st", {}, WAVLM_HF, safetensors=True)
    with pytest.raises(ValueError, match="safetensors"):
        cli_convert.main(["--format", "hf", "--component", "wavlm", "--pt",
                          str(tmp_path / "st"), "--out", str(tmp_path / "o_st")])
