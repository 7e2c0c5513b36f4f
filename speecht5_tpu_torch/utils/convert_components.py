"""HF ``transformers`` state dicts of WavLLM's pretrained components -> the
port's modules (port of ``speecht5_tpu/utils/convert_components.py``).

WavLLM builds on three released models (reference WavLLM/wavllm/models/
speechllm_model.py:183-278):

  WavLMModel         -> models/wavlm.WavLMEncoderModel  (``convert_wavlm_state_dict``)
  WhisperModel (enc) -> models/wavllm.WhisperStyleEncoder (``convert_whisper_encoder_state_dict``)
  LlamaModel         -> models/wavllm.WavLLMModel's LLaMA (``convert_llama_state_dict``)

Both sides are torch, so most keys map to the port's own name with their
layout unchanged (Linear [out, in], Conv1d [C_out, C_in, k], the weight
norm's ``weight_g`` [1, 1, k] / ``weight_v`` in the legacy or the
parametrized naming).  Two changes of value: Whisper's ``k_proj`` has no
bias and the port's has one (zero-filled), and HF LLaMA stores q / k
permuted for rotate-half RoPE where the port rotates interleaved pairs
(``_unpermute_rope``).  Each converter takes tensors or numpy arrays and
returns (the port's state dict of f32 tensors, the keys it does not take).
Nothing here imports ``transformers``: ``wavlm_config_from_hf`` takes the
parsed ``config.json``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(v, np.float32))


# ------------------------------------------------------------------- WavLM


def convert_wavlm_state_dict(sd: Dict) -> tuple:
    """HF WavLMModel state dict -> (state dict of ``WavLMEncoderModel``,
    unknown keys).  The feature norm ("group": one GroupNorm after conv 0;
    "layer": a LayerNorm after every conv) is read off the keys."""
    feat_norm = "group"
    if any(re.search(r"feature_extractor\.conv_layers\.[1-9]\d*\.layer_norm\.", k) for k in sd):
        feat_norm = "layer"
    out, unknown = {}, []
    for key, val in sd.items():
        if key.endswith(("num_batches_tracked", ".position_ids")) or key == "masked_spec_embed":
            continue        # buffers, and the pretraining mask vector
        m = re.match(r"feature_extractor\.conv_layers\.(\d+)\.conv\.(weight|bias)$", key)
        if m:
            out[f"feature_extractor.conv_{m.group(1)}.{m.group(2)}"] = _f32(val)
            continue
        m = re.match(r"feature_extractor\.conv_layers\.(\d+)\.layer_norm\.(weight|bias)$", key)
        if m:
            norm = "group_norm" if feat_norm == "group" else f"ln_{m.group(1)}"
            out[f"feature_extractor.{norm}.{m.group(2)}"] = _f32(val)
            continue
        m = re.match(r"feature_projection\.(layer_norm|projection)\.(weight|bias)$", key)
        if m:
            mod = "fp_layer_norm" if m.group(1) == "layer_norm" else "fp_projection"
            out[f"{mod}.{m.group(2)}"] = _f32(val)
            continue
        m = re.match(r"encoder\.pos_conv_embed\.conv\.(?:parametrizations\.weight\.original([01])"
                     r"|(weight_g|weight_v|bias))$", key)
        if m:
            leaf = m.group(2) or ("weight_g" if m.group(1) == "0" else "weight_v")
            out[f"pos_conv.{leaf}"] = _f32(val)
            continue
        m = re.match(r"encoder\.layer_norm\.(weight|bias)$", key)
        if m:
            out[f"encoder_layer_norm.{m.group(1)}"] = _f32(val)
            continue
        m = re.match(r"encoder\.layers\.(\d+)\.attention\."
                     r"([qkv]_proj|out_proj|gru_rel_pos_linear)\.(weight|bias)$", key)
        if m:
            out["layers.{}.attention.{}.{}".format(*m.groups())] = _f32(val)
            continue
        m = (re.match(r"encoder\.layers\.(\d+)\.attention\.(gru_rel_pos_const)$", key)
             or re.match(r"encoder\.layers\.(\d+)\.attention\.(rel_attn_embed)\.weight$", key))
        if m:
            out["layers.{}.attention.{}".format(*m.groups())] = _f32(val)
            continue
        m = re.match(r"encoder\.layers\.(\d+)\.(layer_norm|final_layer_norm|feed_forward\."
                     r"intermediate_dense|feed_forward\.output_dense)\.(weight|bias)$", key)
        if m:
            out["layers.{}.{}.{}".format(*m.groups())] = _f32(val)
            continue
        unknown.append(key)
    return out, unknown


def wavlm_config_from_hf(hf_cfg: dict, dtype: str = "float32"):
    """A parsed HF WavLM ``config.json`` -> the port's ``WavLMConfig``."""
    from ..config import ConvFeatureConfig
    from ..models.wavlm import WavLMConfig

    c = hf_cfg
    return WavLMConfig(
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        ffn_dim=c["intermediate_size"],
        conv=ConvFeatureConfig(
            layers=tuple(zip(c["conv_dim"], c["conv_kernel"], c["conv_stride"])),
            mode="default" if c["feat_extract_norm"] == "group" else "layer_norm",
            bias=c["conv_bias"]),
        num_buckets=c["num_buckets"],
        max_bucket_distance=c["max_bucket_distance"],
        stable_layer_norm=c["do_stable_layer_norm"],
        conv_pos=c["num_conv_pos_embeddings"],
        conv_pos_groups=c["num_conv_pos_embedding_groups"],
        layer_norm_eps=c["layer_norm_eps"],
        dropout=c["hidden_dropout"],
        attention_dropout=c["attention_dropout"],
        activation_dropout=c["activation_dropout"],
        dtype=dtype,
    )


# ----------------------------------------------------------------- Whisper


def convert_whisper_encoder_state_dict(sd: Dict) -> tuple:
    """HF WhisperModel (or WhisperEncoder) state dict -> (state dict of
    ``WhisperStyleEncoder``, unknown keys).  Keys come with or without the
    ``model.encoder.`` / ``encoder.`` / ``model.`` prefixes; the decoder's
    are skipped (WavLLM uses the encoder only, speechllm_model.py:188)."""
    out, unknown = {}, []
    for key, val in sd.items():
        k = key
        for pre in ("model.encoder.", "encoder.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        if k.startswith("decoder."):
            continue
        m = re.match(r"(conv1|conv2|layer_norm)\.(weight|bias)$", k)
        if m:
            out[k] = _f32(val)
            continue
        if k == "embed_positions.weight":
            out["embed_positions"] = _f32(val)
            continue
        m = re.match(r"layers\.(\d+)\.(self_attn\.(?:[qkv]_proj|out_proj)|self_attn_layer_norm"
                     r"|final_layer_norm)\.(weight|bias)$", k)
        if m:
            out[k] = _f32(val)
            continue
        m = re.match(r"layers\.(\d+)\.(fc1|fc2)\.(weight|bias)$", k)
        if m:
            out["layers.{}.ffn.{}.{}".format(*m.groups())] = _f32(val)
            continue
        unknown.append(key)
    # Whisper's k_proj has no bias and the port's has one: zero for parity
    for k in [k for k in out if k.endswith("self_attn.k_proj.weight")]:
        out.setdefault(k[: -len("weight")] + "bias", torch.zeros(out[k].shape[0]))
    return out, unknown


# ------------------------------------------------------------------- LLaMA


def _unpermute_rope(w: torch.Tensor, num_heads: int) -> torch.Tensor:
    """HF LLaMA's q / k weight [out, in] is permuted for rotate-half RoPE;
    the port rotates interleaved pairs.  Reorder the output rows of each
    head: ours[h, 2i] = hf[h, i], ours[h, 2i + 1] = hf[h, Dh / 2 + i]."""
    d_out, d_in = w.shape
    dh = d_out // num_heads
    w = w.reshape(num_heads, dh, d_in)
    out = torch.empty_like(w)
    out[:, 0::2] = w[:, : dh // 2]
    out[:, 1::2] = w[:, dh // 2 :]
    return out.reshape(d_out, d_in)


_LLAMA_PROJ = {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
               "gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}
_LLAMA_NORM = {"input_layernorm": "attention_norm", "post_attention_layernorm": "ffn_norm"}


def convert_llama_state_dict(sd: Dict, num_heads: int) -> tuple:
    """HF LlamaModel / LlamaForCausalLM state dict -> (the LLaMA part of a
    ``WavLLMModel`` state dict: the LoRALinear base weights of wq / wk / wv
    / wo, the SwiGLU w1 / w3 / w2, the RMSNorms, ``tok_embeddings``,
    ``norm`` and the ``output`` head; unknown keys)."""
    out, unknown = {}, []
    for key, val in sd.items():
        k = key[len("model."):] if key.startswith("model.") else key
        if k.endswith(("rotary_emb.inv_freq", ".position_ids")):
            continue
        if k == "embed_tokens.weight":
            out["tok_embeddings.weight"] = _f32(val)
            continue
        if k == "norm.weight":
            out["norm.weight"] = _f32(val)
            continue
        if k == "lm_head.weight":
            out["output.weight"] = _f32(val)
            continue
        m = (re.match(r"layers\.(\d+)\.self_attn\.([qkvo]_proj)\.weight$", k)
             or re.match(r"layers\.(\d+)\.mlp\.(gate_proj|up_proj|down_proj)\.weight$", k))
        if m:
            w = _f32(val)
            if m.group(2) in ("q_proj", "k_proj"):
                w = _unpermute_rope(w, num_heads)
            out[f"llama_layers.{m.group(1)}.{_LLAMA_PROJ[m.group(2)]}.weight"] = w
            continue
        m = re.match(r"layers\.(\d+)\.(input_layernorm|post_attention_layernorm)\.weight$", k)
        if m:
            out[f"llama_layers.{m.group(1)}.{_LLAMA_NORM[m.group(2)]}.weight"] = _f32(val)
            continue
        unknown.append(key)
    return out, unknown
