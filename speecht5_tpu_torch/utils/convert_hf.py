"""HuggingFace ``transformers`` SpeechT5 checkpoints -> the port's state dict
(port of ``speecht5_tpu/utils/convert_hf.py``: ``map_hf_key`` :50,
``convert_hf_state_dict`` :283, ``hf_config_to_ours`` :317,
``load_hf_checkpoint`` :403).

The released SpeechT5 weights (``microsoft/speecht5_asr``, ``_tts``,
``_vc``) ship in the HF namespace.  Both sides are torch, so each key maps
to the port's own name with its layout unchanged; the scales HF keeps 0-d
(``alpha``) become the port's [1].  The positional conv's weight norm comes
as ``weight_g`` / ``weight_v`` or, from transformers 4.30 on, as
``parametrizations.weight.original0/1``.  Nothing here imports
``transformers``: ``hf_config_to_ours`` takes the parsed ``config.json``,
and ``load_hf_checkpoint`` takes a directory with ``config.json`` and
``pytorch_model.bin``, or a model object the caller made.
"""

from __future__ import annotations

import json
import os
import re

import torch

_ENC_PRE = "speecht5.encoder.prenet."
_ENC = "speecht5.encoder.wrapped_encoder."
_DEC_PRE = "speecht5.decoder.prenet."
_DEC = "speecht5.decoder.wrapped_decoder."
_FFN = {"intermediate_dense": "fc1", "output_dense": "fc2"}


def map_hf_key(key: str, feat_norm: str = "group"):
    """One HF key -> the port's key; "" for a buffer to skip (sinusoid
    tables, position ids, BatchNorm counters); None for a key the port does
    not take.  ``feat_norm``: "group" (Base: a GroupNorm after conv 0) or
    "layer" (Large: a LayerNorm after every conv)."""
    if key.endswith((".weights", "num_batches_tracked", ".position_ids")):
        return ""
    if key.startswith(_ENC_PRE):
        sub = key[len(_ENC_PRE):]
        if sub == "masked_spec_embed":
            return "speech_encoder_prenet.mask_emb"
        m = re.match(r"feature_encoder\.conv_layers\.(\d+)\.conv\.weight$", sub)
        if m:
            return f"speech_encoder_prenet.feature_extractor.conv_{m.group(1)}.weight"
        m = re.match(r"feature_encoder\.conv_layers\.(\d+)\.layer_norm\.(weight|bias)$", sub)
        if m:
            norm = "group_norm" if feat_norm == "group" else f"ln_{m.group(1)}"
            return f"speech_encoder_prenet.feature_extractor.{norm}.{m.group(2)}"
        m = re.match(r"feature_projection\.(layer_norm|projection)\.(weight|bias)$", sub)
        if m:
            mod = "layer_norm" if m.group(1) == "layer_norm" else "post_extract_proj"
            return f"speech_encoder_prenet.{mod}.{m.group(2)}"
        m = re.match(r"pos_conv_embed\.conv\.(?:parametrizations\.weight\.original([01])"
                     r"|(weight_g|weight_v|bias))$", sub)
        if m:
            leaf = m.group(2) or ("weight_g" if m.group(1) == "0" else "weight_v")
            return f"speech_encoder_prenet.pos_conv.{leaf}"
        if sub == "embed_tokens.weight":
            return "text_encoder_prenet.embed_tokens.weight"
        if sub == "encode_positions.alpha":
            return "text_encoder_prenet.alpha"
        return None
    if key.startswith(_ENC):
        sub = key[len(_ENC):]
        m = re.match(r"layer_norm\.(weight|bias)$", sub)
        if m:
            return f"encoder.layer_norm.{m.group(1)}"
        if sub == "embed_positions.pe_k.weight":
            return "encoder.pos_emb.pe_k.weight"
        m = re.match(r"layers\.(\d+)\.attention\.([qkv]_proj|out_proj)\.(weight|bias)$", sub)
        if m:
            return f"encoder.layers.{m.group(1)}.self_attn.{m.group(2)}.{m.group(3)}"
        m = re.match(r"layers\.(\d+)\.(layer_norm|final_layer_norm)\.(weight|bias)$", sub)
        if m:
            ln = "self_attn_layer_norm" if m.group(2) == "layer_norm" else m.group(2)
            return f"encoder.layers.{m.group(1)}.{ln}.{m.group(3)}"
        m = re.match(r"layers\.(\d+)\.feed_forward\.(intermediate_dense|output_dense)"
                     r"\.(weight|bias)$", sub)
        if m:
            return f"encoder.layers.{m.group(1)}.ffn.{_FFN[m.group(2)]}.{m.group(3)}"
        return None
    if key.startswith(_DEC_PRE):
        sub = key[len(_DEC_PRE):]
        if sub == "embed_tokens.weight":
            return "text_decoder_prenet.embed_tokens.weight"
        m = re.match(r"layers\.(\d+)\.(weight|bias)$", sub)
        if m:
            return f"speech_decoder_prenet.prenet.layer_{m.group(1)}.{m.group(2)}"
        m = re.match(r"(final_layer|speaker_embeds_layer)\.(weight|bias)$", sub)
        if m:
            mod = "proj" if m.group(1) == "final_layer" else "spkembs_layer"
            return f"speech_decoder_prenet.{mod}.{m.group(2)}"
        if sub == "encode_positions.alpha":
            return "speech_decoder_prenet.alpha"
        return None
    if key.startswith(_DEC):
        sub = key[len(_DEC):]
        m = re.match(r"layers\.(\d+)\.(self_attn|encoder_attn)\.([qkv]_proj|out_proj)"
                     r"\.(weight|bias)$", sub)
        if m:
            return "decoder.layers.{}.{}.{}.{}".format(*m.groups())
        m = re.match(r"layers\.(\d+)\.(self_attn_layer_norm|encoder_attn_layer_norm"
                     r"|final_layer_norm)\.(weight|bias)$", sub)
        if m:
            return "decoder.layers.{}.{}.{}".format(*m.groups())
        m = re.match(r"layers\.(\d+)\.feed_forward\.(intermediate_dense|output_dense)"
                     r"\.(weight|bias)$", sub)
        if m:
            return f"decoder.layers.{m.group(1)}.ffn.{_FFN[m.group(2)]}.{m.group(3)}"
        return None
    if key == "text_decoder_postnet.lm_head.weight":
        return "text_decoder_postnet.output_projection.weight"
    m = re.match(r"speech_decoder_postnet\.(feat_out|prob_out)\.(weight|bias)$", key)
    if m:
        return f"speech_decoder_postnet.{m.group(1)}.{m.group(2)}"
    m = re.match(r"speech_decoder_postnet\.layers\.(\d+)\.conv\.weight$", key)
    if m:
        return f"speech_decoder_postnet.postnet.conv_{m.group(1)}.weight"
    m = re.match(r"speech_decoder_postnet\.layers\.(\d+)\.batch_norm\.(weight|bias"
                 r"|running_mean|running_var)$", key)
    if m:
        return f"speech_decoder_postnet.postnet.bn_{m.group(1)}.{m.group(2)}"
    return None


def convert_hf_state_dict(state_dict):
    """HF state dict (tensors or arrays) -> (the port's state dict of f32
    tensors, unknown keys).  The conv feature norm is read off the keys: a
    ``layer_norm`` on conv layer >= 1 means Large's "layer" mode."""
    feat_norm = "group"
    if any(re.search(r"feature_encoder\.conv_layers\.[1-9]\d*\.layer_norm\.", k)
           for k in state_dict):
        feat_norm = "layer"
    out, unknown = {}, []
    for key, val in state_dict.items():
        port_key = map_hf_key(key, feat_norm)
        if port_key == "":
            continue
        if port_key is None:
            unknown.append(key)
            continue
        t = torch.as_tensor(val).detach().to(torch.float32)
        out[port_key] = t.reshape(1).clone() if port_key.endswith(".alpha") else t.clone()
    return out, unknown


def hf_config_to_ours(hf_cfg: dict, dtype: str = "float32"):
    """A parsed HF ``config.json`` (a dict; a ``transformers`` config
    object's ``to_dict()`` gives the same) -> the port's SpeechT5Config of
    the same geometry: the released Base arch, post-LN stacks, the encoder's
    relative-position bias, no decoder table."""
    from ..config import (ConvFeatureConfig, MaskingConfig, RelPosConfig,
                          SpeechDecoderPostnetConfig, SpeechDecoderPrenetConfig,
                          SpeechT5Config, TransformerConfig)

    c = dict(hf_cfg)

    def stack(prefix, rel_pos):
        return TransformerConfig(
            d_model=c["hidden_size"], ffn_dim=c[f"{prefix}_ffn_dim"],
            num_layers=c[f"{prefix}_layers"],
            num_heads=c[f"{prefix}_attention_heads"], dropout=c["hidden_dropout"],
            attention_dropout=c["attention_dropout"],
            activation_dropout=c["activation_dropout"], activation=c["hidden_act"],
            layer_norm_first=False, layer_norm_eps=c["layer_norm_eps"],
            layerdrop=c[f"{prefix}_layerdrop"], rel_pos=rel_pos,
            **({} if prefix == "encoder" else {"use_rel_pos_bias": False}))

    return SpeechT5Config(
        vocab_size=c["vocab_size"], pad_id=c["pad_token_id"], bos_id=c["bos_token_id"],
        eos_id=c["eos_token_id"],
        encoder=stack("encoder", RelPosConfig(
            enabled=True, max_distance=c["encoder_max_relative_position"])),
        decoder=stack("decoder", RelPosConfig(enabled=False)),
        conv_features=ConvFeatureConfig(
            layers=tuple(zip(c["conv_dim"], c["conv_kernel"], c["conv_stride"])),
            mode="default" if c["feat_extract_norm"] == "group" else "layer_norm",
            bias=c["conv_bias"]),
        masking=MaskingConfig(
            mask_prob=c["mask_time_prob"], mask_length=c["mask_time_length"],
            mask_channel_prob=c["mask_feature_prob"],
            mask_channel_length=c["mask_feature_length"]),
        max_speech_positions=c["max_speech_positions"],
        max_text_positions=c["max_text_positions"],
        conv_pos=c["num_conv_pos_embeddings"],
        conv_pos_groups=c["num_conv_pos_embedding_groups"],
        n_mels=c["num_mel_bins"], reduction_factor=c["reduction_factor"],
        speech_prenet=SpeechDecoderPrenetConfig(
            layers=c["speech_decoder_prenet_layers"],
            units=c["speech_decoder_prenet_units"],
            dropout=c["speech_decoder_prenet_dropout"]),
        speech_postnet=SpeechDecoderPostnetConfig(
            postnet_layers=c["speech_decoder_postnet_layers"],
            postnet_chans=c["speech_decoder_postnet_units"],
            postnet_filts=c["speech_decoder_postnet_kernel"],
            postnet_dropout=c["speech_decoder_postnet_dropout"]),
        spk_embed_dim=c["speaker_embedding_dim"], dtype=dtype)


def read_hf_dir(d: str) -> tuple:
    """An HF directory -> (its parsed ``config.json``, the state dict of its
    ``pytorch_model.bin``).  A ``model.safetensors`` directory is refused:
    reading it needs the ``safetensors`` package."""
    with open(os.path.join(d, "config.json"), encoding="utf-8") as f:
        hf_cfg = json.load(f)
    bin_path = os.path.join(d, "pytorch_model.bin")
    if not os.path.exists(bin_path):
        if os.path.exists(os.path.join(d, "model.safetensors")):
            raise ValueError(
                f"{d} holds model.safetensors, which needs the safetensors "
                "package; save the model with safe_serialization=False "
                "(pytorch_model.bin) to convert it here")
        raise FileNotFoundError(f"no pytorch_model.bin in {d}")
    return hf_cfg, torch.load(bin_path, map_location="cpu", weights_only=True)


def load_hf_checkpoint(model_or_dir, dtype: str = "float32"):
    """An HF SpeechT5 checkpoint -> (the port's SpeechT5Config, its state
    dict, unknown keys).  ``model_or_dir``: a directory holding
    ``config.json`` and ``pytorch_model.bin``, or a ``transformers`` model
    object (its ``config`` and ``state_dict()``).  A ``model.safetensors``
    directory is refused: reading it needs the ``safetensors`` package."""
    if isinstance(model_or_dir, (str, os.PathLike)):
        hf_cfg, sd = read_hf_dir(os.fspath(model_or_dir))
    else:
        hf_cfg = model_or_dir.config.to_dict()
        with torch.no_grad():
            sd = {k: v.detach().cpu() for k, v in model_or_dir.state_dict().items()}
    state, unknown = convert_hf_state_dict(sd)
    return hf_config_to_ours(hf_cfg, dtype=dtype), state, unknown
