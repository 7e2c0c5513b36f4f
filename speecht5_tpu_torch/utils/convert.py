"""Carry the JAX package's parameters into the port.

``from_jax_params`` takes the JAX model's ``params`` tree flattened by the
caller to ``{"a/b/c": numpy array}`` (the port may not import flax) and
returns a ``state_dict`` for the port's ``SpeechT5Model``.  Layouts:

- Dense ``kernel`` [in, out]            -> Linear ``weight`` [out, in]
- Conv ``kernel`` [k, C_in, C_out]      -> ``weight`` [C_out, C_in, k]
  (2-D / 3-D convs, [kh, kw(, kt first), C_in, C_out], alike:
  [C_out, C_in, k...])
- weight-norm ``weight_v`` [k, C_in/g, C_out] -> [C_out, C_in/g, k]
- weight-norm ``weight_g`` [k, 1, 1]    -> [1, 1, k]
- GroupNorm / LayerNorm ``scale``       -> ``weight``; ``bias`` -> ``bias``
- Embed ``embedding`` (``pe_k``)        -> ``weight``
- ``alpha`` (positional scales) [1]     -> ``alpha``
- ``layers_<i>``                        -> ``layers.<i>``
- the speaker head's ``projection_weight`` [C, E] -> ``output_projection.weight``
- the HuBERT head's ``label_embs_concat`` and the quantizer's ``vars`` as
  they are

``lm_from_jax_params`` carries the fusion LM (JAX ``models/lm.py``) the
same way, and ``speechlm_from_jax_params``, ``fastspeech2_from_jax_params``,
``speechut_from_jax_params``, ``speech2c_from_jax_params``,
``yitrans_from_jax_params``, ``vatlm_from_jax_params`` and
``wavllm_from_jax_params`` the sibling families (their trees whole: the
port names their sub-nets as JAX does; the ``label_embs*`` as they are;
VATLM's video BatchNorm statistics from its ``batch_stats``; WavLLM's
``llama_layers_<i>`` -> ``llama_layers.<i>``, its LoRA ``lora_A`` /
``lora_B``, WavLM's ``rel_attn_embed`` / ``gru_rel_pos_const``, Whisper's
``embed_positions`` and the RMSNorm ``weight`` as they are).

Only the subtrees the port has (``PORTED_SUBTREES``) are carried; the
others are left out of the result.  ``from_jax_batch_stats`` carries the
JAX ``batch_stats`` collection (the BatchNorm ``mean`` / ``var`` of the
speech and speaker postnets) into the ``running_mean`` / ``running_var``
buffers.

``load_fairseq_checkpoint`` reads a released fairseq ``.pt`` (no fairseq
or omegaconf needed) and maps its keys onto the port's (``map_fairseq_key``,
the rules of JAX ``map_speecht5_key``); ``convert_hifigan_state_dict``
carries a torch HiFi-GAN generator (HF or original naming) into
``models/hifigan.HiFiGANGenerator``.  The HF SpeechT5 naming is
``utils/convert_hf.py``'s.
"""

from __future__ import annotations

import re

import numpy as np
import torch

PORTED_SUBTREES = ("speech_encoder_prenet", "text_encoder_prenet", "encoder",
                   "decoder", "text_decoder_prenet", "text_decoder_postnet",
                   "speech_decoder_prenet", "speech_decoder_postnet",
                   "spkembs_projection", "speaker_decoder_postnet",
                   "speech_encoder_postnet", "quantizer")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if 3 <= value.ndim <= 5:
            return "weight", value.transpose(value.ndim - 1, value.ndim - 2,
                                             *range(value.ndim - 2))
        raise ValueError(f"kernel of rank {value.ndim}")
    if name == "weight_v":
        return name, value.transpose(2, 1, 0)
    if name == "weight_g":
        return name, value.reshape(1, 1, -1)
    if name in ("scale", "embedding"):
        return "weight", value
    if name in ("bias", "mask_emb", "alpha", "label_embs_concat", "vars") or \
            name.startswith("label_embs"):
        return name, value
    if name == "projection_weight":
        return "output_projection.weight", value
    raise KeyError(f"unknown parameter leaf {name!r}")


def _convert(flat: dict, collection: str, leaf_fn, subtrees=PORTED_SUBTREES) -> dict:
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == collection:
            parts = parts[1:]
        if subtrees is not None and parts[0] not in subtrees:
            continue
        path = [re.sub(r"^((?:llama_)?layers)_(\d+)$", r"\1.\2", p) for p in parts[:-1]]
        leaf, arr = leaf_fn(parts[-1], np.asarray(value, np.float32))
        out[".".join(path + [leaf])] = torch.tensor(arr)
    return out


def from_jax_params(flat: dict) -> dict:
    """``{"encoder/layers_0/self_attn/q_proj/kernel": ndarray, ...}`` ->
    port ``state_dict`` of float32 tensors."""
    return _convert(flat, "params", _leaf)


def lm_from_jax_params(flat: dict) -> dict:
    """The JAX ``TransformerLM``'s ``params`` flattened to ``{"a/b/c":
    ndarray}`` -> a state dict of the port's ``models/lm.TransformerLM``
    (``embed_tokens``, the pre-LN ``decoder`` with its final
    ``layer_norm``, an untied ``output_projection``)."""
    return _convert(flat, "params", _leaf,
                    ("embed_tokens", "decoder", "output_projection"))


def speechlm_from_jax_params(flat: dict) -> dict:
    """The JAX ``SpeechLMModel``'s (or ``SpeechLMCtc``'s, under
    ``speechlm/``, or ``SpeechLMS2T``'s) flattened ``params`` -> the state
    dict of the port's ``models/speechlm`` module of the same name."""
    return _convert(flat, "params", _leaf, None)


def fastspeech2_from_jax_params(flat: dict) -> dict:
    """The JAX ``FastText2Unit``'s flattened ``params`` (flax ``nn.Conv``
    kernels [k, C_in, C_out]) -> the port's ``models/fastspeech2.
    FastText2Unit`` state dict."""
    return _convert(flat, "params", _leaf, None)


def speechut_from_jax_params(flat: dict) -> dict:
    """The JAX ``SpeechUTModel``'s flattened ``params`` -> the port's
    ``models/speechut.SpeechUTModel`` state dict."""
    return _convert(flat, "params", _leaf, None)


SPEECH2C_SUBTREES = ("speech_encoder_prenet", "encoder", "decoder", "text_decoder_prenet",
                     "text_decoder_postnet", "speech_encoder_postnet")


def speech2c_from_jax_params(flat: dict) -> dict:
    """The JAX ``Speech2CModel``'s flattened ``params`` (SpeechT5's names,
    a subset of its sub-nets) -> the port's ``models/speech2c.
    Speech2CModel`` state dict."""
    return _convert(flat, "params", _leaf, SPEECH2C_SUBTREES)


def yitrans_from_jax_params(flat: dict) -> dict:
    """The JAX ``YiTransModel``'s flattened ``params`` -> the port's
    ``models/yitrans.YiTransModel`` state dict."""
    return _convert(flat, "params", _leaf, None)


def vatlm_from_jax_params(flat: dict, batch_stats: dict) -> dict:
    """The JAX ``VATLMModel``'s flattened ``params`` (the video ResNet's
    2-D and 3-D conv kernels among them) and ``batch_stats`` (its
    BatchNorms' mean / var) -> the port's ``models/vatlm.VATLMModel`` state
    dict, parameters and statistics."""
    return {**_convert(flat, "params", _leaf, None),
            **from_jax_batch_stats(batch_stats, subtrees=None)}


#: WavLLM's leaves that keep their name and layout (LoRA A / B in the JAX
#: layout [in, r] / [r, out], with a leading expert axis under LoRA-MoE)
_WAVLLM_LEAVES = ("lora_A", "lora_B", "rel_attn_embed", "gru_rel_pos_const",
                  "embed_positions", "weight")


def _wavllm_leaf(name: str, value: np.ndarray):
    if name in _WAVLLM_LEAVES:
        return name, value
    return _leaf(name, value)


def wavllm_from_jax_params(flat: dict) -> dict:
    """The JAX ``WavLLMModel``'s flattened ``params`` (or a subtree of it:
    a ``WavLMEncoderModel``'s, a ``WhisperStyleEncoder``'s; flax ``nn.Conv``
    kernels [k, C_in, C_out], the LoRA and LoRA-MoE pairs, ``moe_gate``)
    -> the state dict of the port's module of the same name
    (``models/wavllm.py``, ``models/wavlm.py``)."""
    return _convert(flat, "params", _wavllm_leaf, None)


def _stat_leaf(name: str, value: np.ndarray):
    if name not in _STATS:
        raise KeyError(f"unknown batch_stats leaf {name!r}")
    return _STATS[name], value


def from_jax_batch_stats(flat: dict, subtrees=PORTED_SUBTREES) -> dict:
    """``{"speech_decoder_postnet/postnet/bn_0/mean": ndarray, ...}`` (the
    flattened ``batch_stats`` collection) -> the port's BatchNorm
    ``running_mean`` / ``running_var`` buffers (of ``subtrees``, None:
    all)."""
    return _convert(flat, "batch_stats", _stat_leaf, subtrees)


# ------------------------------------------------------ fairseq checkpoints

# fairseq key -> the port's key (JAX utils/convert.py:33-210 is the spec of
# which keys are taken; both sides are torch, so layouts stay); ``alpha``
# rules reshape fairseq's 0-d scale to the port's [1]
_FAIRSEQ_RULES = [(re.compile(a), b) for a, b in (
    (r"speech_encoder_prenet\.feature_extractor\.conv_layers\.0\.2\.(weight|bias)$",
     r"speech_encoder_prenet.feature_extractor.group_norm.\1"),
    (r"speech_encoder_prenet\.feature_extractor\.conv_layers\.(\d+)\.0\.(weight|bias)$",
     r"speech_encoder_prenet.feature_extractor.conv_\1.\2"),
    (r"speech_encoder_prenet\.feature_extractor\.conv_layers\.(\d+)\.2\.1\.(weight|bias)$",
     r"speech_encoder_prenet.feature_extractor.ln_\1.\2"),
    (r"speech_encoder_prenet\.(layer_norm|post_extract_proj)\.(weight|bias)$",
     r"speech_encoder_prenet.\1.\2"),
    (r"speech_encoder_prenet\.mask_emb$", r"speech_encoder_prenet.mask_emb"),
    (r"speech_encoder_prenet\.pos_conv\.0\.(weight_g|weight_v|bias)$",
     r"speech_encoder_prenet.pos_conv.\1"),
    (r"text_encoder_prenet\.encoder_prenet\.0\.weight$",
     r"text_encoder_prenet.embed_tokens.weight"),
    (r"text_encoder_prenet\.encoder_prenet\.1\.alpha$", r"text_encoder_prenet.alpha"),
    (r"(encoder|decoder)\.layers\.(\d+)\.(self_attn|encoder_attn)\.([qkv]_proj|out_proj)"
     r"\.(weight|bias)$", r"\1.layers.\2.\3.\4.\5"),
    (r"(encoder|decoder)\.layers\.(\d+)\.(self_attn_layer_norm|encoder_attn_layer_norm"
     r"|final_layer_norm|norm_k)\.(weight|bias)$", r"\1.layers.\2.\3.\4"),
    (r"(encoder|decoder)\.layers\.(\d+)\.(fc1|fc2)\.(weight|bias)$",
     r"\1.layers.\2.ffn.\3.\4"),
    (r"(encoder|decoder)\.layer_norm\.(weight|bias)$", r"\1.layer_norm.\2"),
    (r"(encoder|decoder)\.pos_emb\.pe_k\.weight$", r"\1.pos_emb.pe_k.weight"),
    (r"encoder\.proj\.(weight|bias)$", r"encoder.proj.\1"),
    (r"text_decoder_prenet\.embed_tokens\.weight$", r"text_decoder_prenet.embed_tokens.weight"),
    (r"text_decoder_prenet\.layernorm_embedding\.(weight|bias)$",
     r"text_decoder_prenet.layernorm_embedding.\1"),
    (r"text_decoder_postnet\.output_projection\.weight$",
     r"text_decoder_postnet.output_projection.weight"),
    (r"speech_decoder_prenet\.decoder_prenet\.0\.0\.prenet\.(\d+)\.0\.(weight|bias)$",
     r"speech_decoder_prenet.prenet.layer_\1.\2"),
    (r"speech_decoder_prenet\.decoder_prenet\.0\.1\.(weight|bias)$",
     r"speech_decoder_prenet.proj.\1"),
    (r"speech_decoder_prenet\.decoder_prenet\.1\.alpha$", r"speech_decoder_prenet.alpha"),
    (r"speech_decoder_prenet\.spkembs_layer\.0\.(weight|bias)$",
     r"speech_decoder_prenet.spkembs_layer.\1"),
    (r"speech_decoder_postnet\.(feat_out|prob_out)\.(weight|bias)$",
     r"speech_decoder_postnet.\1.\2"),
    (r"speech_decoder_postnet\.postnet\.postnet\.(\d+)\.0\.weight$",
     r"speech_decoder_postnet.postnet.conv_\1.weight"),
    (r"speech_decoder_postnet\.postnet\.postnet\.(\d+)\.1\.(weight|bias|running_mean"
     r"|running_var)$", r"speech_decoder_postnet.postnet.bn_\1.\2"),
    (r"speaker_decoder_postnet\.(output_embedding|output_projection)\.weight$",
     r"speaker_decoder_postnet.\1.weight"),
    (r"speaker_decoder_postnet\.(bn_pooling|bn_embedding)\.(weight|bias|running_mean"
     r"|running_var)$", r"speaker_decoder_postnet.\1.\2"),
    (r"hubert_layer\.label_embs_concat$", r"speech_encoder_postnet.label_embs_concat"),
    (r"hubert_layer\.final_proj\.(weight|bias)$", r"speech_encoder_postnet.final_proj.\1"),
    (r"quantizer\.vars$", r"quantizer.vars"),
    (r"quantizer\.weight_proj\.(weight|bias)$", r"quantizer.weight_proj.\1"),
)]
_FAIRSEQ_SKIP = re.compile(r"(\._float_tensor|\.version|num_updates|num_batches_tracked)$")


def map_fairseq_key(key: str):
    """A fairseq SpeechT5 key -> the port's key; "" for a buffer to skip
    (as JAX skips it); None for a key unknown to the reference."""
    if _FAIRSEQ_SKIP.search(key):
        return ""
    for pat, repl in _FAIRSEQ_RULES:
        if pat.match(key):
            return pat.sub(repl, key)
    return None


class _Opaque:
    """Stands for a class of a package this machine need not have (fairseq,
    omegaconf, typing): it records what the pickle hands it and runs no
    code of the class."""

    def __init__(self, *args, **kwargs):
        self.args, self.state = args, kwargs

    def __setstate__(self, state):
        self.state = state


_PICKLE_ALLOWED = {
    ("collections", "OrderedDict"), ("argparse", "Namespace"),
    ("torch._utils", "_rebuild_tensor_v2"), ("torch._utils", "_rebuild_parameter"),
    ("torch._utils", "_rebuild_parameter_with_state"), ("torch", "Size"),
    ("torch", "device"), ("torch", "dtype"), ("copyreg", "_reconstructor"),
    *(("builtins", n) for n in ("object", "set", "frozenset", "slice", "complex",
                                "dict", "list", "tuple", "int", "float", "bool",
                                "str", "bytes", "bytearray")),
    *(("torch", n) for n in ("FloatStorage", "HalfStorage", "BFloat16Storage",
                             "DoubleStorage", "LongStorage", "IntStorage",
                             "ShortStorage", "CharStorage", "ByteStorage",
                             "BoolStorage", "float32", "float16", "bfloat16",
                             "float64", "int64", "int32", "uint8", "bool")),
}


def _tolerant_pickle_module():
    """A pickle module for ``torch.load`` that builds tensors, ``argparse``
    namespaces and plain containers, and an ``_Opaque`` in place of any
    other class (fairseq's and omegaconf's configs): no code of an unknown
    class runs, and no fairseq or omegaconf is needed."""
    import pickle
    import types

    stubs = {}

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if (module, name) in _PICKLE_ALLOWED:
                return super().find_class(module, name)
            if module == "torch.storage" and name == "UntypedStorage":
                return super().find_class(module, name)
            key = f"{module}.{name}"
            if key not in stubs:
                stubs[key] = type(name, (_Opaque,), {"__module__": module})
            return stubs[key]

    return types.SimpleNamespace(Unpickler=Unpickler, load=pickle.load,
                                 __name__="tolerant_pickle")


def _plain(obj):
    """The checkpoint's config as plain Python: a namespace or an opaque
    object (omegaconf) becomes the dict it holds."""
    import argparse

    if isinstance(obj, argparse.Namespace):
        return {k: _plain(v) for k, v in vars(obj).items()}
    if isinstance(obj, _Opaque):
        state = obj.state
        if isinstance(state, dict) and "_content" in state:   # omegaconf nodes
            state = state["_content"]
        if isinstance(state, dict) and "_val" in state:
            return _plain(state["_val"])
        return _plain(state) if state else [_plain(a) for a in obj.args]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def load_fairseq_checkpoint(path):
    """Read a fairseq SpeechT5 ``.pt`` (JAX utils/convert.py:335) without
    fairseq or omegaconf installed.  -> (state_dict of f32 tensors under the
    port's keys, the checkpoint's ``cfg`` or ``args`` as plain Python or
    None, unknown keys: the ones the reference does not map).  Raises,
    naming the key, on a model entry that is not a tensor, and when no key
    maps."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_tolerant_pickle_module())
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a checkpoint dict ({type(ckpt).__name__})")
    sd = ckpt["model"] if "model" in ckpt else ckpt
    out, unknown = {}, []
    for key, val in sd.items():
        port_key = map_fairseq_key(key)
        if port_key == "":
            continue
        if not torch.is_tensor(val):
            raise ValueError(f"{path}: model entry {key!r} is a "
                             f"{type(val).__name__}, not a tensor")
        if port_key is None:
            unknown.append(key)
            continue
        t = val.detach().to(torch.float32)
        out[port_key] = t.reshape(1).clone() if port_key.endswith(".alpha") else t.clone()
    if not out:
        raise ValueError(f"{path}: no key of a SpeechT5 model ({len(sd)} entries, "
                         f"first {list(sd)[:3]})")
    cfg = ckpt.get("cfg") or ckpt.get("args")
    return out, (None if cfg is None else _plain(cfg)), unknown


# ------------------------------------------------------------- HiFi-GAN

def _wn_effective(g, v, dim: int = 0):
    """torch weight_norm: g * v / ||v||, the norm over every axis but
    ``dim``, in float64."""
    axes = tuple(i for i in range(v.dim()) if i != dim)
    norm = torch.sqrt((v.double() ** 2).sum(axes, keepdim=True))
    return g.double() * v.double() / torch.clamp_min(norm, 1e-12)


def convert_hifigan_state_dict(sd) -> dict:
    """A torch HiFi-GAN generator state dict -> the port's
    ``HiFiGANGenerator`` state dict (JAX utils/convert.py:244).  Takes the
    HF ``microsoft/speecht5_hifigan`` naming (``upsampler.<i>``, the
    ``mean`` / ``scale`` buffers) and the original HiFi-GAN repo's
    (``ups.<i>``), each conv stored plain (``.weight``), as a weight-norm
    pair (``.weight_g`` / ``.weight_v``) or as a parametrization
    (``.parametrizations.weight.original0/1``).  Each conv goes through its
    effective weight, stored as ``weight_v`` with ``weight_g`` = its norm
    per output channel, so g * v / ||v|| gives it back whatever torch's
    per-module weight-norm axis was (per output channel for Conv1d, per
    input channel for ConvTranspose1d)."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    out = {}

    def effective(prefix):
        if f"{prefix}.weight" in sd:
            return sd[f"{prefix}.weight"].double()
        p0 = f"{prefix}.parametrizations.weight.original0"
        if p0 in sd:
            return _wn_effective(sd[p0], sd[f"{prefix}.parametrizations.weight.original1"])
        return _wn_effective(sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"])

    def put_conv(dst, w, transposed=False):
        axes = (0, 2) if transposed else (1, 2)   # all but the output channel
        out[f"{dst}.weight_v"] = w.float()
        out[f"{dst}.weight_g"] = torch.sqrt((w ** 2).sum(axes)).float()

    primary = ("weight", "weight_v", "parametrizations.weight.original1")
    for key in sd:
        m = re.match(r"(conv_pre|conv_post)\.(.+)$", key)
        if m:
            name, wb = m.groups()
            if wb == "bias":
                out[f"{name}.bias"] = sd[key].float()
            elif wb in primary:
                put_conv(name, effective(name))
            continue
        m = re.match(r"(ups|upsampler)\.(\d+)\.(.+)$", key)
        if m:
            mod, i, wb = m.groups()
            if wb == "bias":
                out[f"ups_{i}.bias"] = sd[key].float()
            elif wb in primary:
                put_conv(f"ups_{i}", effective(f"{mod}.{i}"), transposed=True)
            continue
        m = re.match(r"resblocks\.(\d+)\.(convs1|convs2)\.(\d+)\.(.+)$", key)
        if m:
            n, cs, j, wb = m.groups()
            if wb == "bias":
                out[f"resblocks_{n}.{cs}_{j}.bias"] = sd[key].float()
            elif wb in primary:
                put_conv(f"resblocks_{n}.{cs}_{j}", effective(f"resblocks.{n}.{cs}.{j}"))
            continue
        if key in ("mean", "mel_mean"):
            out["mel_mean"] = sd[key].float()
        elif key in ("scale", "mel_scale"):
            out["mel_scale"] = sd[key].float()
    return out
