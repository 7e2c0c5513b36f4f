"""Carry the JAX package's parameters into the port.

``from_jax_params`` takes the JAX model's ``params`` tree flattened by the
caller to ``{"a/b/c": numpy array}`` (the port may not import flax) and
returns a ``state_dict`` for the port's ``SpeechT5Model``.  Layouts:

- Dense ``kernel`` [in, out]            -> Linear ``weight`` [out, in]
- Conv ``kernel`` [k, C_in, C_out]      -> ``weight`` [C_out, C_in, k]
- weight-norm ``weight_v`` [k, C_in/g, C_out] -> [C_out, C_in/g, k]
- weight-norm ``weight_g`` [k, 1, 1]    -> [1, 1, k]
- GroupNorm / LayerNorm ``scale``       -> ``weight``; ``bias`` -> ``bias``
- Embed ``embedding`` (``pe_k``)        -> ``weight``
- ``alpha`` (positional scales) [1]     -> ``alpha``
- ``layers_<i>``                        -> ``layers.<i>``

Only the subtrees the port has (``PORTED_SUBTREES``) are carried; the
others are left out of the result.  ``from_jax_batch_stats`` carries the
JAX ``batch_stats`` collection (the speech postnet's BatchNorm ``mean`` /
``var``) into the ``running_mean`` / ``running_var`` buffers.
"""

from __future__ import annotations

import re

import numpy as np
import torch

PORTED_SUBTREES = ("speech_encoder_prenet", "text_encoder_prenet", "encoder",
                   "decoder", "text_decoder_prenet", "text_decoder_postnet",
                   "speech_decoder_prenet", "speech_decoder_postnet",
                   "spkembs_projection")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 3:
            return "weight", value.transpose(2, 1, 0)
        raise ValueError(f"kernel of rank {value.ndim}")
    if name == "weight_v":
        return name, value.transpose(2, 1, 0)
    if name == "weight_g":
        return name, value.reshape(1, 1, -1)
    if name in ("scale", "embedding"):
        return "weight", value
    if name in ("bias", "mask_emb", "alpha"):
        return name, value
    raise KeyError(f"unknown parameter leaf {name!r}")


def _convert(flat: dict, collection: str, leaf_fn) -> dict:
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == collection:
            parts = parts[1:]
        if parts[0] not in PORTED_SUBTREES:
            continue
        path = [re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in parts[:-1]]
        leaf, arr = leaf_fn(parts[-1], np.asarray(value, np.float32))
        out[".".join(path + [leaf])] = torch.tensor(arr)
    return out


def from_jax_params(flat: dict) -> dict:
    """``{"encoder/layers_0/self_attn/q_proj/kernel": ndarray, ...}`` ->
    port ``state_dict`` of float32 tensors."""
    return _convert(flat, "params", _leaf)


def _stat_leaf(name: str, value: np.ndarray):
    if name not in _STATS:
        raise KeyError(f"unknown batch_stats leaf {name!r}")
    return _STATS[name], value


def from_jax_batch_stats(flat: dict) -> dict:
    """``{"speech_decoder_postnet/postnet/bn_0/mean": ndarray, ...}`` (the
    flattened ``batch_stats`` collection) -> the port's BatchNorm
    ``running_mean`` / ``running_var`` buffers."""
    return _convert(flat, "batch_stats", _stat_leaf)
