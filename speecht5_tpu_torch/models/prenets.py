"""The modality prenets: speech encoder (waveform -> encoder input), text
encoder (tokens -> encoder input), text decoder (tokens -> decoder input)
and speech decoder (previous mel frames -> decoder input).

Port of ``speecht5_tpu/models/prenets.py`` :34-531 (reference
modules/speech_encoder_prenet.py:58-272, text_encoder_prenet.py,
text_decoder_prenet.py, speech_decoder_prenet.py): the wav2vec2 conv
feature extractor, feature gradient scaling (``feature_grad_mult``),
post-extract LayerNorm + 512->d projection, dropout, HuBERT time/channel
masking on training passes, the weight-normed conv positional embedding and
fairseq sinusoidal positions; the text encoder prenet (embedding + alpha x
espnet positions); the text decoder prenet in full-sequence mode
(``.step`` arrives with the beam slice); the speech decoder prenet
(Tacotron2 prenet, projection, alpha x espnet positions, the ``pre``
x-vector layer) in full-sequence mode.

Parameters use torch layouts (Conv1d ``[C_out, C_in, k]``, Linear
``[out, in]``); ``utils/convert.from_jax_params`` maps the JAX trees.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ConvFeatureConfig, SpeechT5Config
from ..ops import cuda_kernels
from ..ops.masking import apply_feature_masks, sample_feature_masks
from ..parallel.distributed import mean_share
from ..ops.positional import (espnet_sinusoidal, espnet_sinusoidal_table,
                              fairseq_sinusoidal, fairseq_sinusoidal_table)
from ..utils.masks import length_mask
from .common import Dense, LayerNorm32


class GradMultiply(torch.autograd.Function):
    """Identity forward, gradient scaled by ``scale`` (reference fairseq
    GradMultiply, speech_encoder_prenet.py:156-164; JAX prenets.py:34-54)."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _conv_weight(c_out: int, c_in: int, k: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(c_out, c_in, k))


class _ConvKernel(nn.Module):
    """Bare conv kernel ``weight`` [C_out, C_in, k] under the JAX tree's
    ``conv_i`` name, and its ``bias`` [C_out] when asked for; every
    ``impl`` reads the same parameters."""

    def __init__(self, c_out: int, c_in: int, k: int, bias: bool = False):
        super().__init__()
        self.weight = _conv_weight(c_out, c_in, k)
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None


class WeightNormConv1d(nn.Module):
    """Conv1d with torch weight_norm(dim=2) parametrization (per-kernel-position
    magnitude), matching the reference conv positional embedding
    (speech_encoder_prenet.py:107-119).  ``weight_v`` is [C_out, C_in/groups,
    k], ``weight_g`` is [1, 1, k]."""

    def __init__(self, channels: int, kernel_size: int, groups: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.groups = groups
        self.dtype = dtype
        self.weight_v = _conv_weight(channels, channels // groups, kernel_size)
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        """x: [B, T, C] -> [B, T, C]."""
        v = self.weight_v.float()
        norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True) + 1e-12)
        w = (self.weight_g * v / norm).to(self.dtype)
        k = self.kernel_size
        # SAME-style padding k//2 both sides, then SamePad trims one trailing
        # element for even kernels (reference SamePad in prenet :119)
        y = F.conv1d(x.to(self.dtype).transpose(1, 2), w, padding=k // 2,
                     groups=self.groups)
        y = y.transpose(1, 2) + self.bias.to(self.dtype)
        if k % 2 == 0:
            y = y[:, :-1, :]
        return y


class _PerChannelGroupNorm(nn.Module):
    """GroupNorm with num_groups == channels (per-channel stats over time,
    padded frames included), the w2v2 "default" mode's Fp32GroupNorm on conv
    layer 0.  Stats in f32, the feature map stays in the compute dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = (xf * xf).mean(dim=1, keepdim=True) - mean * mean
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        return (x * inv.to(self.dtype) + shift.to(self.dtype)).to(self.dtype)


class ConvFeatureExtractor(nn.Module):
    """wav2vec2-style stack of strided Conv1d blocks
    (reference speech_encoder_prenet.py:278-374; JAX prenets.py:223-292).

    Layer 0 (one input channel) runs as the JAX package's ``_Conv0MatMul``:
    framing by shifted strided views and one [*, k] @ [k, C] matmul.
    "default" mode (Base): GroupNorm after layer 0, then each layer's exact
    GELU; layers 1.. run per ``cfg.impl``: "pallas" -> the CUDA conv stack
    of ``ops/cuda_kernels`` (the port's counterpart of the JAX
    ``conv_stack_fused``), "polyphase" -> per-tap matmuls, "xla" -> conv1d.
    "layer_norm" mode (Large): every layer is conv, then ``ln_<i>`` over the
    channels in f32 (flax's epsilon, 1e-6), then the exact GELU; layers 1..
    run as ``F.conv1d`` whatever ``impl`` says, as JAX's stack engages its
    kernel in "default" mode only (prenets.py:236).  Either mode takes a
    conv bias (``cfg.bias``, each ``conv_<i>``'s ``bias``: WavLM Large's
    extractor); with one, layers 1.. run as ``F.conv1d`` whatever ``impl``
    says, as JAX's rule keeps its kernel off (prenets.py:235-237).
    """

    def __init__(self, cfg: ConvFeatureConfig, dtype=torch.float32):
        super().__init__()
        if cfg.mode not in ("default", "layer_norm"):
            raise NotImplementedError(
                f"conv feature mode {cfg.mode!r}: only 'default' and 'layer_norm', "
                "each with or without conv bias, are ported")
        dim0, k0, s0 = cfg.layers[0]
        if k0 % s0:
            raise NotImplementedError("conv 0 needs stride | kernel")
        self.cfg = cfg
        self.dtype = dtype
        c_in = 1
        for i, (dim, k, _) in enumerate(cfg.layers):
            self.add_module(f"conv_{i}", _ConvKernel(dim, c_in, k, cfg.bias))
            if cfg.mode == "layer_norm":
                self.add_module(f"ln_{i}", LayerNorm32(dim, eps=1e-6))
            c_in = dim
        if cfg.mode == "default":
            self.group_norm = _PerChannelGroupNorm(dim0, 1e-5, dtype)

    @property
    def convs(self):
        return [getattr(self, f"conv_{i}") for i in range(len(self.cfg.layers))]

    def _conv0(self, wav):
        _, k, s = self.cfg.layers[0]
        x = wav.to(self.dtype)
        B, T = x.shape
        n_out = (T - k) // s + 1
        rows = x[:, : (T // s) * s].reshape(B, T // s, s)
        frames = torch.cat([rows[:, i : i + n_out] for i in range(k // s)], dim=-1)
        w = self.convs[0].weight[:, 0, :].t().to(self.dtype)    # [k, C]
        y = frames @ w
        return y if self.convs[0].bias is None else y + self.convs[0].bias.to(self.dtype)

    def _conv1d(self, x, c, s):
        """Layer ``c`` as ``F.conv1d`` over [B, T, C] (its bias, if any)."""
        b = None if c.bias is None else c.bias.to(self.dtype)
        return F.conv1d(x.transpose(1, 2), c.weight.to(self.dtype), b,
                        stride=s).transpose(1, 2)

    def _layer_norm_forward(self, wav):
        x = self._conv0(wav)
        for i, ((_, _, s), c) in enumerate(zip(self.cfg.layers, self.convs)):
            if i:
                x = self._conv1d(x, c, s)
            x = F.gelu(getattr(self, f"ln_{i}")(x).to(self.dtype))
        return x

    def forward(self, wav):
        """wav: [B, T] -> [B, frames, C_out]."""
        if self.cfg.mode == "layer_norm":
            return self._layer_norm_forward(wav)
        x = F.gelu(self.group_norm(self._conv0(wav)))  # exact (erf) GELU
        rest = self.cfg.layers[1:]
        if not rest:
            return x
        specs = tuple((k, s) for _, k, s in rest)
        convs = self.convs[1:]
        if self.cfg.impl == "xla" or self.cfg.bias:
            for (_, s), c in zip(specs, convs):
                x = F.gelu(self._conv1d(x, c, s))
            return x
        # [k, C_in, C_out]: the JAX kernel layout of the conv-stack contract
        weights = [c.weight.permute(2, 1, 0) for c in convs]
        if self.cfg.impl == "pallas":
            return cuda_kernels.conv_stack(x, weights, specs)
        if self.cfg.impl == "polyphase":
            return cuda_kernels.conv_stack_plain(x, weights, specs)
        raise ValueError(f"conv_features.impl={self.cfg.impl!r}")


class SpeechEncoderPrenet(nn.Module):
    def __init__(self, cfg: SpeechT5Config, dtype=torch.float32):
        super().__init__()
        if not (cfg.use_conv_pos and cfg.use_sinc_pos):
            raise NotImplementedError("the slice ports the Base prenet: conv "
                                      "and sinusoidal positions both on")
        self.cfg = cfg
        self.dtype = dtype
        self.feature_extractor = ConvFeatureExtractor(cfg.conv_features, dtype)
        c_out = cfg.conv_features.out_dim
        self.layer_norm = LayerNorm32(c_out, eps=1e-6)
        self.post_extract_proj = (Dense(c_out, cfg.d_model, dtype)
                                  if c_out != cfg.d_model else None)
        self.mask_emb = nn.Parameter(torch.empty(cfg.d_model))
        self.pos_conv = WeightNormConv1d(cfg.d_model, cfg.conv_pos,
                                         cfg.conv_pos_groups, dtype)

    def forward(self, wav, wav_lengths, *, mask: bool = False, generator=None,
                masks=None):
        """wav: [B, T] raw 16 kHz; wav_lengths: [B] (on any device: a CPU
        tensor lets the masks be drawn with no device sync) -> (x [B,
        frames, D], valid bool [B, frames], the time mask bool [B, frames]
        on x's device or None, ``features_pen``: the mean square of the conv
        features in f32, JAX prenets.py:342; under data parallelism this rank's
        share of the global batch's mean).  ``mask``: HuBERT masking,
        drawn from the CPU ``generator`` (the default CPU generator when
        None), or ``masks`` = (time mask, channel mask or None) as given."""
        cfg = self.cfg
        frame_lengths = cfg.conv_features.out_length(wav_lengths)
        # feature grad scaling (reference :156-164): 0 detaches the
        # extractor, so it runs without building a graph
        mult = cfg.feature_grad_mult
        with torch.set_grad_enabled(torch.is_grad_enabled() and mult != 0.0):
            feats = self.feature_extractor(wav)
        if mult not in (0.0, 1.0):
            feats = GradMultiply.apply(feats, mult)
        features_pen = mean_share(feats.float().pow(2))
        frames = feats.shape[1]
        valid = length_mask(frame_lengths.to(feats.device, non_blocking=True), frames)
        x = self.layer_norm(feats).to(self.dtype)
        if self.post_extract_proj is not None:
            x = self.post_extract_proj(x)
        x = F.dropout(x, cfg.encoder.dropout, self.training)
        time_mask = None
        if mask and cfg.masking.mask_prob > 0:
            if masks is None:
                masks = sample_feature_masks(frame_lengths.cpu(), frames, x.shape[-1],
                                             cfg.masking, generator)
            time_mask, chan_mask = masks
            dev = dict(device=x.device, non_blocking=True)
            time_mask = time_mask.to(**dev)
            x = apply_feature_masks(
                x, time_mask, self.mask_emb,
                None if chan_mask is None else chan_mask.to(**dev))
        x = x + F.gelu(self.pos_conv(x))
        x = x + fairseq_sinusoidal(valid, cfg.d_model).to(self.dtype)
        return x, valid, time_mask, features_pen


class TextDecoderPrenet(nn.Module):
    """Embedding (unscaled) + fairseq sinusoidal positions + dropout, in
    full-sequence mode (JAX prenets.py:403-427) and one step at a time
    (``step``, :428-443)."""

    def __init__(self, cfg: SpeechT5Config, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        # the step's position table, as JAX builds it (not a parameter)
        table = fairseq_sinusoidal_table(cfg.pad_id + 2 + cfg.max_text_positions,
                                         cfg.d_model, cfg.pad_id)
        self.register_buffer("step_positions", torch.from_numpy(table),
                             persistent=False)

    def forward(self, tokens, *, dropout: bool = True):
        """tokens: [B, T] -> (x [B, T, D], valid bool [B, T]).  ``dropout``
        False: none even on a training pass (the SID [CLS] vector, which JAX
        always embeds deterministically)."""
        cfg = self.cfg
        valid = tokens != cfg.pad_id
        x = self.embed_tokens(tokens).to(self.dtype)
        x = x + fairseq_sinusoidal(valid, cfg.d_model, cfg.pad_id).to(self.dtype)
        return F.dropout(x, cfg.decoder.dropout, self.training and dropout), valid

    def step(self, tokens_t, position):
        """tokens_t: [B, 1]; position: the 0-based step (int or 0-d tensor)
        -> [B, 1, D].  Live beams hold no padding, so the fairseq position
        is pad_id + 1 + position."""
        cfg = self.cfg
        x = self.embed_tokens(tokens_t).to(self.dtype)
        pos = self.step_positions[cfg.pad_id + 1 + position]
        x = x + pos[None, None, :].to(self.dtype)
        return F.dropout(x, cfg.decoder.dropout, self.training)


class TextEncoderPrenet(nn.Module):
    """Embedding + espnet ScaledPositionalEncoding (alpha * pe) + dropout
    (JAX prenets.py:377-400)."""

    def __init__(self, cfg: SpeechT5Config, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, tokens):
        """tokens: [B, T] -> (x [B, T, D], valid bool [B, T])."""
        cfg = self.cfg
        x = self.embed_tokens(tokens).to(self.dtype)
        pe = espnet_sinusoidal(tokens.shape[1], cfg.d_model,
                               device=tokens.device).to(self.dtype)
        x = x + self.alpha.to(self.dtype) * pe[None]
        x = F.dropout(x, cfg.encoder.dropout, self.training)
        return x, tokens != cfg.pad_id


class TacotronPrenet(nn.Module):
    """Tacotron2 decoder prenet: Dense -> ReLU -> dropout blocks, the dropout
    on in training AND in eval (espnet convention, config.py:185; JAX
    prenets.py:445-468 applies it whenever it is given a ``prenet`` rng,
    which its t2s step always gives).  Blocks ``layer_<i>``."""

    def __init__(self, in_dim: int, layers: int, units: int, dropout: float,
                 dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        for i in range(layers):
            self.add_module(f"layer_{i}", Dense(in_dim if i == 0 else units, units, dtype))
        self.layers = layers

    def forward(self, x, keep_masks=None, generator=None):
        """x: [B, T, in_dim] -> [B, T, units].  ``keep_masks``: one bool mask
        [B, T, units] per block to use instead of drawing (the tests hand in
        the JAX package's draws); else ``generator`` (a ``torch.Generator``
        on x's device) draws them, keep with probability 1 - rate; else the
        default device generator draws, as ``F.dropout`` does."""
        for i in range(self.layers):
            x = torch.relu(getattr(self, f"layer_{i}")(x))
            keep = None if keep_masks is None else keep_masks[i].to(x.device)
            if keep is None and generator is not None:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) >= self.dropout
            if keep is not None:
                x = torch.where(keep, x / (1.0 - self.dropout),
                                torch.zeros((), dtype=x.dtype, device=x.device))
            else:
                x = F.dropout(x, self.dropout, True)
        return x


class SpeechDecoderPrenet(nn.Module):
    """Previous r-thinned mel frames -> decoder input (JAX prenets.py
    :471-531): Tacotron prenet, ``proj`` to d_model, alpha x the espnet
    table sliced at ``position_offset``, dropout, then with an x-vector and
    ``spk_embed_integration == "pre"`` the L2-normalised x-vector
    concatenated to every frame, ``spkembs_layer`` and ReLU."""

    def __init__(self, cfg: SpeechT5Config, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        sp = cfg.speech_prenet
        self.prenet = TacotronPrenet(cfg.n_mels, sp.layers, sp.units, sp.dropout, dtype)
        self.proj = Dense(sp.units, cfg.d_model, dtype)
        self.alpha = nn.Parameter(torch.ones(1))
        self.spkembs_layer = None
        if cfg.spk_embed_dim is not None and cfg.spk_embed_integration == "pre":
            self.spkembs_layer = Dense(cfg.d_model + cfg.spk_embed_dim,
                                       cfg.d_model, dtype)
        # the decode step's position table, as JAX builds it (not a
        # parameter): a device offset indexes it with no host sync
        table = espnet_sinusoidal_table(cfg.max_speech_positions + 8, cfg.d_model)
        self.register_buffer("step_positions", torch.from_numpy(table.copy()),
                             persistent=False)

    def forward(self, prev_mel, tgt_lengths=None, spkembs=None, *,
                position_offset=0, keep_masks=None, generator=None):
        """prev_mel: [B, T, n_mels]; tgt_lengths: [B] or None; spkembs: [B,
        spk_embed_dim] or None -> (x [B, T, D], valid bool [B, T] or None).
        ``position_offset``: the first frame's position, an int or a 0-d
        device tensor (a decode step's ``cache["index"]``; clamped so the T
        rows fit the table, as JAX's dynamic slice is).  ``keep_masks`` /
        ``generator``: the Tacotron prenet's dropout (see TacotronPrenet)."""
        cfg = self.cfg
        x = self.prenet(prev_mel.to(self.dtype), keep_masks, generator)
        x = self.proj(x)
        T = x.shape[1]
        if torch.is_tensor(position_offset):
            table = self.step_positions
            start = position_offset.clamp(0, table.shape[0] - T)
            pe = table[start + torch.arange(T, device=table.device)].to(self.dtype)
        else:
            pe = espnet_sinusoidal(T, cfg.d_model, position_offset,
                                   device=x.device).to(self.dtype)
        x = x + self.alpha.to(self.dtype) * pe[None]
        x = F.dropout(x, cfg.decoder.dropout, self.training)
        if spkembs is not None and self.spkembs_layer is not None:
            s = spkembs.float()
            s = s / torch.clamp_min(torch.linalg.vector_norm(s, dim=-1, keepdim=True),
                                    1e-12)
            s = s[:, None, :].to(self.dtype).expand(x.shape[0], T, s.shape[-1])
            x = torch.relu(self.spkembs_layer(torch.cat([x, s], dim=-1)))
        valid = None
        if tgt_lengths is not None:
            valid = length_mask(tgt_lengths.to(x.device), T)
        return x, valid
