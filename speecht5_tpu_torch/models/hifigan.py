"""HiFi-GAN vocoder generator (port of ``speecht5_tpu/models/hifigan.py``
:26-155): log-mel [B, T, 80] -> waveform [B, T * 256].

The v1 topology of the released ``microsoft/speecht5_hifigan`` checkpoint:
the mel standardised by the ``mel_mean`` / ``mel_scale`` buffers
(``normalize_before``), ``conv_pre`` (k 7) to 512 channels, four
transposed-conv upsamplings by 4 (hop 256) each followed by the mean of
three multi-receptive-field resblocks (kernels 3, 7, 11, dilations 1, 3,
5), leaky ReLU (slope 0.1 throughout, as the JAX module has it),
``conv_post`` (k 7) to one channel and tanh.  Every conv keeps torch's
``weight_norm(dim=0)`` pair: ``weight_v`` in torch's layout and
``weight_g`` one gain per output channel, the weight ``g * v / ||v||``
(the norm over all axes but the output channel, with the JAX module's
1e-12 under the root).  The convolutions are ``F.conv1d`` /
``F.conv_transpose1d``: the JAX module runs them outside any Pallas kernel.
Module names follow the JAX tree (``conv_pre``, ``ups_<i>``,
``resblocks_<n>.convs1_<j>``), so ``utils/convert.convert_hifigan_state_dict``
fills them from either released naming.

``CodeHiFiGAN`` (JAX :159-217) is the S2ST chain's unit vocoder: a unit
embedding, optionally a duration predictor that re-expands reduced units
into a static ``T * max_duration`` frame buffer (a cumsum gather, padded
units given duration 0 and the slots past the last end zeroed), then the
generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device


@dataclass(frozen=True)
class HiFiGANConfig:
    in_dim: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (4, 4, 4, 4)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 8, 8)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    leaky_slope: float = 0.1
    normalize_before: bool = True  # HF SpeechT5HifiGan mel standardisation


class WNConv1d(nn.Module):
    """Weight-normed Conv1d (``transposed``: ConvTranspose1d, weight [in,
    out, k]) with torch's padding conventions: "same" for the plain conv
    ((k - 1) * dilation / 2 each side), ``padding`` for the transposed one."""

    def __init__(self, c_in: int, c_out: int, kernel: int, *, dilation: int = 1,
                 stride: int = 1, padding: int = 0, transposed: bool = False):
        super().__init__()
        shape = (c_in, c_out, kernel) if transposed else (c_out, c_in, kernel)
        self.weight_v = nn.Parameter(torch.empty(shape))
        self.weight_g = nn.Parameter(torch.ones(c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.transposed = transposed
        self.dilation, self.stride, self.padding = dilation, stride, padding

    def weight(self):
        v = self.weight_v
        axes = (0, 2) if self.transposed else (1, 2)
        norm = torch.sqrt((v * v).sum(axes, keepdim=True) + 1e-12)
        g = self.weight_g.view((1, -1, 1) if self.transposed else (-1, 1, 1))
        return g * v / norm

    def forward(self, x):
        if self.transposed:
            return F.conv_transpose1d(x, self.weight(), self.bias, stride=self.stride,
                                      padding=self.padding)
        k = self.weight_v.shape[-1]
        return F.conv1d(x, self.weight(), self.bias, dilation=self.dilation,
                        padding=(k - 1) * self.dilation // 2)


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel: int, dilations, slope: float):
        super().__init__()
        self.slope = slope
        self.n = len(dilations)
        for j, d in enumerate(dilations):
            self.add_module(f"convs1_{j}", WNConv1d(channels, channels, kernel, dilation=d))
            self.add_module(f"convs2_{j}", WNConv1d(channels, channels, kernel))

    def forward(self, x):
        for j in range(self.n):
            y = getattr(self, f"convs1_{j}")(F.leaky_relu(x, self.slope))
            x = x + getattr(self, f"convs2_{j}")(F.leaky_relu(y, self.slope))
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.register_buffer("mel_mean", torch.zeros(cfg.in_dim))
        self.register_buffer("mel_scale", torch.ones(cfg.in_dim))
        self.conv_pre = WNConv1d(cfg.in_dim, ch, 7)
        nk = len(cfg.resblock_kernel_sizes)
        for i, (r, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            self.add_module(f"ups_{i}", WNConv1d(ch, ch // 2, k, stride=r,
                                                 padding=(k - r) // 2, transposed=True))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilations)):
                self.add_module(f"resblocks_{i * nk + j}",
                                ResBlock1(ch, rk, rd, cfg.leaky_slope))
        self.conv_post = WNConv1d(ch, 1, 7)

    def forward(self, mel):
        """mel: [B, T, in_dim] log-mel -> waveform [B, T * hop] f32."""
        cfg = self.cfg
        x = mel.float()
        if cfg.normalize_before:
            x = (x - self.mel_mean) / torch.clamp_min(self.mel_scale, 1e-8)
        x = self.conv_pre(x.transpose(1, 2))
        nk = len(cfg.resblock_kernel_sizes)
        for i in range(len(cfg.upsample_rates)):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, cfg.leaky_slope))
            acc = None
            for j in range(nk):
                y = getattr(self, f"resblocks_{i * nk + j}")(x)
                acc = y if acc is None else acc + y
            x = acc / nk
        x = self.conv_post(F.leaky_relu(x, cfg.leaky_slope))
        return torch.tanh(x)[:, 0]


@dataclass(frozen=True)
class CodeHiFiGANConfig:
    num_units: int = 1000
    embed_dim: int = 128
    dur_predictor: bool = False   # reduced (deduped) units need re-expansion
    max_duration: int = 8         # the static cap of one unit's frames
    generator: HiFiGANConfig = HiFiGANConfig(in_dim=128, normalize_before=False)


def expand_index(dur, max_duration: int):
    """Durations [B, T] int (0 for padded units) -> (idx [B, T *
    max_duration] int64: the unit each output slot takes, out_valid [B, T *
    max_duration] bool: the slots before the last unit's end).  Slot j
    takes unit t where cumsum(dur)[t - 1] <= j < cumsum(dur)[t], counted
    exactly in integers as JAX does: ``(pos >= ends).sum(-1)`` clamped to
    T - 1."""
    T = dur.shape[1]
    ends = torch.cumsum(dur.long(), dim=1)                              # [B, T]
    pos = torch.arange(T * max_duration, device=dur.device)[None, :]    # [1, T_out]
    idx = (pos[:, :, None] >= ends[:, None, :]).sum(-1)
    return torch.clamp_max(idx, T - 1), pos < ends[:, -1:]


class CodeHiFiGAN(nn.Module):
    """units [B, T] int -> waveform [B, T * hop] (hop = prod(upsample)),
    or [B, T * max_duration * hop] with the duration predictor;
    ``unit_valid`` bool [B, T] masks padded units."""

    def __init__(self, cfg: CodeHiFiGANConfig = CodeHiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        E = cfg.embed_dim
        self.unit_embed = nn.Embedding(cfg.num_units, E)
        if cfg.dur_predictor:
            self.dur_conv1 = WNConv1d(E, E, 3)
            self.dur_conv2 = WNConv1d(E, E, 3)
            self.dur_proj = nn.Linear(E, 1)
        self.generator = HiFiGANGenerator(cfg.generator)

    def durations(self, x, unit_valid):
        """Unit embeddings [B, T, E] -> (the predictor's log-durations [B,
        T] f32, durations [B, T] int64: clip(round(exp(.)), 1,
        max_duration), round half to even as ``jnp.round``; 0 where
        ``unit_valid`` is False)."""
        h = torch.relu(self.dur_conv1(x.transpose(1, 2)))
        h = self.dur_conv2(h).transpose(1, 2)
        dur_f = self.dur_proj(h)[..., 0]
        dur = torch.clamp(torch.round(torch.exp(dur_f)).long(), 1, self.cfg.max_duration)
        return dur_f, torch.where(unit_valid, dur, torch.zeros_like(dur))

    def forward(self, units, unit_valid=None, *, predict_duration=None):
        cfg = self.cfg
        if predict_duration is None:
            predict_duration = cfg.dur_predictor
        if predict_duration and not cfg.dur_predictor:
            raise ValueError("predict_duration needs a config with dur_predictor=True")
        x = self.unit_embed(units.long())
        if unit_valid is None:
            unit_valid = torch.ones(units.shape, dtype=torch.bool, device=units.device)
        if predict_duration:
            _, dur = self.durations(x, unit_valid)
            idx, out_valid = expand_index(dur, cfg.max_duration)
            x = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))
            x = x * out_valid[:, :, None]
        else:
            x = x * unit_valid[:, :, None]
        return self.generator(x)


def init_hifigan(cfg: HiFiGANConfig = HiFiGANConfig(), generator=None,
                 device="cuda") -> HiFiGANGenerator:
    """A generator with random weights from ``generator`` (a CPU
    ``torch.Generator``, seeded 0 when None), as the JAX initialisers draw
    them: ``weight_v`` normal(0.05), ``weight_g`` its norm (so the weight is
    ``weight_v``), zero biases; on ``device`` in eval mode."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    voc = HiFiGANGenerator(cfg)
    with torch.no_grad():
        for mod in voc.modules():
            if isinstance(mod, WNConv1d):
                mod.weight_v.normal_(0.0, 0.05, generator=generator)
                axes = (0, 2) if mod.transposed else (1, 2)
                mod.weight_g.copy_(mod.weight_v.pow(2).sum(axes).sqrt())
    return voc.to(dev).eval()


def init_codehifigan(cfg: CodeHiFiGANConfig = CodeHiFiGANConfig(), generator=None,
                     device="cuda") -> CodeHiFiGAN:
    """A ``CodeHiFiGAN`` with random weights from ``generator`` (CPU, seeded
    0 when None): the weight-normed convs as ``init_hifigan`` draws them,
    the unit embedding normal(embed_dim^-0.5) and the duration projection
    lecun-normal with a zero bias, as the JAX initialisers; on ``device``
    in eval mode."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    voc = CodeHiFiGAN(cfg)
    with torch.no_grad():
        voc.unit_embed.weight.normal_(0.0, cfg.embed_dim ** -0.5, generator=generator)
        if cfg.dur_predictor:
            voc.dur_proj.weight.normal_(0.0, cfg.embed_dim ** -0.5, generator=generator)
            voc.dur_proj.bias.zero_()
        for mod in voc.modules():
            if isinstance(mod, WNConv1d):
                mod.weight_v.normal_(0.0, 0.05, generator=generator)
                axes = (0, 2) if mod.transposed else (1, 2)
                mod.weight_g.copy_(mod.weight_v.pow(2).sum(axes).sqrt())
    return voc.to(dev).eval()
