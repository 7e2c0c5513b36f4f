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
fills them from either released naming.  The unit-based ``CodeHiFiGAN``
waits for the unit families (ROADMAP A.9).
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
