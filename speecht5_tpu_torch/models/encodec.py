"""EnCodec neural audio codec: the SEANet encoder and decoder with a
residual vector quantizer (port of ``speecht5_tpu/models/encodec.py``).

- ``decode_codes``: RVQ codes [B, n_q, T] -> the sum of each codebook's
  lookups -> the causal SEANet decoder (conv, LSTM stack, transposed-conv
  upsampling by each ratio with residual units, ELU, conv) -> waveform
  [B, T * hop];
- ``encode``: the mirror downsampling stack, then a nearest-neighbour
  encode of each residual (the expanded distance ``|r|^2 - 2 r.e + |e|^2``,
  JAX's formula, ties to the lower index).

The topology and the parameters follow the HF ``facebook/encodec_24khz``
family: every conv keeps torch's weight norm split into ``weight_g`` (per
output channel of a conv, per input channel of a transposed conv) and
``weight_v``, so ``utils/convert_hf.convert_encodec`` carries a released
state dict losslessly.  The causal conv reflect-pads on the left by the
effective kernel minus the stride and zero-pads on the right to a whole
number of frames (JAX's extra pad; HF reflects it, ROADMAP C.2), and
reflects past the input's length as numpy does (HF zero-extends); the
transposed conv trims ``kernel - stride`` samples on the right.  The LSTM
stack is ``nn.LSTM`` (cuDNN on the card; gates i, f, g, o, JAX's
``lax.scan`` order) with a residual skip over the whole stack.  JAX runs
none of it in a Pallas kernel, so neither does the port.  Activations are
channels-first [B, C, T] inside; the codec computes in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace as dc_replace
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device


@dataclass(frozen=True)
class EncodecConfig:
    audio_channels: int = 1
    num_filters: int = 32
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 5, 4, 2)
    hidden_size: int = 128
    num_lstm_layers: int = 2
    codebook_size: int = 1024
    num_quantizers: int = 32
    compress: int = 2
    sampling_rate: int = 24000

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsampling_ratios)

    @property
    def frame_rate(self) -> float:
        return self.sampling_rate / self.hop_length


def encodec_24khz(**kw) -> EncodecConfig:
    """facebook/encodec_24khz geometry (hop 320, 75 Hz, 32 codebooks)."""
    return dc_replace(EncodecConfig(), **kw)


def encodec_tiny(**kw) -> EncodecConfig:
    """The CPU-testable shrink of the same topology (JAX ``encodec_tiny``)."""
    return dc_replace(EncodecConfig(
        num_filters=4, hidden_size=8, codebook_size=16, num_quantizers=4,
        upsampling_ratios=(4, 2), num_lstm_layers=1, sampling_rate=16000), **kw)


def _wn_weight(v, g, axes):
    """torch weight norm g * v / ||v|| (the norm over ``axes``, JAX's 1e-12
    under the root)."""
    norm = torch.sqrt((v * v).sum(axes, keepdim=True) + 1e-12)
    shape = [1] * v.dim()
    shape[[i for i in range(v.dim()) if i not in axes][0]] = -1
    return g.view(shape) * v / norm


def _reflect_left(x, pad: int):
    """Reflect-pad the last axis by ``pad`` on the left as ``jnp.pad(...,
    mode="reflect")`` does, also where ``pad`` reaches the length: in steps
    of at most length - 1, each reflecting the array padded so far (HF
    zero-extends such a short input instead, ROADMAP C.2)."""
    if pad and x.shape[-1] == 1:        # numpy reflects one sample into copies
        return F.pad(x, (pad, 0), mode="replicate")
    while pad > 0:
        step = min(pad, x.shape[-1] - 1)
        x = F.pad(x, (step, 0), mode="reflect")
        pad -= step
    return x


class CausalConv1d(nn.Module):
    """EnCodec's causal conv: ``weight_v`` [C_out, C_in, k], ``weight_g``
    [C_out]; [B, C_in, L] -> [B, C_out, frames]."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(c_out, c_in, kernel))
        self.weight_g = nn.Parameter(torch.ones(c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.kernel, self.stride, self.dilation = kernel, stride, dilation

    def forward(self, x):
        k_eff = (self.kernel - 1) * self.dilation + 1
        pad_total = k_eff - self.stride
        L = x.shape[-1]
        n_frames = (L - k_eff + pad_total) / self.stride + 1
        ideal = (math.ceil(n_frames) - 1) * self.stride + k_eff - pad_total
        extra = max(ideal - L, 0)
        x = _reflect_left(x, pad_total)
        if extra:
            x = F.pad(x, (0, extra))
        w = _wn_weight(self.weight_v, self.weight_g, (1, 2))
        return F.conv1d(x, w, self.bias, stride=self.stride, dilation=self.dilation)


class CausalConvTranspose1d(nn.Module):
    """EnCodec's causal transposed conv: ``weight_v`` [C_in, C_out, k],
    ``weight_g`` [C_in] (torch's weight norm of a ConvTranspose1d is per
    input channel); the full output with ``kernel - stride`` samples
    trimmed on the right -> [B, C_out, L * stride]."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(c_in, c_out, kernel))
        self.weight_g = nn.Parameter(torch.ones(c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.kernel, self.stride = kernel, stride

    def forward(self, x):
        w = _wn_weight(self.weight_v, self.weight_g, (1, 2))
        y = F.conv_transpose1d(x, w, self.bias, stride=self.stride)
        trim = self.kernel - self.stride
        return y[..., : y.shape[-1] - trim] if trim else y


class EncodecLSTM(nn.LSTM):
    """``nn.LSTM`` (batch first) over [B, C, T] with a residual skip over
    the whole stack; parameters ``weight_ih_l<n>`` ... as torch names them."""

    def __init__(self, hidden: int, num_layers: int):
        super().__init__(hidden, hidden, num_layers, batch_first=True)

    def forward(self, x):
        h = x.transpose(1, 2)
        out, _ = super().forward(h)
        return (h + out).transpose(1, 2)


class SeanetResnetBlock(nn.Module):
    """ELU -> conv(k_res, dilation) -> ELU -> conv(1), plus a 1x1-conv
    shortcut (the 24 kHz family's ``use_conv_shortcut``)."""

    def __init__(self, dim: int, dilation: int, cfg: EncodecConfig):
        super().__init__()
        hidden = dim // cfg.compress
        self.block_conv1 = CausalConv1d(dim, hidden, cfg.residual_kernel_size,
                                        dilation=dilation)
        self.block_conv2 = CausalConv1d(hidden, dim, 1)
        self.shortcut = CausalConv1d(dim, dim, 1)

    def forward(self, x):
        y = self.block_conv2(F.elu(self.block_conv1(F.elu(x))))
        return self.shortcut(x) + y


class SeanetDecoder(nn.Module):
    """Latents [B, hidden, T] -> waveform [B, audio_channels, T * hop]."""

    def __init__(self, cfg: EncodecConfig):
        super().__init__()
        self.cfg = cfg
        scaling = 2 ** len(cfg.upsampling_ratios)
        nf = cfg.num_filters
        self.conv_in = CausalConv1d(cfg.hidden_size, scaling * nf, cfg.kernel_size)
        self.lstm = EncodecLSTM(scaling * nf, cfg.num_lstm_layers)
        for i, ratio in enumerate(cfg.upsampling_ratios):
            cur = scaling * nf
            self.add_module(f"up{i}", CausalConvTranspose1d(cur, cur // 2, ratio * 2, ratio))
            for j in range(cfg.num_residual_layers):
                self.add_module(f"res{i}_{j}", SeanetResnetBlock(
                    cur // 2, cfg.dilation_growth_rate ** j, cfg))
            scaling //= 2
        self.conv_out = CausalConv1d(nf, cfg.audio_channels, cfg.last_kernel_size)

    def forward(self, z):
        cfg = self.cfg
        x = self.lstm(self.conv_in(z))
        for i in range(len(cfg.upsampling_ratios)):
            x = getattr(self, f"up{i}")(F.elu(x))
            for j in range(cfg.num_residual_layers):
                x = getattr(self, f"res{i}_{j}")(x)
        return self.conv_out(F.elu(x))


class SeanetEncoder(nn.Module):
    """Waveform [B, audio_channels, L] -> latents [B, hidden, L / hop]."""

    def __init__(self, cfg: EncodecConfig):
        super().__init__()
        self.cfg = cfg
        nf, scaling = cfg.num_filters, 1
        self.conv_in = CausalConv1d(cfg.audio_channels, nf, cfg.kernel_size)
        for i, ratio in enumerate(reversed(cfg.upsampling_ratios)):
            cur = scaling * nf
            for j in range(cfg.num_residual_layers):
                self.add_module(f"res{i}_{j}", SeanetResnetBlock(
                    cur, cfg.dilation_growth_rate ** j, cfg))
            self.add_module(f"down{i}", CausalConv1d(cur, cur * 2, ratio * 2, stride=ratio))
            scaling *= 2
        self.lstm = EncodecLSTM(scaling * nf, cfg.num_lstm_layers)
        self.conv_out = CausalConv1d(scaling * nf, cfg.hidden_size, cfg.last_kernel_size)

    def forward(self, wav):
        cfg = self.cfg
        x = self.conv_in(wav)
        for i in range(len(cfg.upsampling_ratios)):
            for j in range(cfg.num_residual_layers):
                x = getattr(self, f"res{i}_{j}")(x)
            x = getattr(self, f"down{i}")(F.elu(x))
        return self.conv_out(F.elu(self.lstm(x)))


class ResidualVQ(nn.Module):
    """Euclidean codebooks ``embed`` [n_q, K, D]."""

    def __init__(self, cfg: EncodecConfig):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(cfg.num_quantizers, cfg.codebook_size,
                                              cfg.hidden_size))

    def decode(self, codes):
        """[B, n_q, T] int -> [B, T, D]: the sum of the codebook lookups."""
        return sum(F.embedding(codes[:, q].long(), self.embed[q])
                   for q in range(codes.shape[1]))

    def encode(self, z, n_q: int):
        """[B, T, D] -> [B, n_q, T] int64: each residual's nearest code."""
        residual, out = z, []
        for q in range(n_q):
            emb = self.embed[q]                                      # [K, D]
            d = ((residual * residual).sum(-1, keepdim=True) - 2.0 * residual @ emb.t()
                 + (emb * emb).sum(-1)[None, None, :])
            idx = torch.argmin(d, dim=-1)                            # [B, T]
            out.append(idx)
            residual = residual - emb[idx]
        return torch.stack(out, dim=1)


class EncodecModel(nn.Module):
    """``decode_codes``: RVQ codes -> waveform; ``encode``: waveform -> RVQ
    codes.  ``codes`` [B, n_q, T]: n_q <= num_quantizers picks the
    bandwidth (the HF quantizer's slicing)."""

    def __init__(self, cfg: EncodecConfig):
        super().__init__()
        self.cfg = cfg
        self.quantizer = ResidualVQ(cfg)
        self.decoder = SeanetDecoder(cfg)
        self.encoder = SeanetEncoder(cfg)

    def forward(self, codes):
        return self.decode_codes(codes)

    def decode_codes(self, codes):
        """[B, n_q, T] -> waveform [B, T * hop_length] f32."""
        z = self.quantizer.decode(codes)
        return self.decoder(z.transpose(1, 2))[:, 0]

    def encode(self, wav, n_q: int = 0):
        """[B, L] waveform -> [B, n_q, L / hop] int64 codes (0: every
        quantizer)."""
        z = self.encoder(wav.float()[:, None, :]).transpose(1, 2)
        return self.quantizer.encode(z, n_q or self.cfg.num_quantizers)


def init_encodec(cfg: EncodecConfig, generator: torch.Generator = None,
                 device="cuda") -> EncodecModel:
    """An ``EncodecModel`` with random weights from ``generator`` (CPU,
    seeded 0 when None) after the JAX initialisers: ``weight_v`` and the
    LSTM matrices normal(0.05), ``weight_g`` the norm of ``weight_v`` (so
    the weight is ``weight_v``), zero biases, codebooks normal(1); on
    ``device`` in eval mode."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = EncodecModel(cfg)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (CausalConv1d, CausalConvTranspose1d)):
                mod.weight_v.normal_(0.0, 0.05, generator=generator)
                mod.weight_g.copy_(mod.weight_v.pow(2).sum((1, 2)).sqrt())
            elif isinstance(mod, EncodecLSTM):
                for name, p in mod.named_parameters():
                    if name.startswith("weight"):
                        p.normal_(0.0, 0.05, generator=generator)
                    else:
                        p.zero_()
        model.quantizer.embed.normal_(0.0, 1.0, generator=generator)
    return model.to(dev).eval()
