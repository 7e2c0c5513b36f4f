"""FastText2Unit: the non-autoregressive phoneme -> unit tokenizer of
SpeechLM-P.

Port of ``speecht5_tpu/models/fastspeech2.py`` (reference SpeechLM/
speechlm/models/fasttext2unit.py:23-226 on fairseq's FastSpeech2Encoder):
phoneme embedding + fairseq sinusoidal positions -> FFT blocks
(self-attention and a conv FFN, post-LN residuals) -> the duration
predictor on log(dur + 1) -> the length regulator -> decoder FFT blocks ->
unit logits.  The regulator is a static-shape gather: frame t reads the
position ``searchsorted(cumsum(dur), t, right)``, clamped to T - 1, into a
``max_target_len`` buffer with a validity mask.  The self-attention takes
no rel-pos band and so no kernel, on both sides.  flax conventions kept:
LayerNorm epsilon 1e-6, ``padding="SAME"`` convs (left (k-1)//2, right
k//2), generation's round half to even (``torch.round``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.positional import fairseq_sinusoidal
from ..utils.device import resolve_device
from ..utils.masks import length_mask
from .attention import MultiheadAttention
from .common import Dense, LayerNorm32, init_weights


@dataclass(frozen=True)
class FastText2UnitConfig:
    src_vocab_size: int = 128        # phonemes
    unit_vocab_size: int = 504       # km units
    pad_id: int = 1
    d_model: int = 256
    ffn_dim: int = 1024              # fft_hidden_dim
    fft_kernel_size: int = 9
    encoder_layers: int = 4
    decoder_layers: int = 4
    num_heads: int = 2
    dropout: float = 0.2
    attention_dropout: float = 0.0
    var_pred_hidden_dim: int = 256
    var_pred_kernel_size: int = 3
    var_pred_dropout: float = 0.5
    speaker_embed_dim: int = 0       # 0 = no speaker conditioning
    max_target_len: int = 1024       # the length regulator's buffer
    dtype: str = "float32"

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def fastspeech2_s(**kw) -> FastText2UnitConfig:
    """fasttext2unit_s (reference fasttext2unit.py:137-166)."""
    return dataclasses.replace(FastText2UnitConfig(), **kw)


def fastspeech2_tiny(**kw) -> FastText2UnitConfig:
    cfg = FastText2UnitConfig(
        src_vocab_size=16, unit_vocab_size=12, d_model=32, ffn_dim=64,
        fft_kernel_size=3, encoder_layers=2, decoder_layers=2, num_heads=2,
        dropout=0.0, var_pred_hidden_dim=16, max_target_len=64)
    return dataclasses.replace(cfg, **kw)


class SameConv1d(nn.Conv1d):
    """flax ``nn.Conv(padding="SAME")`` over [B, T, C] in ``dtype``."""

    def __init__(self, c_in: int, c_out: int, k: int, dtype=torch.float32):
        super().__init__(c_in, c_out, k)
        self.compute_dtype = dtype

    def forward(self, x):
        k = self.kernel_size[0]
        dt = self.compute_dtype
        x = F.pad(x.to(dt).transpose(1, 2), ((k - 1) // 2, k // 2))
        return F.conv1d(x, self.weight.to(dt), self.bias.to(dt)).transpose(1, 2)


class FFTBlock(nn.Module):
    """Self-attention + conv FFN, post-LN residuals (fairseq
    fastspeech2.FFTLayer; JAX :84-125)."""

    def __init__(self, cfg: FastText2UnitConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.self_attn = MultiheadAttention(cfg.d_model, cfg.num_heads,
                                            cfg.attention_dropout, dtype=dtype)
        self.layer_norm = LayerNorm32(cfg.d_model, eps=1e-6)
        self.conv1 = SameConv1d(cfg.d_model, cfg.ffn_dim, cfg.fft_kernel_size, dtype)
        self.conv2 = SameConv1d(cfg.ffn_dim, cfg.d_model, cfg.fft_kernel_size, dtype)
        self.ffn_norm = LayerNorm32(cfg.d_model, eps=1e-6)

    def forward(self, x, valid):
        p = self.cfg.dropout
        y = self.self_attn(x, valid)
        x = self.layer_norm(x + F.dropout(y, p, self.training)).to(self.dtype)
        y = self.conv2(torch.relu(self.conv1(x)))
        x = self.ffn_norm(x + F.dropout(y, p, self.training)).to(self.dtype)
        return x * valid[..., None].to(x.dtype)


class VariancePredictor(nn.Module):
    """(conv -> ReLU -> LN -> dropout) x 2 -> linear(1) (fairseq
    fastspeech2.VariancePredictor; JAX :128-151)."""

    def __init__(self, cfg: FastText2UnitConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c_in = cfg.d_model
        for i in range(2):
            self.add_module(f"conv_{i}", SameConv1d(c_in, cfg.var_pred_hidden_dim,
                                                    cfg.var_pred_kernel_size, dtype))
            self.add_module(f"ln_{i}", LayerNorm32(cfg.var_pred_hidden_dim, eps=1e-6))
            c_in = cfg.var_pred_hidden_dim
        self.proj = nn.Linear(cfg.var_pred_hidden_dim, 1)

    def forward(self, x):
        for i in range(2):
            x = torch.relu(getattr(self, f"conv_{i}")(x))
            x = getattr(self, f"ln_{i}")(x).to(self.dtype)
            x = F.dropout(x, self.cfg.var_pred_dropout, self.training)
        return self.proj(x.float())[..., 0]


def length_regulate(x, durations, max_len: int):
    """Expand x [B, T, D] by integer durations [B, T] into a [B, max_len, D]
    buffer (JAX :154-172): out[t] = x[searchsorted(cumsum(dur), t, right)],
    positions past sum(dur) zeroed -> (out, out_lens [B], valid [B,
    max_len])."""
    cum = torch.cumsum(durations, dim=-1)
    t = torch.arange(max_len, device=x.device, dtype=cum.dtype)
    idx = torch.searchsorted(cum.contiguous(), t.expand(cum.shape[0], max_len).contiguous(),
                             right=True)
    idx = torch.clamp_max(idx, x.shape[1] - 1)
    out = torch.take_along_dim(x, idx[..., None], dim=1)
    out_lens = torch.clamp_max(cum[:, -1], max_len)
    valid = length_mask(out_lens, max_len)
    return out * valid[..., None].to(x.dtype), out_lens, valid


class FastText2Unit(nn.Module):
    """Phoneme -> unit NAR model (JAX :175-249).  Layers ``enc_<i>`` /
    ``dec_<i>`` as in the JAX tree."""

    def __init__(self, cfg: FastText2UnitConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.embed_tokens = nn.Embedding(cfg.src_vocab_size, cfg.d_model)
        for i in range(cfg.encoder_layers):
            self.add_module(f"enc_{i}", FFTBlock(cfg, dt))
        for i in range(cfg.decoder_layers):
            self.add_module(f"dec_{i}", FFTBlock(cfg, dt))
        self.duration_predictor = VariancePredictor(cfg, dt)
        self.out_proj = nn.Linear(cfg.d_model, cfg.unit_vocab_size)
        self.spk_proj = (Dense(cfg.speaker_embed_dim, cfg.d_model, dt)
                         if cfg.speaker_embed_dim else None)

    def _layers(self, kind: str, n: int):
        return [getattr(self, f"{kind}_{i}") for i in range(n)]

    def encode(self, src_tokens):
        cfg = self.cfg
        valid = src_tokens != cfg.pad_id
        x = self.embed_tokens(src_tokens).to(cfg.compute_dtype)
        x = x + fairseq_sinusoidal(valid, cfg.d_model).to(x.dtype)
        x = F.dropout(x, cfg.dropout, self.training)
        for layer in self._layers("enc", cfg.encoder_layers):
            x = layer(x, valid)
        return x, valid

    def forward(self, src_tokens, durations=None, spkembs=None, *, d_factor: float = 1.0):
        """-> (f32 logits [B, Lmax, V], out_lens [B], out_valid [B, Lmax],
        log_dur_out [B, T]).  Training passes give the true ``durations``;
        generation uses the predicted ones."""
        cfg = self.cfg
        x, valid = self.encode(src_tokens)
        if self.spk_proj is not None and spkembs is not None:
            x = x + self.spk_proj(spkembs)[:, None, :].to(x.dtype)
        log_dur_out = self.duration_predictor(x)
        if durations is None:
            durations = torch.clamp_min(
                torch.round((torch.exp(log_dur_out) - 1.0) * d_factor), 0.0).to(torch.int32)
        durations = durations * valid.to(durations.dtype)
        y, out_lens, out_valid = length_regulate(x, durations, cfg.max_target_len)
        y = y + (fairseq_sinusoidal(out_valid, cfg.d_model).to(y.dtype)
                 * out_valid[..., None].to(y.dtype))
        for layer in self._layers("dec", cfg.decoder_layers):
            y = layer(y, out_valid)
        return self.out_proj(y.float()), out_lens, out_valid, log_dur_out

    @torch.no_grad()
    def generate(self, src_tokens, spkembs=None, d_factor: float = 1.0):
        """NAR unit generation (eval mode): the argmax over the regulated
        frames -> (units [B, Lmax], out_lens, out_valid)."""
        logits, out_lens, out_valid, _ = self(src_tokens, spkembs=spkembs,
                                              d_factor=d_factor)
        return logits.argmax(-1), out_lens, out_valid


def init_fastspeech2(cfg: FastText2UnitConfig, generator: torch.Generator = None,
                     device="cuda") -> FastText2Unit:
    """A ``FastText2Unit`` with random weights from ``generator``, on
    ``device`` in eval mode."""
    dev = resolve_device(device)
    model = FastText2Unit(cfg)
    init_weights(model, generator)
    return model.to(dev).eval()
