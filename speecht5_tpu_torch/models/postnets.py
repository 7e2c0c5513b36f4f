"""Decoder postnets (port of ``speecht5_tpu/models/postnets.py`` :28-147,
:192-270).

- ``TextDecoderPostnet`` (reference text_decoder_postnet.py:19-93):
  decoder features -> f32 vocabulary logits, through its own bias-free
  projection or, with ``share_input_output_embed``, the decoder embedding
  matrix;
- ``SpeechDecoderPostnet`` (reference speech_decoder_postnet.py:17-76):
  ``feat_out`` (d -> n_mels * r) and ``prob_out`` (d -> r) in f32, and the
  Tacotron2 conv postnet whose residual refines the frames;
- ``SpeakerDecoderPostnet`` (reference speaker_decoder_postnet.py:129-200):
  the SID head on the pooled features;
- ``SpeechEncoderPostnet`` (reference speech_encoder_postnet.py:17-124; JAX
  postnets.py:149-189): the HuBERT masked-prediction head.

The postnets' BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9,
epsilon=1e-5, dtype=float32)``: statistics in f32 over every position
but the channel (B x T, padding included); the running statistics move by
``momentum * old + (1 - momentum) * batch`` with the *biased* batch
variance (``nn.BatchNorm1d`` would use torch's momentum convention and the
unbiased variance), on training passes only, as JAX's mutable
``batch_stats``.  ``project_frames``, ``stop_probs`` and ``refine`` arrive
with TTS decoding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SpeechT5Config
from ..ops.heads import cosine_logits
from .common import Dense


class TextDecoderPostnet(nn.Module):
    def __init__(self, cfg: SpeechT5Config):
        super().__init__()
        self.cfg = cfg
        self.output_projection = (
            None if cfg.share_input_output_embed
            else nn.Linear(cfg.d_model, cfg.vocab_size, bias=False))

    def forward(self, x, embed_matrix=None):
        """x: [..., D] -> f32 logits [..., V].  The tied variant needs the
        decoder embedding matrix [V, D]."""
        if self.output_projection is None:
            if embed_matrix is None:
                raise ValueError("share_input_output_embed needs embed_matrix")
            return x.float() @ embed_matrix.float().t()
        return self.output_projection(x.float())


class BatchNorm32(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis of [..., C], computed in f32
    (see the module docstring).  Parameters ``weight`` / ``bias``; buffers
    ``running_mean`` / ``running_var`` (JAX ``batch_stats`` mean / var)."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        """x: [..., C] -> f32 [..., C]."""
        xf = x.float()
        if self.training:
            axes = tuple(range(xf.dim() - 1))
            mean = xf.mean(dim=axes)
            var = ((xf * xf).mean(dim=axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class TacotronPostnet(nn.Module):
    """espnet Tacotron2 postnet: ``layers`` Conv1d (k ``kernel``, "same"
    padding, no bias under BatchNorm) + BatchNorm, tanh after every layer
    but the last, dropout after each on training passes; the caller adds
    the residual.  Blocks ``conv_<i>`` / ``bn_<i>``."""

    def __init__(self, n_mels: int, layers: int, chans: int, kernel: int,
                 dropout: float, use_batch_norm: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.layers = layers
        self.kernel = kernel
        self.dropout = dropout
        self.use_batch_norm = use_batch_norm
        self.dtype = dtype
        for i in range(layers):
            c_in = n_mels if i == 0 else chans
            c_out = n_mels if i == layers - 1 else chans
            conv = nn.Module()
            conv.weight = nn.Parameter(torch.empty(c_out, c_in, kernel))
            if not use_batch_norm:
                conv.bias = nn.Parameter(torch.zeros(c_out))
            self.add_module(f"conv_{i}", conv)
            if use_batch_norm:
                self.add_module(f"bn_{i}", BatchNorm32(c_out))

    def forward(self, x):
        """x: [B, T, n_mels] -> residual [B, T, n_mels] in the compute dtype."""
        pad = (self.kernel - 1) // 2
        dt = self.dtype
        for i in range(self.layers):
            conv = getattr(self, f"conv_{i}")
            x = F.conv1d(x.to(dt).transpose(1, 2), conv.weight.to(dt),
                         None if self.use_batch_norm else conv.bias.to(dt),
                         padding=pad).transpose(1, 2)
            if self.use_batch_norm:
                x = getattr(self, f"bn_{i}")(x).to(dt)
            if i != self.layers - 1:
                x = torch.tanh(x)
            x = F.dropout(x, self.dropout, self.training)
        return x


class SpeechDecoderPostnet(nn.Module):
    def __init__(self, cfg: SpeechT5Config, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        r = cfg.reduction_factor
        self.feat_out = Dense(cfg.d_model, cfg.n_mels * r, torch.float32)
        self.prob_out = Dense(cfg.d_model, r, torch.float32)
        sp = cfg.speech_postnet
        self.postnet = None
        if sp.postnet_layers > 0:
            self.postnet = TacotronPostnet(
                cfg.n_mels, sp.postnet_layers, sp.postnet_chans, sp.postnet_filts,
                sp.postnet_dropout, sp.use_batch_norm, dtype)

    def forward(self, z):
        """z: [B, T_r, D] decoder features -> (before [B, T_r * r, n_mels],
        after, stop_logits [B, T_r * r]), all f32."""
        cfg = self.cfg
        B, Tr, _ = z.shape
        r = cfg.reduction_factor
        before = self.feat_out(z).reshape(B, Tr * r, cfg.n_mels)
        logits = self.prob_out(z).reshape(B, Tr * r)
        return before, self.refine(before), logits

    def project_frames(self, z):
        """feat_out alone, for the AR decode loop: [B, 1, D] -> [B, r,
        n_mels] f32 (JAX postnets.py:110)."""
        return self.feat_out(z).reshape(z.shape[0], self.cfg.reduction_factor,
                                        self.cfg.n_mels)

    def stop_probs(self, z):
        """sigmoid(prob_out): [B, 1, D] -> [B, r] f32 (JAX postnets.py:116)."""
        return torch.sigmoid(self.prob_out(z).reshape(z.shape[0],
                                                      self.cfg.reduction_factor))

    def refine(self, mel):
        """The conv postnet's residual over a whole mel [B, T, n_mels] -> f32
        (JAX postnets.py:120)."""
        if self.postnet is None:
            return mel
        return mel + self.postnet(mel).float()


class SpeakerDecoderPostnet(nn.Module):
    """x-vector style SID head with an optional AM / AAM margin softmax (JAX
    postnets.py:192-270): optional BatchNorm on the pooled features
    (``bn_pooling``, off with ``no_pooling_bn``), an optional bias-free
    ``output_embedding`` and its BatchNorm (``bn_embedding``, off with
    ``no_embed_postnet``), the class matrix ``output_projection.weight``
    [C, E], and a cosine classifier under a margin softmax or
    ``normalize_postnet``.  The margin and its scale apply only on a
    training pass with a target (reference speaker_decoder_postnet.py
    :16-127).  Names follow fairseq's
    ``speaker_decoder_postnet.{output_embedding,output_projection,
    bn_pooling,bn_embedding}``."""

    def __init__(self, d_model: int, cfg):
        super().__init__()
        self.cfg = cfg
        self.bn_pooling = None if cfg.no_pooling_bn else BatchNorm32(d_model)
        self.output_embedding = self.bn_embedding = None
        if not cfg.no_embed_postnet:
            self.output_embedding = nn.Linear(d_model, cfg.embed_dim, bias=False)
            self.bn_embedding = BatchNorm32(cfg.embed_dim)
        e = d_model if cfg.no_embed_postnet else cfg.embed_dim
        self.output_projection = nn.Module()
        self.output_projection.weight = nn.Parameter(torch.empty(cfg.num_classes, e))

    def forward(self, x, target_onehot=None):
        """x: [B, D] pooled features -> (f32 logits [B, C], embed [B, E])."""
        cfg = self.cfg
        x = x.float()
        if self.bn_pooling is not None:
            x = self.bn_pooling(x)
        embed = x
        if self.output_embedding is not None:
            embed = self.bn_embedding(self.output_embedding(x))
        w = self.output_projection.weight.float()
        use_margin = cfg.softmax_type in ("amsoftmax", "aamsoftmax")
        if not (use_margin or cfg.normalize_postnet):
            return embed @ w.t(), embed
        xn = embed / torch.clamp_min(
            torch.linalg.vector_norm(embed, dim=-1, keepdim=True), 1e-12)
        wn = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=-1, keepdim=True), 1e-12)
        cosine = xn @ wn.t()
        if not (use_margin and target_onehot is not None and self.training):
            return cosine, embed
        t = target_onehot.float()
        if cfg.softmax_type == "amsoftmax":
            return cfg.scale * (cosine - cfg.margin * t), embed
        m = cfg.margin
        th, mm = math.cos(math.pi - m), math.sin(math.pi - m) * m
        sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, 0.0, 1.0))
        phi = cosine * math.cos(m) - sine * math.sin(m)
        if cfg.easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            phi = torch.where(cosine > th, phi, cosine - mm)
        return cfg.scale * (t * phi + (1.0 - t) * cosine), embed


class SpeechEncoderPostnet(nn.Module):
    """The HuBERT head: ``final_proj`` (f32) of the encoder output, then
    per label set the cosine logits against its rows of
    ``label_embs_concat`` at temperature ``logit_temp``; with
    ``untie_final_proj`` each label set reads its own slice of the
    projection."""

    def __init__(self, cfg: SpeechT5Config):
        super().__init__()
        h = cfg.hubert
        self.cfg = h
        self.label_embs_concat = nn.Parameter(torch.empty(sum(h.num_classes), h.final_dim))
        out = h.final_dim * (len(h.num_classes) if h.untie_final_proj else 1)
        self.final_proj = nn.Linear(cfg.d_model, out)

    def forward(self, x):
        """x: [B, T, D] -> list of f32 logits [B, T, C_i], one per label set."""
        h = self.cfg
        proj = self.final_proj(x.float())
        n = len(h.num_classes)
        projs = proj.chunk(n, dim=-1) if h.untie_final_proj else [proj] * n
        embs = self.label_embs_concat.split(list(h.num_classes))
        return [cosine_logits(p, e, h.logit_temp) for p, e in zip(projs, embs)]
