"""VATLM: visual-audio-text pretraining (AV-HuBERT-style masked prediction).

Port of ``speecht5_tpu/models/vatlm.py`` (reference VATLM/vat_hubert/
vathubert/models/vathubert.py:338-850 and models/resnet.py):

- per-modality fronts: audio = a projection of the stacked log-fbank
  features; video = ``VideoFrontend`` (a 3-D stem conv (5,7,7)/(1,2,2),
  BatchNorm, ReLU, a 3x3/2 max-pool, ResNet ``BasicBlock`` stages per
  frame, a spatial mean); phone = embedding + a "SAME" conv, padded or cut
  to the audio / video length;
- ``fuse_features``: missing modalities are zeros; train-time modality
  dropout zeroes all audio (or video) from two draws (``modality_drop``,
  else drawn); channel concat [audio, video, phone] or add; LayerNorm (f32)
  and the projection to d_model;
- ``forward_pretrain``: the HuBERT time masks (``masks``, else drawn), the
  encoder, and cosine logits per label set (``untie_final_proj`` splits the
  projection over ``label_embs_concat``);
- the ASR fine-tune surface: ``encode_av`` + the text decoder tied to
  ``embed_tokens`` (``ASRDecoder(encode_method="encode_av")``).

flax conventions kept: the layout is channels-last ([B, T, H, W, 1] video,
[..., C] features); a strided "SAME" conv or pool pads
``max((ceil(n/s)-1)*s + k - n, 0)`` split ``total//2`` left and the rest
right (the stem at 88 pads (2, 3), not torch's (3, 3)), explicitly with
``F.pad`` before a ``padding=0`` conv, and the max-pool pads with -inf;
BatchNorm is ``postnets.BatchNorm32`` (flax's biased variance, momentum
0.9), so the running statistics after a train pass equal JAX's
``batch_stats``.  Submodule names follow the JAX tree
(``utils/convert.vatlm_from_jax_params``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import MaskingConfig, RelPosConfig, TransformerConfig
from ..ops.heads import cosine_logits
from ..ops.masking import apply_feature_masks, sample_feature_masks
from ..utils.device import resolve_device
from ..utils.masks import length_mask
from .common import Dense, LayerNorm32, SameConvNd, init_weights, same_pads
from .encoder import TransformerEncoder
from .fastspeech2 import SameConv1d
from .postnets import BatchNorm32
from .speechlm import text_masking
from .yitrans import TiedTextDecoder


@dataclass(frozen=True)
class VATLMConfig:
    encoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(num_layers=12))
    decoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(num_layers=6, use_rel_pos_bias=False))
    masking: MaskingConfig = field(
        default_factory=lambda: MaskingConfig(mask_prob=0.8, mask_length=10))
    audio_feat_dim: int = 104        # 26-dim fbank x 4-frame stacking
    video_size: int = 88             # input crop (square)
    resnet_widths: Tuple[int, ...] = (64, 128, 256, 512)
    resnet_blocks: int = 2           # BasicBlocks per stage (ResNet-18)
    num_classes: Tuple[int, ...] = (1000,)   # km label-set sizes
    phone_vocab_size: int = 0        # 0 = no phone branch
    phone_conv_kernel: int = 3
    vocab_size: int = 1000           # text vocab for the ASR fine-tune
    pad_id: int = 1
    eos_id: int = 2
    blank_id: int = 4
    final_dim: int = 256
    logit_temp: float = 0.1
    untie_final_proj: bool = True
    modality_fuse: str = "concat"    # concat | add
    modality_dropout: float = 0.0
    audio_dropout: float = 0.0
    max_text_positions: int = 1024
    dtype: str = "float32"

    @property
    def d_model(self):
        return self.encoder.d_model

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def vatlm_tiny(**kw) -> VATLMConfig:
    enc = TransformerConfig(
        d_model=64, ffn_dim=128, num_layers=2, num_heads=4,
        dropout=0.0, attention_dropout=0.0, rel_pos=RelPosConfig(max_distance=16))
    cfg = VATLMConfig(
        encoder=enc, decoder=dataclasses.replace(enc, use_rel_pos_bias=False),
        audio_feat_dim=26, video_size=16, resnet_widths=(8, 16),
        resnet_blocks=1, num_classes=(20,), phone_vocab_size=30,
        vocab_size=40, final_dim=16, max_text_positions=64)
    return dataclasses.replace(cfg, **kw)


class BasicBlock(nn.Module):
    """ResNet BasicBlock (reference resnet.py; JAX :106-135):
    conv-BN-relu-conv-BN + the residual, projected by a 1x1 conv (no
    BatchNorm) where the width or the stride changes."""

    def __init__(self, c_in: int, features: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = SameConvNd(c_in, features, (3, 3), (stride, stride), dtype)
        self.bn1 = BatchNorm32(features)
        self.conv2 = SameConvNd(features, features, (3, 3), (1, 1), dtype)
        self.bn2 = BatchNorm32(features)
        self.downsample = (SameConvNd(c_in, features, (1, 1), (stride, stride), dtype)
                           if c_in != features or stride != 1 else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)).to(self.dtype))
        y = self.bn2(self.conv2(y)).to(self.dtype)
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class VideoFrontend(nn.Module):
    """3-D stem + ResNet trunk + spatial mean (JAX :138-166): video [B, T,
    H, W, 1] -> [B, T, widths[-1]] in ``dtype``.  BatchNorm uses the batch
    statistics and updates its running ones in training mode."""

    def __init__(self, cfg: VATLMConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        w = cfg.resnet_widths
        self.stem3d = SameConvNd(1, w[0], (5, 7, 7), (1, 2, 2), dtype)
        self.stem_bn = BatchNorm32(w[0])
        c_in = w[0]
        for s, width in enumerate(w):
            for b in range(cfg.resnet_blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                self.add_module(f"stage{s}_block{b}", BasicBlock(c_in, width, stride, dtype))
                c_in = width
        self.blocks = [f"stage{s}_block{b}" for s in range(len(w))
                       for b in range(cfg.resnet_blocks)]

    def forward(self, video):
        x = F.relu(self.stem_bn(self.stem3d(video)).to(self.dtype))
        B, T, H, W, C = x.shape
        x = x.reshape(B * T, H, W, C).movedim(-1, 1)        # per-frame 2-D trunk
        ph, pw = same_pads(H, 3, 2), same_pads(W, 3, 2)
        x = F.max_pool2d(F.pad(x, (*pw, *ph), value=-math.inf), 3, 2).movedim(1, -1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.mean(dim=(1, 2)).reshape(B, T, -1)


class VATLMModel(TiedTextDecoder):
    def __init__(self, cfg: VATLMConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        d = cfg.d_model
        self.audio_proj = Dense(cfg.audio_feat_dim, d, dt)
        self.video_frontend = VideoFrontend(cfg, dt)
        self.video_proj = Dense(cfg.resnet_widths[-1], d, dt)
        if cfg.phone_vocab_size:
            self.phone_embed = nn.Embedding(cfg.phone_vocab_size, d)
            self.phone_conv = SameConv1d(d, d, cfg.phone_conv_kernel, dt)
        embed = d * 3 if cfg.modality_fuse == "concat" else d
        self.fuse_norm = LayerNorm32(embed, eps=1e-6)
        self.post_extract_proj = Dense(embed, d, dt) if embed != d else None
        self.mask_emb = nn.Parameter(torch.empty(d))
        self.encoder = TransformerEncoder(cfg.encoder, dtype=dt)
        n_sets = len(cfg.num_classes) if cfg.untie_final_proj else 1
        self.final_proj = nn.Linear(d, cfg.final_dim * n_sets)
        self.label_embs_concat = nn.Parameter(torch.empty(sum(cfg.num_classes),
                                                          cfg.final_dim))
        self._build_text_decoder(cfg, dt)

    # ------------------------------------------------------------ frontends

    def _phone_features(self, phone_tokens, T: int):
        x = self.phone_conv(self.phone_embed(phone_tokens).to(self.cfg.compute_dtype))
        if x.shape[1] >= T:
            return x[:, :T]
        return F.pad(x, (0, 0, 0, T - x.shape[1]))

    def fuse_features(self, audio=None, video=None, lengths=None, phone_tokens=None, *,
                      modality_drop=None, generator=None):
        """Per-modality features -> (fused [B, T, D], valid [B, T]) (JAX
        :217-260).  ``modality_drop``: the two draws (drop, drop_audio) of
        a training pass with ``modality_dropout`` > 0, else drawn from
        ``generator``."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        src = next(x for x in (audio, video, phone_tokens) if x is not None)
        B, T = src.shape[:2]
        zeros = lambda: torch.zeros(B, T, cfg.d_model, dtype=dt, device=src.device)
        fa = self.audio_proj(audio) if audio is not None else zeros()
        fv = self.video_proj(self.video_frontend(video)) if video is not None else zeros()
        fp = (self._phone_features(phone_tokens, T)
              if cfg.phone_vocab_size and phone_tokens is not None else zeros())
        if self.training and cfg.modality_dropout > 0:
            if modality_drop is None:
                u = torch.rand(2, generator=generator)
                modality_drop = (bool(u[0] < cfg.modality_dropout),
                                 bool(u[1] < cfg.audio_dropout))
            drop, drop_audio = modality_drop
            if drop and drop_audio:
                fa = torch.zeros_like(fa)
            elif drop:
                fv = torch.zeros_like(fv)
        fused = torch.cat([fa, fv, fp], -1) if cfg.modality_fuse == "concat" else fa + fv + fp
        fused = self.fuse_norm(fused).to(dt)
        if self.post_extract_proj is not None:
            fused = self.post_extract_proj(fused)
        valid = (length_mask(lengths.to(src.device), T) if lengths is not None
                 else torch.ones(B, T, dtype=torch.bool, device=src.device))
        return fused, valid

    # ------------------------------------------------------------- pretrain

    def forward_pretrain(self, audio=None, video=None, lengths=None, *, phone_tokens=None,
                         mask: bool = True, masks=None, modality_drop=None, generator=None):
        """(JAX :264-294) -> dict(logits: one [B, T, C_i] f32 per label set,
        time_mask, valid_mask, enc)."""
        cfg = self.cfg
        x, valid = self.fuse_features(audio, video, lengths, phone_tokens,
                                      modality_drop=modality_drop, generator=generator)
        time_mask = None
        if mask and cfg.masking.mask_prob > 0:
            if masks is None:
                masks = sample_feature_masks(valid.sum(-1).cpu(), x.shape[1], x.shape[-1],
                                             text_masking(cfg.masking), generator)
            time_mask = masks[0].to(x.device)
            x = apply_feature_masks(x, time_mask, self.mask_emb)
        enc = self.encoder(x, valid, generator=generator)
        proj = self.final_proj(enc["encoder_out"].float())
        n = len(cfg.num_classes)
        projs = proj.chunk(n, dim=-1) if cfg.untie_final_proj else [proj] * n
        embs = self.label_embs_concat.split(list(cfg.num_classes))
        logits = [cosine_logits(p, e, cfg.logit_temp) for p, e in zip(projs, embs)]
        return {"logits": logits, "time_mask": time_mask, "valid_mask": valid, "enc": enc}

    # ------------------------------------------------------- ASR fine-tune

    def encode_av(self, audio=None, video=None, lengths=None, *, generator=None):
        x, valid = self.fuse_features(audio, video, lengths, generator=generator)
        return self.encoder(x, valid, generator=generator)

    def forward_asr(self, audio, video, lengths, prev_tokens, *, generator=None):
        """-> (logits [B, L, V] f32, encoder valid mask)."""
        enc = self.encode_av(audio, video, lengths, generator=generator)
        return self.decode_text(enc, prev_tokens), enc["valid_mask"]


def init_vatlm(cfg: VATLMConfig, generator: torch.Generator = None,
               device="cuda") -> VATLMModel:
    """A ``VATLMModel`` with random weights from ``generator``, on
    ``device`` in eval mode."""
    dev = resolve_device(device)
    model = VATLMModel(cfg)
    init_weights(model, generator)
    return model.to(dev).eval()
