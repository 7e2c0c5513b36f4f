"""Prosody-SpeechT5: prosody-aware expressive TTS on the SpeechT5 model
(port of ``speecht5_tpu/models/prosody.py``).

- ``ProsodyEncoder``: a reference mel [B, T, M] (and its lengths) through
  ``n_convs`` stride-2 convs (flax's "SAME" padding, asymmetric at stride
  2: ``SameConvNd``), each with a LayerNorm (flax's epsilon 1e-6) and ReLU,
  the lengths ``(n + 1) // 2`` at each; a mean over the valid frames; a
  tanh projection to the prosody embedding [B, P].
- ``ProsodyPredictor``: the same embedding from the text encoding alone (a
  masked mean, a ReLU layer, a tanh projection); ``forward_t2s`` distils it
  with an L2 loss against the encoder's embedding, gradient stopped.
- The embedding conditions the speech decoder by project-and-add on the
  encoder output: ``encode_text`` (predicted prosody) or
  ``encode_text_ref`` (prosody transfer from a reference); the speech
  decoder's methods pass through, so ``decode/tts.TTSDecoder`` drives the
  model as it is (``encode_text``) or through ``ProsodyTransfer``
  (``encode_text_ref`` on a fixed reference).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..config import SpeechT5Config
from ..utils.device import resolve_device
from .common import Dense, LayerNorm32, SameConvNd, init_weights
from .speecht5 import SpeechT5Model, init_model


@dataclass(frozen=True)
class ProsodyConfig:
    dim: int = 64              # prosody embedding size
    conv_channels: int = 128   # prosody-encoder conv width
    n_convs: int = 3           # stride-2 conv stack depth
    predictor_hidden: int = 256
    pred_loss_weight: float = 1.0


class ProsodyEncoder(nn.Module):
    """Reference mel [B, T, M] (+ lengths) -> utterance prosody [B, P]."""

    def __init__(self, pcfg: ProsodyConfig, n_mels: int, dtype=torch.float32):
        super().__init__()
        self.pcfg, self.dtype = pcfg, dtype
        c_in = n_mels
        for i in range(pcfg.n_convs):
            self.add_module(f"conv{i}", SameConvNd(c_in, pcfg.conv_channels, (3,), (2,),
                                                   dtype, bias=True))
            self.add_module(f"ln{i}", LayerNorm32(pcfg.conv_channels, eps=1e-6))
            c_in = pcfg.conv_channels
        self.out = Dense(pcfg.conv_channels, pcfg.dim, dtype)

    def forward(self, mel, mel_lengths):
        x = mel.to(self.dtype)
        lengths = torch.as_tensor(mel_lengths, device=x.device)
        for i in range(self.pcfg.n_convs):
            x = getattr(self, f"conv{i}")(x)
            x = torch.relu(getattr(self, f"ln{i}")(x).to(self.dtype))
            lengths = (lengths + 1) // 2
        valid = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
        x = torch.where(valid[:, :, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        pooled = x.sum(1) / torch.clamp_min(lengths[:, None].to(x.dtype), 1.0)
        return torch.tanh(self.out(pooled))


class ProsodyPredictor(nn.Module):
    """Text encoding [B, L, D] (+ valid) -> predicted prosody [B, P]."""

    def __init__(self, pcfg: ProsodyConfig, d_model: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(d_model, pcfg.predictor_hidden, dtype)
        self.out = Dense(pcfg.predictor_hidden, pcfg.dim, dtype)

    def forward(self, enc_out, valid):
        x = torch.where(valid[:, :, None], enc_out.to(self.dtype),
                        torch.zeros((), dtype=self.dtype, device=enc_out.device))
        n = torch.clamp_min(valid.sum(-1, keepdim=True).to(self.dtype), 1.0)
        return torch.tanh(self.out(torch.relu(self.fc1(x.sum(1) / n))))


class ProsodySpeechT5(nn.Module):
    """The SpeechT5 ``backbone`` with the prosody encoder, predictor and
    conditioning; ``cfg`` is the backbone's."""

    def __init__(self, cfg: SpeechT5Config, pcfg: ProsodyConfig = ProsodyConfig(),
                 backbone: SpeechT5Model = None):
        super().__init__()
        self.cfg, self.pcfg = cfg, pcfg
        dt = cfg.compute_dtype
        self.backbone = backbone if backbone is not None else SpeechT5Model(cfg)
        self.prosody_encoder = ProsodyEncoder(pcfg, cfg.n_mels, dt)
        self.prosody_predictor = ProsodyPredictor(pcfg, cfg.encoder.d_model, dt)
        self.prosody_proj = Dense(pcfg.dim, cfg.decoder.d_model, dt)

    def _condition(self, enc, prosody):
        return {**enc, "encoder_out": enc["encoder_out"] + self.prosody_proj(prosody)[:, None, :]}

    def forward_t2s(self, tokens, prev_mel, tgt_lengths, spkembs, target_mel, dec_lengths, *,
                    generator=None, keep_masks=None):
        """Teacher-forced prosody-aware TTS, conditioned on the target's own
        prosody -> (before, after, stop_logits, cross weights, pred_loss):
        the TTS tuple of ``criterions.tts_loss`` and the predictor's L2
        distillation loss (weight ``pcfg.pred_loss_weight``)."""
        enc = self.backbone.encode_text(tokens, generator=generator)
        p_ref = self.prosody_encoder(target_mel, dec_lengths)
        p_hat = self.prosody_predictor(enc["encoder_out"], tokens != self.cfg.pad_id)
        pred_loss = ((p_hat.float() - p_ref.detach().float()) ** 2).mean()
        before, after, stop_logits, attn = self.backbone.decode_speech(
            self._condition(enc, p_ref), prev_mel, tgt_lengths, spkembs, need_attn=True,
            keep_masks=keep_masks)
        return before, after, stop_logits, attn, pred_loss

    def encode_text(self, tokens, *, generator=None):
        """The predictor's prosody: expressive TTS with no reference."""
        enc = self.backbone.encode_text(tokens, generator=generator)
        p = self.prosody_predictor(enc["encoder_out"], tokens != self.cfg.pad_id)
        return self._condition(enc, p)

    def encode_text_ref(self, tokens, ref_mel, ref_lengths, *, generator=None):
        """Prosody transfer: the style of a reference utterance."""
        enc = self.backbone.encode_text(tokens, generator=generator)
        return self._condition(enc, self.prosody_encoder(ref_mel, ref_lengths))

    def prosody_embedding(self, ref_mel, ref_lengths):
        return self.prosody_encoder(ref_mel, ref_lengths)

    # the speech decoder, as TTSDecoder drives it
    def integrate_spk_embed(self, enc, spkembs):
        return self.backbone.integrate_spk_embed(enc, spkembs)

    def decode_speech(self, *a, **kw):
        return self.backbone.decode_speech(*a, **kw)

    def init_speech_cache(self, *a, **kw):
        return self.backbone.init_speech_cache(*a, **kw)

    def speech_decode_step(self, *a, **kw):
        return self.backbone.speech_decode_step(*a, **kw)

    def postnet_refine(self, mel):
        return self.backbone.postnet_refine(mel)


class ProsodyTransfer:
    """A ``ProsodySpeechT5`` whose ``encode_text`` is ``encode_text_ref`` on
    one reference mel [1 or B, T, M] and its lengths: hand it to
    ``TTSDecoder`` for prosody transfer."""

    def __init__(self, model: ProsodySpeechT5, ref_mel, ref_lengths):
        self.model, self.ref_mel, self.ref_lengths = model, ref_mel, ref_lengths

    def encode_text(self, tokens, **kw):
        return self.model.encode_text_ref(tokens, self.ref_mel, self.ref_lengths, **kw)

    def __getattr__(self, name):
        return getattr(self.model, name)


def init_prosody_speecht5(cfg: SpeechT5Config, pcfg: ProsodyConfig = ProsodyConfig(),
                          generator: torch.Generator = None,
                          device="cuda") -> ProsodySpeechT5:
    """Random weights: the backbone as ``init_model`` draws it from
    ``generator`` (CPU, seeded 0 when None, or on ``device``: drawn there),
    then the prosody parts (``init_weights``); on ``device`` in eval mode."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = ProsodySpeechT5(cfg, pcfg, backbone=init_model(cfg, generator, dev))
    for part in (model.prosody_encoder, model.prosody_predictor, model.prosody_proj):
        init_weights(part.to(generator.device), generator)
    return model.to(dev).eval()
