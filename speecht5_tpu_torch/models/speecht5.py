"""SpeechT5 model, speech-to-text encoder side.

Port of the parts of ``speecht5_tpu/models/speecht5.py`` that the CTC
serving path runs: ``encode_speech`` (:140-172) and ``ctc_logits`` (:301).
The decoder, the text and speech-decoder prenets/postnets and the other task
heads arrive with their slices.  Submodule names follow the JAX tree, so
``utils/convert.from_jax_params`` maps one onto the other.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import SpeechT5Config
from ..utils.device import resolve_device
from .encoder import TransformerEncoder
from .prenets import SpeechEncoderPrenet


class SpeechT5Model(nn.Module):
    def __init__(self, cfg: SpeechT5Config):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.speech_encoder_prenet = SpeechEncoderPrenet(cfg, dt)
        self.encoder = TransformerEncoder(
            cfg.encoder, ctc_vocab_size=cfg.vocab_size, dtype=dt)

    def encode_speech(self, wav, wav_lengths, *, with_ctc: bool = False):
        """wav: [B, T] f32 raw 16 kHz; wav_lengths: [B] int ->
        dict(encoder_out [B, frames, D], valid_mask [B, frames][, ctc_logits])."""
        x, valid = self.speech_encoder_prenet(wav, wav_lengths)
        return self.encoder(x, valid, with_ctc=with_ctc)

    def ctc_logits(self, enc):
        return self.encoder.ctc_head(enc["encoder_out"])


def init_model(cfg: SpeechT5Config, generator: torch.Generator = None,
               device="cuda") -> SpeechT5Model:
    """Build a SpeechT5Model with random weights drawn from ``generator``
    (a CPU ``torch.Generator``; seeded 0 when None) and move it to
    ``device`` in eval mode.  Init follows the JAX package's initialisers:
    lecun-normal dense and conv kernels, zero biases, unit norm scales, the
    embedding's variance scaling, normal(0.02) for the weight-normed conv's
    direction and a uniform mask embedding."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = SpeechT5Model(cfg)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                                   generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim),
                                   generator=generator)
        prenet = model.speech_encoder_prenet
        for conv in prenet.feature_extractor.convs:
            _, c_in, k = conv.weight.shape
            conv.weight.normal_(0.0, 1.0 / math.sqrt(c_in * k), generator=generator)
        prenet.pos_conv.weight_v.normal_(0.0, 0.02, generator=generator)
        prenet.mask_emb.uniform_(0.0, 1.0, generator=generator)
    return model.to(dev).eval()
