"""SpeechT5 model, speech-to-text.

Port of the parts of ``speecht5_tpu/models/speecht5.py`` that the CTC
serving path and the s2t train step run: ``encode_speech`` (:140-172),
``decode_text`` and ``_text_logits`` (:180-200), ``ctc_logits`` (:301) and
``forward_s2t`` (:327-334).  The speech decoder, the text encoder prenet
and the other task heads arrive with their slices.  Submodule names follow
the JAX tree, so ``utils/convert.from_jax_params`` maps one onto the other.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import SpeechT5Config
from ..utils.device import resolve_device
from .decoder import TransformerDecoder
from .encoder import TransformerEncoder
from .postnets import TextDecoderPostnet
from .prenets import SpeechEncoderPrenet, TextDecoderPrenet


class SpeechT5Model(nn.Module):
    def __init__(self, cfg: SpeechT5Config):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.speech_encoder_prenet = SpeechEncoderPrenet(cfg, dt)
        self.encoder = TransformerEncoder(
            cfg.encoder, ctc_vocab_size=cfg.vocab_size, dtype=dt)
        self.decoder = TransformerDecoder(cfg.decoder, dtype=dt)
        self.text_decoder_prenet = TextDecoderPrenet(cfg, dt)
        self.text_decoder_postnet = TextDecoderPostnet(cfg)

    def encode_speech(self, wav, wav_lengths, *, mask: bool = False,
                      with_ctc: bool = False, generator=None):
        """wav: [B, T] f32 raw 16 kHz; wav_lengths: [B] int ->
        dict(encoder_out [B, frames, D], valid_mask [B, frames][, ctc_logits]).
        Dropout, layerdrop and (with ``mask``) HuBERT masking run on training
        passes; ``generator`` is the CPU generator of the host-side draws."""
        x, valid = self.speech_encoder_prenet(wav, wav_lengths, mask=mask,
                                              generator=generator)
        return self.encoder(x, valid, with_ctc=with_ctc, generator=generator)

    def decode_text(self, enc, prev_tokens):
        """Teacher-forced text decode -> f32 logits [B, T, V]."""
        x, self_valid = self.text_decoder_prenet(prev_tokens)
        feats = self.decoder(x, enc["encoder_out"], enc_valid=enc["valid_mask"],
                             self_valid=self_valid)
        return self._text_logits(feats)

    def _text_logits(self, feats):
        emb = (self.text_decoder_prenet.embed_tokens.weight
               if self.cfg.share_input_output_embed else None)
        return self.text_decoder_postnet(feats, emb)

    def ctc_logits(self, enc):
        return self.encoder.ctc_head(enc["encoder_out"])

    def forward_s2t(self, wav, wav_lengths, prev_tokens, *, mask: bool = True,
                    generator=None):
        """ASR training forward -> (dec_logits [B, T, V], ctc_logits [B,
        frames, V], enc_valid [B, frames]).  Stochastic parts follow
        ``self.training``, as ``deterministic=not training`` in JAX."""
        enc = self.encode_speech(wav, wav_lengths, mask=mask, with_ctc=True,
                                 generator=generator)
        logits = self.decode_text(enc, prev_tokens)
        return logits, enc["ctc_logits"], enc["valid_mask"]


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
                if mod.bias is not None:
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
