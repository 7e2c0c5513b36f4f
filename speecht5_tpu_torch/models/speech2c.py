"""Speech2C: HuBERT pretraining with a code-predicting transformer decoder.

Port of ``speecht5_tpu/models/speech2c.py`` (reference Speech2C/speech2c/
models/speech2c.py:111, a fairseq HubertModel with a decoder): the
SpeechT5 speech encoder prenet and encoder (with the CTC head), the
HuBERT head over km codes, and a 6-layer transformer decoder that predicts
the deduplicated code sequence (``forward_pretrain``); the ASR fine-tune
runs CTC + CE (``forward_asr``), and the beam is ``decode/asr.ASRDecoder``
over ``encode_speech`` / ``init_text_cache`` / ``text_decode_step``.  The
pretraining loss (JAX ``recipes/speech2c_pretrain.py:88-101``) is
``speech2c_pretrain_loss``.  Submodule names follow the JAX tree, a subset
of SpeechT5's, so ``utils/convert.from_jax_params`` carries its weights.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..config import MaskingConfig, SpeechT5Config, TransformerConfig
from ..train.criterions import hubert_loss, label_smoothed_ce
from ..utils.device import resolve_device
from .common import init_weights
from .decoder import TransformerDecoder
from .encoder import TransformerEncoder
from .postnets import SpeechEncoderPostnet, TextDecoderPostnet
from .prenets import SpeechEncoderPrenet, TextDecoderPrenet


def speech2c_base(**kw) -> SpeechT5Config:
    """Speech2C base: 12-layer encoder, 6-layer decoder over the code
    vocabulary (504 = km codes + specials)."""
    cfg = SpeechT5Config(
        encoder=TransformerConfig(layer_norm_first=False),
        decoder=TransformerConfig(num_layers=6, use_rel_pos_bias=False),
        masking=MaskingConfig(mask_prob=0.80),
        vocab_size=504)
    return dataclasses.replace(cfg, **kw)


class Speech2CModel(nn.Module):
    """The speech -> text surface of ``SpeechT5Model`` (so ``ASRDecoder``
    takes it unchanged) plus ``forward_pretrain``."""

    def __init__(self, cfg: SpeechT5Config):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.speech_encoder_prenet = SpeechEncoderPrenet(cfg, dt)
        self.encoder = TransformerEncoder(cfg.encoder, ctc_vocab_size=cfg.vocab_size, dtype=dt)
        self.decoder = TransformerDecoder(cfg.decoder, dtype=dt)
        self.text_decoder_prenet = TextDecoderPrenet(cfg, dt)
        self.text_decoder_postnet = TextDecoderPostnet(cfg)
        self.speech_encoder_postnet = SpeechEncoderPostnet(cfg)

    def encode_speech(self, wav, wav_lengths, *, mask: bool = False, with_ctc: bool = False,
                      generator=None, masks=None):
        """-> dict(encoder_out, valid_mask, time_mask, features_pen[,
        ctc_logits])."""
        x, valid, time_mask, features_pen = self.speech_encoder_prenet(
            wav, wav_lengths, mask=mask, generator=generator, masks=masks)
        enc = self.encoder(x, valid, with_ctc=with_ctc, generator=generator)
        return {**enc, "time_mask": time_mask, "features_pen": features_pen}

    def _text_logits(self, feats):
        emb = (self.text_decoder_prenet.embed_tokens.weight
               if self.cfg.share_input_output_embed else None)
        return self.text_decoder_postnet(feats, emb)

    def decode_text(self, enc, prev_tokens):
        x, self_valid = self.text_decoder_prenet(prev_tokens)
        feats = self.decoder(x, enc["encoder_out"], enc_valid=enc["valid_mask"],
                             self_valid=self_valid)
        return self._text_logits(feats)

    def init_text_cache(self, enc, batch_size: int, max_len: int):
        return self.decoder.init_cache(enc["encoder_out"], batch_size, max_len)

    def text_decode_step(self, tokens_t, cache, *, enc_valid=None, cache_rows=None):
        x = self.text_decoder_prenet.step(tokens_t, cache["index"])
        feats, new_cache = self.decoder.decode_step(x, cache, enc_valid=enc_valid,
                                                    cache_rows=cache_rows)
        return self._text_logits(feats)[:, 0], new_cache

    def forward_pretrain(self, wav, wav_lengths, code_prev, *, generator=None, masks=None):
        """Joint HuBERT + code seq2seq pretraining (JAX :103-118).
        code_prev: the EOS-shifted deduplicated codes -> dict(hubert_logits,
        dec_logits, time_mask, valid_mask, features_pen)."""
        enc = self.encode_speech(wav, wav_lengths, mask=True, generator=generator,
                                 masks=masks)
        return {"hubert_logits": self.speech_encoder_postnet(enc["encoder_out"]),
                "dec_logits": self.decode_text(enc, code_prev),
                "time_mask": enc["time_mask"], "valid_mask": enc["valid_mask"],
                "features_pen": enc["features_pen"]}

    def forward_asr(self, wav, wav_lengths, prev_tokens, *, mask: bool = True,
                    generator=None, masks=None):
        """ASR fine-tune forward (JAX :120-127) -> (dec_logits, ctc_logits,
        enc_valid)."""
        enc = self.encode_speech(wav, wav_lengths, mask=mask, with_ctc=True,
                                 generator=generator, masks=masks)
        return self.decode_text(enc, prev_tokens), enc["ctc_logits"], enc["valid_mask"]


def speech2c_pretrain_loss(out, km_labels, decoder_targets, pad_id: int, *,
                           label_smoothing: float = 0.0):
    """The Speech2C pretraining loss (JAX recipes/speech2c_pretrain.py
    :88-101; reference criterions/speech2c_criterion.py:42-120): HuBERT
    masked CE over the km labels plus label-smoothed CE of the decoder on
    the code targets -> (loss, metrics hubert, dec_ce (the decoder's
    NLL), loss)."""
    hub, _ = hubert_loss(out["hubert_logits"], [km_labels], out["time_mask"],
                         out["valid_mask"])
    dec, dec_nll = label_smoothed_ce(out["dec_logits"], decoder_targets,
                                     decoder_targets != pad_id, label_smoothing)
    loss = hub + dec
    return loss, {"hubert": hub, "dec_ce": dec_nll, "loss": loss}


def init_speech2c(cfg: SpeechT5Config, generator: torch.Generator = None,
                  device="cuda") -> Speech2CModel:
    """A ``Speech2CModel`` with random weights from ``generator``, on
    ``device`` in eval mode."""
    dev = resolve_device(device)
    model = Speech2CModel(cfg)
    init_weights(model, generator)
    return model.to(dev).eval()
