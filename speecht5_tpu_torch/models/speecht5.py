"""SpeechT5 model: speech-to-text and text-to-speech.

Port of the parts of ``speecht5_tpu/models/speecht5.py`` that the CTC and
beam serving paths and the s2t and t2s train steps run: ``encode_speech``
(:140-172), ``encode_text`` (:174), ``decode_text`` and ``_text_logits``
(:180-200), ``init_text_cache`` and ``text_decode_step`` (:202-214),
``decode_speech`` (:216), ``integrate_spk_embed`` (:244),
``init_speech_cache``, ``speech_decode_step`` and ``postnet_refine``
(:268-297, the TTS decoder's steps), ``ctc_logits`` (:301),
``forward_s2t`` (:327-334) and ``forward_t2s`` (:336).  The other task
heads arrive with their slices.  Submodule names follow the JAX tree, so
``utils/convert.from_jax_params`` maps one onto the other.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import SpeechT5Config
from ..utils.device import resolve_device
from .decoder import TransformerDecoder
from .encoder import TransformerEncoder
from .common import Dense
from .postnets import SpeechDecoderPostnet, TextDecoderPostnet
from .prenets import (SpeechDecoderPrenet, SpeechEncoderPrenet, TextDecoderPrenet,
                      TextEncoderPrenet)


class SpeechT5Model(nn.Module):
    def __init__(self, cfg: SpeechT5Config):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.speech_encoder_prenet = SpeechEncoderPrenet(cfg, dt)
        self.text_encoder_prenet = TextEncoderPrenet(cfg, dt)
        self.encoder = TransformerEncoder(
            cfg.encoder, ctc_vocab_size=cfg.vocab_size, dtype=dt)
        self.decoder = TransformerDecoder(cfg.decoder, dtype=dt)
        self.text_decoder_prenet = TextDecoderPrenet(cfg, dt)
        self.text_decoder_postnet = TextDecoderPostnet(cfg)
        self.speech_decoder_prenet = SpeechDecoderPrenet(cfg, dt)
        self.speech_decoder_postnet = SpeechDecoderPostnet(cfg, dt)
        self.spkembs_projection = None
        if cfg.spk_embed_dim is not None and cfg.spk_embed_integration != "pre":
            # x-vector integration into the encoder output (JAX :97-105)
            d_in = (cfg.spk_embed_dim if cfg.spk_embed_integration == "add"
                    else cfg.d_model + cfg.spk_embed_dim)
            self.spkembs_projection = Dense(d_in, cfg.d_model, dt)

    def encode_speech(self, wav, wav_lengths, *, mask: bool = False,
                      with_ctc: bool = False, generator=None):
        """wav: [B, T] f32 raw 16 kHz; wav_lengths: [B] int ->
        dict(encoder_out [B, frames, D], valid_mask [B, frames][, ctc_logits]).
        Dropout, layerdrop and (with ``mask``) HuBERT masking run on training
        passes; ``generator`` is the CPU generator of the host-side draws."""
        x, valid = self.speech_encoder_prenet(wav, wav_lengths, mask=mask,
                                              generator=generator)
        return self.encoder(x, valid, with_ctc=with_ctc, generator=generator)

    def encode_text(self, tokens, *, generator=None):
        """tokens: [B, T] (pad_id-padded) -> dict(encoder_out, valid_mask)."""
        x, valid = self.text_encoder_prenet(tokens)
        return self.encoder(x, valid, generator=generator)

    def decode_text(self, enc, prev_tokens):
        """Teacher-forced text decode -> f32 logits [B, T, V]."""
        x, self_valid = self.text_decoder_prenet(prev_tokens)
        feats = self.decoder(x, enc["encoder_out"], enc_valid=enc["valid_mask"],
                             self_valid=self_valid)
        return self._text_logits(feats)

    def init_text_cache(self, enc, batch_size: int, max_len: int):
        """The decoder's cache for ``batch_size`` rows of up to ``max_len``
        positions, cross K/V from ``enc["encoder_out"]`` (untiled)."""
        return self.decoder.init_cache(enc["encoder_out"], batch_size, max_len)

    def text_decode_step(self, tokens_t, cache, *, enc_valid=None,
                         cache_rows=None):
        """tokens_t: [B, 1] -> (f32 logits [B, V], new cache)."""
        x = self.text_decoder_prenet.step(tokens_t, cache["index"])
        feats, new_cache = self.decoder.decode_step(
            x, cache, enc_valid=enc_valid, cache_rows=cache_rows)
        return self._text_logits(feats)[:, 0], new_cache

    def _text_logits(self, feats):
        emb = (self.text_decoder_prenet.embed_tokens.weight
               if self.cfg.share_input_output_embed else None)
        return self.text_decoder_postnet(feats, emb)

    def integrate_spk_embed(self, enc, spkembs):
        """x-vector integration into the encoder output for
        spk_embed_integration "add" | "concat" (L2-normalise, then
        project-and-add or concat-and-project); a no-op for "pre" (the
        speech decoder prenet's) or without an x-vector."""
        cfg = self.cfg
        if spkembs is None or self.spkembs_projection is None:
            return enc
        hs = enc["encoder_out"]
        s = spkembs.float()
        s = (s / torch.clamp_min(torch.linalg.vector_norm(s, dim=-1, keepdim=True),
                                 1e-12)).to(hs.dtype)
        if cfg.spk_embed_integration == "add":
            hs = hs + self.spkembs_projection(s)[:, None, :]
        else:
            s = s[:, None, :].expand(*hs.shape[:2], s.shape[-1])
            hs = self.spkembs_projection(torch.cat([hs, s], dim=-1))
        return {**enc, "encoder_out": hs}

    def decode_speech(self, enc, prev_mel, tgt_lengths=None, spkembs=None, *,
                      need_attn: bool = False, keep_masks=None):
        """Teacher-forced mel decode -> (before, after [B, T_r * r, n_mels],
        stop_logits [B, T_r * r], cross weights [L, B, H, T_r, Tsrc] f32 or
        None).  prev_mel: [B, T_r, n_mels] r-thinned with a zero BOS frame;
        ``keep_masks``: the Tacotron prenet's dropout masks (drawn when
        None)."""
        enc = self.integrate_spk_embed(enc, spkembs)
        x, self_valid = self.speech_decoder_prenet(prev_mel, tgt_lengths, spkembs,
                                                   keep_masks=keep_masks)
        out = self.decoder(x, enc["encoder_out"], enc_valid=enc["valid_mask"],
                           self_valid=self_valid, need_cross_weights=need_attn)
        feats, cross = out if need_attn else (out, None)
        before, after, stop_logits = self.speech_decoder_postnet(feats)
        return before, after, stop_logits, cross

    def init_speech_cache(self, enc, batch_size: int, max_len: int, spkembs=None):
        """The decoder's cache for the AR mel decode, cross K/V from the
        encoder output after the model-level x-vector integration
        (JAX :268)."""
        enc = self.integrate_spk_embed(enc, spkembs)
        return self.decoder.init_cache(enc["encoder_out"], batch_size, max_len)

    def speech_decode_step(self, prev_frame, cache, *, spkembs=None, enc_valid=None,
                           need_attn: bool = False, keep_masks=None, generator=None):
        """One AR mel step (JAX :273).  prev_frame: [B, 1, n_mels], the last
        output frame (zeros at the first step).  The prenet runs on the new
        frame only, at position ``cache["index"]`` (a device tensor: no host
        sync); its Tacotron dropout stays on (ROADMAP C.4), drawn from
        ``generator`` (a device ``torch.Generator``) or taken from
        ``keep_masks``.  -> (frames [B, r, n_mels] f32, stop probabilities
        [B, r] f32, new cache, and with ``need_attn`` every decoder layer's
        largest cross-attention probability over the source [L, B, H] f32,
        what JAX's ``attn.max(-1)`` gives; else None)."""
        x, _ = self.speech_decoder_prenet(prev_frame, None, spkembs,
                                          position_offset=cache["index"],
                                          keep_masks=keep_masks, generator=generator)
        out = self.decoder.decode_step(x, cache, enc_valid=enc_valid,
                                       need_cross_max=need_attn)
        feats, new_cache = out[:2]
        post = self.speech_decoder_postnet
        attn = out[2][..., 0] if need_attn else None
        return post.project_frames(feats), post.stop_probs(feats), new_cache, attn

    def postnet_refine(self, mel):
        """The conv postnet's residual over the whole mel buffer (JAX :296)."""
        return self.speech_decoder_postnet.refine(mel)

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


    def forward_t2s(self, tokens, prev_mel, tgt_lengths, spkembs=None, *,
                    generator=None, keep_masks=None):
        """TTS training forward -> (before, after, stop_logits, cross weights
        [L, B, H, T_r, T_tokens]).  Stochastic parts follow
        ``self.training``, except the Tacotron prenet's dropout, which is
        always on (see ``TacotronPrenet``)."""
        enc = self.encode_text(tokens, generator=generator)
        return self.decode_speech(enc, prev_mel, tgt_lengths, spkembs,
                                  need_attn=True, keep_masks=keep_masks)


def init_model(cfg: SpeechT5Config, generator: torch.Generator = None,
               device="cuda") -> SpeechT5Model:
    """Build a SpeechT5Model with random weights drawn from ``generator``
    (a CPU ``torch.Generator``; seeded 0 when None) and move it to
    ``device`` in eval mode.  Init follows the JAX package's initialisers:
    lecun-normal dense and conv kernels, zero biases, unit norm scales, the
    embedding's variance scaling, normal(0.02) for the weight-normed conv's
    direction, a uniform mask embedding, unit ``alpha`` scales and BatchNorm
    statistics of 0 mean and unit variance."""
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
        postnet = model.speech_decoder_postnet.postnet
        if postnet is not None:
            for i in range(postnet.layers):
                w = getattr(postnet, f"conv_{i}").weight
                _, c_in, k = w.shape
                w.normal_(0.0, 1.0 / math.sqrt(c_in * k), generator=generator)
    return model.to(dev).eval()
