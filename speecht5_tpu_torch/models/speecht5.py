"""SpeechT5 model: all six fine-tune tasks (ASR, TTS, VC/SE, SID).

Port of the parts of ``speecht5_tpu/models/speecht5.py`` that the serving
paths and the s2t, t2s, s2s and s2c train steps run: ``encode_speech``
(:140-172, with the SID [CLS] slot and frame shuffle), ``encode_text``
(:174), ``decode_text`` and ``_text_logits`` (:180-200),
``init_text_cache`` and ``text_decode_step`` (:202-214),
``decode_speech`` (:216), ``integrate_spk_embed`` (:244),
``init_speech_cache``, ``speech_decode_step`` and ``postnet_refine``
(:268-297, the TTS / VC decoder's steps), ``ctc_logits`` (:301),
``forward_s2t`` (:327-334), ``forward_t2s`` (:336), ``forward_s2s``
(:344-382), ``_sid_head``, ``forward_s2c`` and ``generate_class``
(:384-432).  The pretraining heads arrive with their slice.  Submodule
names follow the JAX tree, so ``utils/convert.from_jax_params`` maps one
onto the other.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SpeechT5Config
from ..utils.device import resolve_device
from .decoder import TransformerDecoder
from .encoder import TransformerEncoder
from .common import Dense
from .postnets import SpeakerDecoderPostnet, SpeechDecoderPostnet, TextDecoderPostnet
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
        self.speaker_decoder_postnet = (SpeakerDecoderPostnet(cfg.d_model, cfg.sid)
                                        if cfg.sid.num_classes > 0 else None)

    def encode_speech(self, wav, wav_lengths, *, mask: bool = False,
                      with_ctc: bool = False, generator=None,
                      prepend_cls: bool = False, shuffle: bool = False):
        """wav: [B, T] f32 raw 16 kHz; wav_lengths: [B] int ->
        dict(encoder_out [B, frames, D], valid_mask [B, frames][, ctc_logits]).
        Dropout, layerdrop and (with ``mask``) HuBERT masking run on training
        passes; ``generator`` is the CPU generator of the host-side draws.
        ``shuffle`` (SID training): one time permutation shared by the batch,
        drawn from ``generator``, then the valid frames compacted to the
        front (``shuffle_frames``).  ``prepend_cls``: a zero token through
        the text decoder prenet (no dropout), prepended as a valid frame
        (reference speecht5.py:826-828); the encoder builds its band for the
        T + 1 frames."""
        x, valid = self.speech_encoder_prenet(wav, wav_lengths, mask=mask,
                                              generator=generator)
        if shuffle:
            perm = torch.randperm(x.shape[1], generator=generator)
            x, valid = shuffle_frames(x, valid, perm.to(x.device))
        if prepend_cls:
            B = x.shape[0]
            cls, _ = self.text_decoder_prenet(
                torch.zeros((B, 1), dtype=torch.int64, device=x.device), dropout=False)
            x = torch.cat([cls.to(x.dtype), x], dim=1)
            valid = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=x.device),
                               valid], dim=1)
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

    def forward_s2s(self, wav, wav_lengths, prev_mel, tgt_lengths, spkembs=None,
                    src_mel=None, *, generator=None, keep_masks=None):
        """VC / SE training forward -> (before, after, stop_logits, cross
        weights [L, B, H, T_r, frames], enc_valid [B, frames]): enc_valid
        counts the guided-attention loss's encoder lengths in conv frames.
        ``src_mel`` (SE, reference se_decoder_input='source'): the r-thinned
        source fbank replaces ``prev_mel`` as the decoder input.  With
        ``se_predict`` the output is a mask over the source ("masking":
        sigmoid(out) * src), a delta from it ("delta": out - src) or the
        target itself ("target"); it needs r == 1 and ``src_mel`` and raises
        otherwise, as JAX asserts (:365-370)."""
        cfg = self.cfg
        if cfg.se_predict is not None:
            if cfg.reduction_factor != 1:
                raise ValueError("se_predict requires reduction_factor == 1")
            if src_mel is None:
                raise ValueError("se_predict requires the se_decoder_input='source' "
                                 "data path (src_mel)")
        enc = self.encode_speech(wav, wav_lengths, mask=False, generator=generator)
        dec_in = prev_mel if src_mel is None else src_mel
        before, after, stop_logits, attn = self.decode_speech(
            enc, dec_in, tgt_lengths, spkembs, need_attn=True, keep_masks=keep_masks)
        if cfg.se_predict == "masking":
            src = src_mel.float()
            before, after = torch.sigmoid(before) * src, torch.sigmoid(after) * src
        elif cfg.se_predict == "delta":
            before, after = before - src_mel.float(), after - src_mel.float()
        return before, after, stop_logits, attn, enc["valid_mask"]

    def _sid_head(self, enc, target_onehot=None):
        """Pool the encoder or decoder output and apply the speaker postnet
        (JAX :384-407): "encoder", the masked mean; "encoder-cls", frame 0;
        "decoder", one zero vector (the reference zeroes the embedded
        prev_output_tokens) through the teacher-forced decoder, then its
        mean.  -> (f32 logits [B, C], embed [B, E])."""
        cfg = self.cfg
        out, valid = enc["encoder_out"], enc["valid_mask"]
        if cfg.sid.pooling == "encoder":
            m = valid.float()
            pooled = ((out.float() * m[:, :, None]).sum(1)
                      / torch.clamp_min(m.sum(1), 1.0)[:, None])
        elif cfg.sid.pooling == "encoder-cls":
            pooled = out[:, 0]
        else:
            B = out.shape[0]
            x = torch.zeros((B, 1, cfg.decoder.d_model), dtype=cfg.compute_dtype,
                            device=out.device)
            feats = self.decoder(x, out, enc_valid=valid,
                                 self_valid=torch.ones((B, 1), dtype=torch.bool,
                                                       device=out.device))
            pooled = feats.mean(dim=1)
        return self.speaker_decoder_postnet(pooled, target_onehot)

    def forward_s2c(self, wav, wav_lengths, targets=None, *, mask: bool = False,
                    generator=None):
        """SID forward -> (f32 logits [B, C], embed [B, E]).  ``targets``
        [B] class ids: one-hot only for the margin softmaxes, which use it
        on training passes.  The frame shuffle (``sid.shuffle_encoder_input``)
        runs on training passes only."""
        sid = self.cfg.sid
        enc = self.encode_speech(wav, wav_lengths, mask=mask, generator=generator,
                                 prepend_cls=sid.encoder_cls,
                                 shuffle=sid.shuffle_encoder_input and self.training)
        onehot = None
        if targets is not None and sid.softmax_type != "softmax":
            onehot = F.one_hot(targets.long(), sid.num_classes).float()
        return self._sid_head(enc, onehot)

    def generate_class(self, wav, wav_lengths):
        """SID inference (JAX :426-432): argmax class ids [B]; call in eval
        mode."""
        logits, _ = self.forward_s2c(wav, wav_lengths, mask=False)
        return logits.argmax(dim=-1)


def shuffle_frames(x, valid, perm):
    """SID train-time augmentation (JAX :153-156): the frames of every row
    permuted by ``perm`` [T], then the valid frames moved back to the front
    by a stable sort, so that the attention kernels still see a prefix mask
    (frame order stays permuted, padding returns to the right edge).  ->
    (x, valid)."""
    x, valid = x[:, perm], valid[:, perm]
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    x = torch.take_along_dim(x, order[:, :, None], dim=1)
    return x, torch.take_along_dim(valid, order, dim=1)


def init_model(cfg: SpeechT5Config, generator: torch.Generator = None,
               device="cuda") -> SpeechT5Model:
    """Build a SpeechT5Model with random weights drawn from ``generator``
    (a CPU ``torch.Generator``; seeded 0 when None) and move it to
    ``device`` in eval mode.  Init follows the JAX package's initialisers:
    lecun-normal dense and conv kernels, zero biases, unit norm scales, the
    embedding's variance scaling, normal(0.02) for the weight-normed conv's
    direction, a uniform mask embedding, unit ``alpha`` scales, BatchNorm
    statistics of 0 mean and unit variance, and the speaker head's normal
    class matrix (std C^-0.5) and embedding (std E^-0.5)."""
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
        spk = model.speaker_decoder_postnet
        if spk is not None:     # JAX postnets.py:229-243
            w = spk.output_projection.weight
            w.normal_(0.0, w.shape[0] ** -0.5, generator=generator)
            if spk.output_embedding is not None:
                w = spk.output_embedding.weight
                w.normal_(0.0, w.shape[0] ** -0.5, generator=generator)
        postnet = model.speech_decoder_postnet.postnet
        if postnet is not None:
            for i in range(postnet.layers):
                w = getattr(postnet, f"conv_{i}").weight
                _, c_in, k = w.shape
                w.normal_(0.0, 1.0 / math.sqrt(c_in * k), generator=generator)
    return model.to(dev).eval()
