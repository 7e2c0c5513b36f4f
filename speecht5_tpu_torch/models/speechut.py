"""SpeechUT / Speech2S: the hidden-unit bridge encoder-decoder.

Port of ``speecht5_tpu/models/speechut.py`` (reference SpeechUT/speechut/
models/speechut.py:47-785):

- speech (``encode_speech`` / ``forward_speech``): the HuBERT front
  (``speechlm.UnitFront``), the speech encoder, the HuBERT logits over the
  units, embedding mixing (the selected unmasked positions take the unit
  embeddings, :476-497), the unit encoder and the text CTC head;
- units and text: masked unit modeling (``forward_mum``, :670) and paired
  units -> text (``forward_unit_text``): the unit encoder, the text decoder
  and the CTC head;
- decoding: ``decode_text``, ``init_text_cache`` and ``text_decode_step``,
  the API ``decode/asr.ASRDecoder`` calls, so the beam, greedy and rescore
  arms take the model unchanged.  The config exposes ``vocab_size`` (the
  text vocabulary), ``pad_id``, ``eos_id``, ``blank_id`` and ``unk_id``.

Random draws come from a CPU ``torch.Generator`` or are handed in
(``masks``, ``mix_sel``); dropout follows ``self.training``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch
from torch import nn

from ..config import ConvFeatureConfig, MaskingConfig, RelPosConfig, TransformerConfig
from ..ops.heads import cosine_logits
from ..ops.positional import fairseq_sinusoidal, fairseq_sinusoidal_table
from ..utils.device import resolve_device
from .common import init_weights
from .decoder import TransformerDecoder
from .encoder import TransformerEncoder
from .speechlm import UnitFront, mix_selection, text_masking


@dataclass(frozen=True)
class SpeechUTConfig:
    speech_encoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(num_layers=6))
    unit_encoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(num_layers=6))
    decoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(num_layers=6, use_rel_pos_bias=False))
    conv_features: ConvFeatureConfig = field(default_factory=ConvFeatureConfig)
    masking: MaskingConfig = field(default_factory=MaskingConfig)
    unit_vocab_size: int = 504
    text_vocab_size: int = 1000
    pad_id: int = 1
    eos_id: int = 2
    blank_id: int = 4
    final_dim: int = 256
    logit_temp: float = 0.1
    use_conv_pos: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16
    mix_with_unit: bool = True
    add_text_ctc: bool = True
    max_text_positions: int = 600
    dtype: str = "float32"

    @property
    def d_model(self):
        return self.speech_encoder.d_model

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def vocab_size(self):
        return self.text_vocab_size

    @property
    def unk_id(self):
        """The fairseq dictionary's <unk> (the beam's unk penalty)."""
        return 3

    @property
    def decoder_cfg(self):
        return self.decoder


def speechut_tiny(**kw) -> SpeechUTConfig:
    enc = TransformerConfig(
        d_model=64, ffn_dim=128, num_layers=2, num_heads=4,
        dropout=0.0, attention_dropout=0.0, rel_pos=RelPosConfig(max_distance=16))
    cfg = SpeechUTConfig(
        speech_encoder=enc, unit_encoder=enc,
        decoder=dataclasses.replace(enc, use_rel_pos_bias=False),
        conv_features=ConvFeatureConfig(layers=((32, 10, 5), (32, 8, 4), (64, 4, 4))),
        unit_vocab_size=24, text_vocab_size=20, final_dim=16,
        conv_pos=16, conv_pos_groups=4, max_text_positions=64)
    return dataclasses.replace(cfg, **kw)


class _TextPrenet(nn.Module):
    """Embedding + fairseq positions for the text decoder (JAX :96-126);
    ``step`` reads row pad_id + 1 + position of a table of pad_id + 2 +
    max_positions rows."""

    def __init__(self, vocab_size: int, d_model: int, pad_id: int, max_positions: int,
                 dtype=torch.float32):
        super().__init__()
        self.pad_id = pad_id
        self.d_model = d_model
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(vocab_size, d_model)
        table = fairseq_sinusoidal_table(pad_id + 2 + max_positions, d_model, pad_id)
        self.register_buffer("step_positions", torch.from_numpy(table), persistent=False)

    def forward(self, tokens):
        valid = tokens != self.pad_id
        x = self.embed_tokens(tokens).to(self.dtype)
        return x + fairseq_sinusoidal(valid, self.d_model, self.pad_id).to(self.dtype), valid

    def step(self, tokens_t, position):
        """tokens_t [B, 1]; position: int or 0-d tensor -> [B, 1, D]."""
        x = self.embed_tokens(tokens_t).to(self.dtype)
        return x + self.step_positions[self.pad_id + 1 + position][None, None, :].to(self.dtype)


class SpeechUTModel(UnitFront):
    def __init__(self, cfg: SpeechUTConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self._build_front(cfg)
        self.encoder = TransformerEncoder(cfg.speech_encoder, dtype=dt)
        self.unit_encoder = TransformerEncoder(cfg.unit_encoder, dtype=dt)
        self.unit_embed_tokens = nn.Embedding(cfg.unit_vocab_size, cfg.d_model)
        self.final_proj = nn.Linear(cfg.d_model, cfg.final_dim)
        self.label_embs = nn.Parameter(torch.empty(cfg.unit_vocab_size, cfg.final_dim))
        self.decoder = TransformerDecoder(cfg.decoder, dtype=dt)
        self.text_prenet = _TextPrenet(cfg.text_vocab_size, cfg.d_model, cfg.pad_id,
                                       cfg.max_text_positions, dt)
        self.output_projection = nn.Linear(cfg.d_model, cfg.text_vocab_size, bias=False)
        self.text_ctc_head = (nn.Linear(cfg.d_model, cfg.text_vocab_size)
                              if cfg.add_text_ctc else None)

    def _hubert_logits(self, h):
        return cosine_logits(self.final_proj(h.float()), self.label_embs, self.cfg.logit_temp)

    # ---------------------------------------------------------------- speech

    def encode_speech(self, wav, wav_lengths, *, mask: bool = False, with_ctc: bool = False,
                      targets=None, generator=None, masks=None, mix_sel=None):
        """The whole stack (JAX :179-238): conv front -> speech encoder ->
        (HuBERT logits and mixing, given ``targets``) -> unit encoder ->
        dict(encoder_out, valid_mask, time_mask, features_pen,
        hubert_logits[, ctc_logits])."""
        cfg = self.cfg
        x, valid, time_mask, features_pen = self._front(
            wav, wav_lengths, text_masking(cfg.masking), mask=mask, generator=generator,
            masks=masks)
        h = self.encoder(x, valid, generator=generator)["encoder_out"]
        hubert_logits = None
        if targets is not None:
            hubert_logits = self._hubert_logits(h)
            if cfg.mix_with_unit:
                if mix_sel is None:
                    mix_sel = mix_selection(valid.sum(-1).cpu(), h.shape[1], cfg.masking,
                                            time_mask, generator)
                ue = self.unit_embed_tokens(targets).to(h.dtype)
                h = torch.where(mix_sel.to(h.device)[:, :, None], ue, h)
        u = self.unit_encoder(h, valid, generator=generator)["encoder_out"]
        out = {"encoder_out": u, "valid_mask": valid, "time_mask": time_mask,
               "features_pen": features_pen, "hubert_logits": hubert_logits}
        if with_ctc and self.text_ctc_head is not None:
            out["ctc_logits"] = self.text_ctc_head(u.float())
        return out

    def forward_speech(self, wav, wav_lengths, targets, *, mask: bool = True,
                       generator=None, masks=None, mix_sel=None):
        return self.encode_speech(wav, wav_lengths, mask=mask, targets=targets,
                                  generator=generator, masks=masks, mix_sel=mix_sel)

    # ------------------------------------------------------------- unit/text

    def forward_mum(self, units, *, generator=None, masks=None):
        """Masked unit modeling on mono units (JAX :250-266) ->
        dict(mum_logits, time_mask, valid_mask)."""
        cfg = self.cfg
        valid = units != cfg.pad_id
        x = self.unit_embed_tokens(units).to(cfg.compute_dtype)
        x, time_mask = self._mask_units(x, valid, generator=generator, masks=masks)
        h = self.unit_encoder(x, valid, generator=generator)["encoder_out"]
        return {"mum_logits": self._hubert_logits(h), "time_mask": time_mask,
                "valid_mask": valid}

    def forward_unit_text(self, units, prev_tokens, *, generator=None):
        """Paired units -> text (JAX :268-281): the unit encoder, the
        decoder's logits and the CTC head -> dict(dec_logits, valid_mask[,
        ctc_logits])."""
        cfg = self.cfg
        valid = units != cfg.pad_id
        x = self.unit_embed_tokens(units).to(cfg.compute_dtype)
        h = self.unit_encoder(x, valid, generator=generator)["encoder_out"]
        out = {"dec_logits": self.decode_text({"encoder_out": h, "valid_mask": valid},
                                              prev_tokens),
               "valid_mask": valid}
        if self.text_ctc_head is not None:
            out["ctc_logits"] = self.text_ctc_head(h.float())
        return out

    # ----------------------------------------------------------------- decode

    def decode_text(self, enc, prev_tokens):
        """Teacher-forced text decode -> f32 logits [B, L, V]."""
        x, self_valid = self.text_prenet(prev_tokens)
        feats = self.decoder(x, enc["encoder_out"], enc_valid=enc["valid_mask"],
                             self_valid=self_valid)
        return self.output_projection(feats.float())

    def init_text_cache(self, enc, batch_size: int, max_len: int):
        return self.decoder.init_cache(enc["encoder_out"], batch_size, max_len)

    def text_decode_step(self, tokens_t, cache, *, enc_valid=None, cache_rows=None):
        """tokens_t: [B, 1] -> (f32 logits [B, V], new cache)."""
        x = self.text_prenet.step(tokens_t, cache["index"])
        feats, new_cache = self.decoder.decode_step(x, cache, enc_valid=enc_valid,
                                                    cache_rows=cache_rows)
        return self.output_projection(feats.float())[:, 0], new_cache


def init_speechut(cfg: SpeechUTConfig, generator: torch.Generator = None,
                  device="cuda") -> SpeechUTModel:
    """A ``SpeechUTModel`` with random weights from ``generator``, on
    ``device`` in eval mode."""
    dev = resolve_device(device)
    model = SpeechUTModel(cfg)
    init_weights(model, generator)
    return model.to(dev).eval()
