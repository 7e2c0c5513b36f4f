"""SpeechLM: a HuBERT-style speech encoder under a shared unit encoder.

Port of ``speecht5_tpu/models/speechlm.py`` (reference SpeechLM/speechlm/
models/speechlm.py:46-720):

- speech branch (``forward_speech``): conv feature extractor -> masking ->
  speech encoder -> HuBERT logits over the km units (level 0) ->
  ``convert_embeddings`` (a random subset of the unmasked positions swapped
  for the units' embeddings, "embedding mixing", and the optional l2 tie
  loss) -> unit encoder -> HuBERT logits (level 1);
- unit / text branch (``forward_text``): unit embeddings -> masking -> unit
  encoder -> masked-unit logits and the character CTC head;
- fine-tune surfaces: ``extract_features`` under ``SpeechLMCtc`` (the CTC
  ASR head, reference models/speechlm_ctcasr.py:22-56) and ``SpeechLMS2T``
  (the encoder-decoder ST head, models/speechlm_st.py:93-268).

The speech front (``UnitFront``) is shared with SpeechUT.  The random draws
(the HuBERT time mask, the "mix" span selection) come from a CPU
``torch.Generator`` or are handed in (``masks``, ``mix_sel``), so a test
can give both packages the same draws; dropout follows ``self.training``.
Submodule names follow the JAX tree, so ``utils/convert`` maps one onto
the other.  flax's LayerNorm epsilon is 1e-6 (``feat_layer_norm``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ConvFeatureConfig, MaskingConfig, RelPosConfig, TransformerConfig
from ..ops.heads import cosine_logits
from ..ops.masking import apply_feature_masks, compute_span_mask, sample_feature_masks
from ..ops.positional import fairseq_sinusoidal
from ..utils.device import resolve_device
from ..utils.masks import length_mask
from .common import Dense, LayerNorm32, init_weights
from .decoder import TransformerDecoder
from .encoder import TransformerEncoder
from .prenets import ConvFeatureExtractor, WeightNormConv1d


@dataclass(frozen=True)
class SpeechLMConfig:
    speech_encoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(num_layers=6))
    unit_encoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(num_layers=6))
    conv_features: ConvFeatureConfig = field(default_factory=ConvFeatureConfig)
    masking: MaskingConfig = field(default_factory=MaskingConfig)
    unit_vocab_size: int = 504       # km units (level 0 and the unit encoder's input)
    text_vocab_size: int = 32        # characters of the text CTC head
    pad_id: int = 1
    final_dim: int = 256
    logit_temp: float = 0.1
    use_conv_pos: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16
    mix_with_unit: bool = True       # embedding mixing on the speech branch
    l2_embedding: bool = False
    compute_mum: bool = True         # masked unit modeling on the text branch
    add_text_ctc: bool = True
    dtype: str = "float32"

    @property
    def d_model(self):
        return self.speech_encoder.d_model

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def speechlm_tiny(**kw) -> SpeechLMConfig:
    enc = TransformerConfig(
        d_model=64, ffn_dim=128, num_layers=2, num_heads=4,
        dropout=0.0, attention_dropout=0.0, rel_pos=RelPosConfig(max_distance=16))
    cfg = SpeechLMConfig(
        speech_encoder=enc, unit_encoder=enc,
        conv_features=ConvFeatureConfig(layers=((32, 10, 5), (32, 8, 4), (64, 4, 4))),
        unit_vocab_size=24, text_vocab_size=16, final_dim=16,
        conv_pos=16, conv_pos_groups=4)
    return dataclasses.replace(cfg, **kw)


def text_masking(masking: MaskingConfig) -> MaskingConfig:
    """The masking of a call that JAX makes with the time arguments only
    (no channel mask)."""
    return dataclasses.replace(masking, mask_channel_prob=0.0)


def mix_selection(lengths, T: int, masking: MaskingConfig, time_mask=None,
                  generator=None):
    """The "mix" span selection (JAX speechlm.py:169-174): spans at half
    the mask probability and length over the valid frames, minus the
    masked ones; bool [B, T] on the CPU."""
    sel = compute_span_mask(lengths, T, masking.mask_prob / 2,
                            max(masking.mask_length // 2, 1), generator=generator)
    if time_mask is not None:
        sel = sel & ~time_mask.cpu()
    return sel


class UnitFront(nn.Module):
    """The speech front of SpeechLM and SpeechUT (JAX speechlm.py:139-163,
    speechut.py:179-199): conv features, ``feat_layer_norm``, the
    projection when the conv width is not d_model, HuBERT masking and the
    weight-normed conv positions (no sinusoidal positions, no dropout)."""

    def _build_front(self, cfg):
        dt = cfg.compute_dtype
        self.feature_extractor = ConvFeatureExtractor(cfg.conv_features, dt)
        c_out = cfg.conv_features.out_dim
        self.feat_layer_norm = LayerNorm32(c_out, eps=1e-6)
        self.post_extract_proj = (Dense(c_out, cfg.d_model, dt)
                                  if c_out != cfg.d_model else None)
        self.mask_emb = nn.Parameter(torch.empty(cfg.d_model))
        self.pos_conv = (WeightNormConv1d(cfg.d_model, cfg.conv_pos, cfg.conv_pos_groups, dt)
                         if cfg.use_conv_pos else None)

    def _front(self, wav, wav_lengths, masking, *, mask: bool, generator=None,
               masks=None):
        """-> (x [B, T, D], valid [B, T], time mask or None, features_pen)."""
        cfg = self.cfg
        feats = self.feature_extractor(wav)
        features_pen = feats.float().pow(2).mean()
        T = feats.shape[1]
        frame_lengths = cfg.conv_features.out_length(wav_lengths)
        valid = length_mask(frame_lengths.to(feats.device), T)
        x = self.feat_layer_norm(feats).to(feats.dtype)
        if self.post_extract_proj is not None:
            x = self.post_extract_proj(x)
        time_mask = None
        if mask and masking.mask_prob > 0:
            if masks is None:
                masks = sample_feature_masks(frame_lengths.cpu(), T, x.shape[-1],
                                             masking, generator)
            time_mask, chan_mask = masks
            time_mask = time_mask.to(x.device)
            x = apply_feature_masks(x, time_mask, self.mask_emb,
                                    None if chan_mask is None else chan_mask.to(x.device))
        if self.pos_conv is not None:
            x = x + F.gelu(self.pos_conv(x))
        return x, valid, time_mask, features_pen

    def _mask_units(self, x, valid, *, generator=None, masks=None):
        """HuBERT time masking of unit embeddings (JAX speechlm.py:238-245,
        speechut.py:258-262)."""
        if masks is None:
            masks = sample_feature_masks(valid.sum(-1).cpu(), x.shape[1], x.shape[-1],
                                         text_masking(self.cfg.masking), generator)
        time_mask = masks[0].to(x.device)
        return apply_feature_masks(x, time_mask, self.mask_emb), time_mask


class SpeechLMModel(UnitFront):
    """``heads=False`` builds the stack that ``extract_features`` runs and
    no pretraining head but the label embeddings (no unit embedding,
    projections or CTC head): the parameters of JAX's fine-tune modules,
    whose lazily built heads are never called."""

    def __init__(self, cfg: SpeechLMConfig, heads: bool = True):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self._build_front(cfg)
        self.encoder = TransformerEncoder(cfg.speech_encoder, dtype=dt)
        self.unit_encoder = TransformerEncoder(cfg.unit_encoder, dtype=dt)
        self.label_embs_0 = nn.Parameter(torch.empty(cfg.unit_vocab_size, cfg.final_dim))
        self.label_embs_1 = nn.Parameter(torch.empty(cfg.unit_vocab_size, cfg.final_dim))
        if not heads:
            return
        self.unit_embed_tokens = nn.Embedding(cfg.unit_vocab_size, cfg.d_model)
        self.final_proj_0 = nn.Linear(cfg.d_model, cfg.final_dim)
        self.final_proj_1 = nn.Linear(cfg.d_model, cfg.final_dim)
        self.unit_encoder_ctc_head = (nn.Linear(cfg.d_model, cfg.text_vocab_size)
                                      if cfg.add_text_ctc else None)

    def _logits(self, proj, h, embs):
        return cosine_logits(proj(h.float()), embs, self.cfg.logit_temp)

    def convert_embeddings(self, x, valid, targets=None, time_mask=None, *,
                           mix: bool, generator=None, mix_sel=None):
        """Embedding mixing (JAX :165-184, reference speechlm.py:392-462):
        the selected unmasked positions take the targets' unit embeddings
        (``mix_sel`` as given, else drawn), padding zeroed -> (x, l2 loss)."""
        cfg = self.cfg
        l2_loss = torch.zeros((), device=x.device)
        if cfg.l2_embedding and targets is not None:
            ue = self.unit_embed_tokens(targets).float()
            m = (time_mask if time_mask is not None else valid).float()
            num = (((x.float() - ue) ** 2).mean(-1) * m).sum()
            l2_loss = num / torch.clamp_min(((ue ** 2).sum(-1) * m).sum(), 1e-6)
        if mix and targets is not None:
            if mix_sel is None:
                mix_sel = mix_selection(valid.sum(-1).cpu(), x.shape[1], cfg.masking,
                                        time_mask, generator)
            ue = self.unit_embed_tokens(targets).to(x.dtype)
            x = torch.where(mix_sel.to(x.device)[:, :, None], ue, x)
        return x * valid[:, :, None].to(x.dtype), l2_loss

    def forward_speech(self, wav, wav_lengths, targets=None, *, mask: bool = True,
                       generator=None, masks=None, mix_sel=None):
        """Speech pretraining branch (JAX :188-223).  targets: [B, T] km
        units or None -> dict(features_pen, valid_mask, time_mask,
        speech_out, encoder_out, l2_loss[, logits_0, logits_1])."""
        cfg = self.cfg
        x, valid, time_mask, features_pen = self._front(
            wav, wav_lengths, cfg.masking, mask=mask, generator=generator, masks=masks)
        h = self.encoder(x, valid, generator=generator)["encoder_out"]
        out = {"features_pen": features_pen, "valid_mask": valid,
               "time_mask": time_mask, "speech_out": h}
        if targets is not None:
            out["logits_0"] = self._logits(self.final_proj_0, h, self.label_embs_0)
        mixed, l2_loss = self.convert_embeddings(
            h, valid, targets, time_mask, mix=cfg.mix_with_unit and targets is not None,
            generator=generator, mix_sel=mix_sel)
        uenc = self.unit_encoder(mixed, valid, generator=generator)["encoder_out"]
        out["encoder_out"] = uenc
        out["l2_loss"] = l2_loss
        if targets is not None:
            out["logits_1"] = self._logits(self.final_proj_1, uenc, self.label_embs_1)
        return out

    def forward_text(self, unit_tokens, *, mask: bool = True, generator=None,
                     masks=None):
        """Unit / text branch (JAX :225-258): masked-unit logits and the
        character CTC logits over the unit encoder -> dict(encoder_out,
        valid_mask, time_mask[, mum_logits][, ctc_logits])."""
        cfg = self.cfg
        valid = unit_tokens != cfg.pad_id
        x = self.unit_embed_tokens(unit_tokens).to(cfg.compute_dtype)
        time_mask = None
        if mask and cfg.masking.mask_prob > 0:
            x, time_mask = self._mask_units(x, valid, generator=generator, masks=masks)
        h = self.unit_encoder(x, valid, generator=generator)["encoder_out"]
        out = {"encoder_out": h, "valid_mask": valid, "time_mask": time_mask}
        if cfg.compute_mum:
            out["mum_logits"] = self._logits(self.final_proj_1, h, self.label_embs_1)
        if self.unit_encoder_ctc_head is not None:
            out["ctc_logits"] = self.unit_encoder_ctc_head(h.float())
        return out

    def extract_features(self, wav, wav_lengths):
        """The whole stack without masking or mixing (JAX :260-273) ->
        (unit encoder output [B, T, D], valid [B, T])."""
        x, valid, _, _ = self._front(wav, wav_lengths, self.cfg.masking, mask=False)
        h = self.encoder(x, valid)["encoder_out"]
        mixed, _ = self.convert_embeddings(h, valid, mix=False)
        return self.unit_encoder(mixed, valid)["encoder_out"], valid


class SpeechLMCtc(nn.Module):
    """CTC ASR fine-tune head (JAX :276-293): dropout 0.1 on the features
    on training passes (``keep_mask`` hands in its keep mask), then
    ``ctc_proj`` in f32."""

    HEAD_DROPOUT = 0.1

    def __init__(self, cfg: SpeechLMConfig, ctc_vocab_size: int = 32):
        super().__init__()
        self.cfg = cfg
        self.speechlm = SpeechLMModel(cfg, heads=False)
        self.ctc_proj = nn.Linear(cfg.d_model, ctc_vocab_size)

    def forward(self, wav, wav_lengths, *, keep_mask=None):
        """-> (f32 logits [B, T, V], valid [B, T])."""
        h, valid = self.speechlm.extract_features(wav, wav_lengths)
        if self.training and keep_mask is not None:
            h = torch.where(keep_mask.to(h.device), h / (1.0 - self.HEAD_DROPOUT),
                            torch.zeros((), dtype=h.dtype, device=h.device))
        else:
            h = F.dropout(h, self.HEAD_DROPOUT, self.training)
        return self.ctc_proj(h.float()), valid

    def encode_speech(self, wav, wav_lengths, *, with_ctc: bool = True):
        """The serving surface of ``decode/asr.CTCDecoder``: dict(encoder_out,
        valid_mask, ctc_logits)."""
        h, valid = self.speechlm.extract_features(wav, wav_lengths)
        return {"encoder_out": h, "valid_mask": valid,
                "ctc_logits": self.ctc_proj(h.float())}


class SpeechLMS2T(nn.Module):
    """Seq2seq ST fine-tune (JAX :296-330): the SpeechLM stack, a
    transformer decoder over embedded target tokens with fairseq
    sinusoidal positions, a bias-free output projection."""

    def __init__(self, cfg: SpeechLMConfig, decoder_cfg: TransformerConfig,
                 tgt_vocab_size: int = 1000):
        super().__init__()
        self.cfg = cfg
        self.decoder_cfg = decoder_cfg
        self.speechlm = SpeechLMModel(cfg, heads=False)
        self.decoder = TransformerDecoder(decoder_cfg)
        self.embed_tokens = nn.Embedding(tgt_vocab_size, decoder_cfg.d_model)
        self.output_projection = nn.Linear(decoder_cfg.d_model, tgt_vocab_size, bias=False)

    def forward(self, wav, wav_lengths, prev_tokens):
        """-> (f32 logits [B, L, V], encoder valid [B, T])."""
        h, valid = self.speechlm.extract_features(wav, wav_lengths)
        self_valid = prev_tokens != self.cfg.pad_id
        x = self.embed_tokens(prev_tokens).to(h.dtype)
        x = x + fairseq_sinusoidal(self_valid, self.decoder_cfg.d_model,
                                   self.cfg.pad_id).to(x.dtype)
        feats = self.decoder(x, h, enc_valid=valid, self_valid=self_valid)
        return self.output_projection(feats.float()), valid


def init_speechlm(cfg: SpeechLMConfig, generator: torch.Generator = None,
                  device="cuda", *, ctc_vocab_size: int = None):
    """A ``SpeechLMModel`` (or, with ``ctc_vocab_size``, a ``SpeechLMCtc``)
    with random weights drawn from ``generator`` (``models/common.
    init_weights``), on ``device`` in eval mode."""
    dev = resolve_device(device)
    model = (SpeechLMModel(cfg) if ctc_vocab_size is None
             else SpeechLMCtc(cfg, ctc_vocab_size))
    init_weights(model, generator)
    return model.to(dev).eval()
