"""YiTrans: two-stage joint speech/text encoder-decoder pretraining for ST.

Port of ``speecht5_tpu/models/yitrans.py`` (reference YiTrans/
yitrans_iwslt22/models/: pretrain_ed.py:200 stage 1, pretrain_ed_step2.py
:124 stage 2; the fine-tunes finetune_asr.py:115, finetune_mt.py:89,
finetune_st.py:85):

- ``encode_speech``: the HuBERT front (``speechlm.UnitFront``: conv
  features, ``feat_layer_norm``, ``post_extract_proj`` when the conv width
  is not d_model, the time masks, GELU(pos_conv)) -> the encoder with its
  CTC head;
- ``encode_text``: token embeddings + fairseq positions through the *same*
  encoder (MT, and stage 1's denoising);
- ``hubert_logits`` over the km units, ``decode_text`` with the output
  projection tied to ``embed_tokens``, ``init_text_cache`` /
  ``text_decode_step`` (positions from the fairseq table at pad_id + 1 +
  index): the API ``decode/asr.ASRDecoder`` calls, with
  ``encode_method="encode_text"`` for MT;
- ``forward_asr`` / ``forward_st`` / ``forward_mt`` / ``forward_pretrain``.

The HuBERT masks come from a CPU ``torch.Generator`` or are handed in
(``masks``); dropout follows ``self.training``.  Submodule names follow
the JAX tree, so ``utils/convert.yitrans_from_jax_params`` carries its
weights.
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
from .speechlm import UnitFront, text_masking


@dataclass(frozen=True)
class YiTransConfig:
    encoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(num_layers=12))
    decoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(num_layers=12, use_rel_pos_bias=False))
    conv_features: ConvFeatureConfig = field(default_factory=ConvFeatureConfig)
    masking: MaskingConfig = field(default_factory=MaskingConfig)
    vocab_size: int = 32000        # multilingual BPE
    unit_vocab_size: int = 504     # km units for masked speech prediction
    pad_id: int = 1
    eos_id: int = 2
    blank_id: int = 4
    final_dim: int = 256
    logit_temp: float = 0.1
    use_conv_pos: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16
    max_text_positions: int = 1024
    dtype: str = "float32"

    @property
    def d_model(self):
        return self.encoder.d_model

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def yitrans_tiny(**kw) -> YiTransConfig:
    enc = TransformerConfig(
        d_model=64, ffn_dim=128, num_layers=2, num_heads=4,
        dropout=0.0, attention_dropout=0.0, rel_pos=RelPosConfig(max_distance=16))
    cfg = YiTransConfig(
        encoder=enc, decoder=dataclasses.replace(enc, use_rel_pos_bias=False),
        conv_features=ConvFeatureConfig(layers=((32, 10, 5), (32, 8, 4), (64, 4, 4))),
        vocab_size=64, unit_vocab_size=24, final_dim=16,
        conv_pos=16, conv_pos_groups=4, max_text_positions=64)
    return dataclasses.replace(cfg, **kw)


class TiedTextDecoder(nn.Module):
    """The text side YiTrans and VATLM share (JAX yitrans.py:144-178,
    vatlm.py:310-343): ``embed_tokens`` + fairseq positions into the
    decoder, the logits through the embedding matrix (tied, f32).
    Subclasses set ``cfg``, ``embed_tokens``, ``decoder`` and the
    ``step_positions`` buffer (``_build_text_decoder``)."""

    def _build_text_decoder(self, cfg, dtype):
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.decoder = TransformerDecoder(cfg.decoder, dtype=dtype)
        table = fairseq_sinusoidal_table(cfg.pad_id + 2 + cfg.max_text_positions,
                                         cfg.d_model, cfg.pad_id)
        self.register_buffer("step_positions", torch.from_numpy(table), persistent=False)

    def _embed(self, tokens):
        """tokens [B, L] -> (embeddings + positions [B, L, D], valid)."""
        cfg = self.cfg
        valid = tokens != cfg.pad_id
        x = self.embed_tokens(tokens).to(cfg.compute_dtype)
        return x + fairseq_sinusoidal(valid, cfg.d_model, cfg.pad_id).to(x.dtype), valid

    def _tied_logits(self, feats):
        return feats.float() @ self.embed_tokens.weight.float().t()

    def decode_text(self, enc, prev_tokens):
        """Teacher-forced text decode -> f32 logits [B, L, V]."""
        x, self_valid = self._embed(prev_tokens)
        feats = self.decoder(x, enc["encoder_out"], enc_valid=enc["valid_mask"],
                             self_valid=self_valid)
        return self._tied_logits(feats)

    def init_text_cache(self, enc, batch_size: int, max_len: int):
        return self.decoder.init_cache(enc["encoder_out"], batch_size, max_len)

    def text_decode_step(self, tokens_t, cache, *, enc_valid=None, cache_rows=None):
        """tokens_t: [B, 1] -> (f32 logits [B, V], new cache)."""
        cfg = self.cfg
        x = self.embed_tokens(tokens_t).to(cfg.compute_dtype)
        x = x + self.step_positions[cfg.pad_id + 1 + cache["index"]][None, None, :].to(x.dtype)
        feats, new_cache = self.decoder.decode_step(x, cache, enc_valid=enc_valid,
                                                    cache_rows=cache_rows)
        return self._tied_logits(feats)[:, 0], new_cache


class YiTransModel(UnitFront, TiedTextDecoder):
    def __init__(self, cfg: YiTransConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self._build_front(cfg)
        self.encoder = TransformerEncoder(cfg.encoder, ctc_vocab_size=cfg.vocab_size, dtype=dt)
        self._build_text_decoder(cfg, dt)
        self.final_proj = nn.Linear(cfg.d_model, cfg.final_dim)
        self.label_embs = nn.Parameter(torch.empty(cfg.unit_vocab_size, cfg.final_dim))

    # -------------------------------------------------------------- encoders

    def encode_speech(self, wav, wav_lengths, *, mask: bool = False, with_ctc: bool = False,
                      generator=None, masks=None):
        """(JAX :93-115) -> dict(encoder_out, valid_mask, time_mask,
        features_pen[, ctc_logits])."""
        x, valid, time_mask, features_pen = self._front(
            wav, wav_lengths, text_masking(self.cfg.masking), mask=mask, generator=generator,
            masks=masks)
        enc = self.encoder(x, valid, with_ctc=with_ctc, generator=generator)
        enc["time_mask"] = time_mask
        enc["features_pen"] = features_pen
        return enc

    def encode_text(self, tokens, *, generator=None):
        """Tokens through the shared encoder (JAX :117-122)."""
        x, valid = self._embed(tokens)
        return self.encoder(x, valid, generator=generator)

    def hubert_logits(self, enc):
        proj = self.final_proj(enc["encoder_out"].float())
        return cosine_logits(proj, self.label_embs, self.cfg.logit_temp)

    # -------------------------------------------------------- task forwards

    def forward_asr(self, wav, wav_lengths, prev_tokens, *, mask: bool = True,
                    generator=None, masks=None):
        """-> (logits, ctc_logits, encoder valid mask)."""
        enc = self.encode_speech(wav, wav_lengths, mask=mask, with_ctc=True,
                                 generator=generator, masks=masks)
        return self.decode_text(enc, prev_tokens), enc["ctc_logits"], enc["valid_mask"]

    def forward_st(self, wav, wav_lengths, prev_tokens, *, mask: bool = False,
                   generator=None, masks=None):
        enc = self.encode_speech(wav, wav_lengths, mask=mask, generator=generator,
                                 masks=masks)
        return self.decode_text(enc, prev_tokens)

    def forward_mt(self, src_tokens, prev_tokens, *, generator=None):
        return self.decode_text(self.encode_text(src_tokens, generator=generator), prev_tokens)

    def forward_pretrain(self, wav, wav_lengths, noised_tokens, prev_tokens, *,
                         generator=None, masks=None):
        """Stage-1 joint pretraining (JAX :214-231): masked speech
        prediction + text denoising."""
        enc_s = self.encode_speech(wav, wav_lengths, mask=True, generator=generator,
                                   masks=masks)
        return {"speech_logits": self.hubert_logits(enc_s),
                "time_mask": enc_s["time_mask"], "valid_mask": enc_s["valid_mask"],
                "features_pen": enc_s["features_pen"],
                "text_logits": self.forward_mt(noised_tokens, prev_tokens,
                                               generator=generator)}


def init_yitrans(cfg: YiTransConfig, generator: torch.Generator = None,
                 device="cuda") -> YiTransModel:
    """A ``YiTransModel`` with random weights from ``generator``, on
    ``device`` in eval mode."""
    dev = resolve_device(device)
    model = YiTransModel(cfg)
    init_weights(model, generator)
    return model.to(dev).eval()
