"""Typed configuration tree for the PyTorch port of SpeechT5.

A copy of ``speecht5_tpu/config.py`` that imports no JAX: the same frozen
dataclasses, field names and defaults, so a config built for one package
means the same model in the other.  ``compute_dtype`` maps to a torch dtype.
In the port, ``encoder.use_pallas_attn=True`` and
``conv_features.impl="pallas"`` select the hand-written CUDA kernels of
``ops/cuda_kernels.py`` (the flag names are kept from the JAX package).

Presets mirror the registered fairseq architectures (`t5_transformer_base`,
`t5_transformer_base_asr`, reference speecht5.py:1385-1447).  This slice of
the port carries ``speecht5_base``, ``speecht5_base_asr``,
``speecht5_base_sid`` and ``speecht5_tiny``; the other presets arrive with
the slices that use them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def apply_overrides(cfg, overrides):
    """Apply ``"dotted.path=python_literal"`` strings to a (nested, frozen)
    dataclass config — the CLI's generic access to every config field, in
    place of the reference's ~120 argparse flags (reference
    tasks/speecht5.py:44-270, models/speecht5.py:117-614).

    >>> apply_overrides(cfg, ["sid.encoder_cls=True", "se_predict='masking'"])
    """
    import ast

    for item in overrides:
        path, _, raw = item.partition("=")
        if not _:
            raise ValueError(f"override {item!r} is not of the form path=value")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw  # bare string convenience: se_predict=masking
        keys = path.strip().split(".")
        # rebuild the chain of frozen dataclasses bottom-up
        nodes = [cfg]
        for k in keys[:-1]:
            nodes.append(getattr(nodes[-1], k))
        if not hasattr(nodes[-1], keys[-1]):
            raise AttributeError(
                f"config has no field {path!r} ({type(nodes[-1]).__name__}."
                f"{keys[-1]} missing)"
            )
        updated = dataclasses.replace(nodes[-1], **{keys[-1]: value})
        for node, k in zip(reversed(nodes[:-1]), reversed(keys[:-1])):
            updated = dataclasses.replace(node, **{k: updated})
        cfg = updated
    return cfg


@dataclass(frozen=True)
class ConvFeatureConfig:
    """wav2vec2-style Conv1d waveform feature extractor.

    Mirrors reference speech_encoder_prenet.py:278-374 (`ConvFeatureExtractionModel`)
    with conv_feature_layers "[(512,10,5)] + [(512,3,2)]*4 + [(512,2,2)]*2".
    """

    layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    mode: str = "default"  # "default": GroupNorm on first layer; "layer_norm": LN every layer
    bias: bool = False
    # conv lowering for the strided middle layers (names kept from the JAX
    # package): "xla" (torch conv1d), "polyphase" (k strided-slice matmuls),
    # or "pallas" (the hand-written CUDA conv stack of ops/cuda_kernels,
    # one launch per layer with GELU fused into the store).  Parameters are
    # identical either way.
    impl: str = "xla"

    @property
    def downsample_rate(self) -> int:
        r = 1
        for _, _, s in self.layers:
            r *= s
        return r

    @property
    def out_dim(self) -> int:
        return self.layers[-1][0]

    def out_length(self, in_length):
        """Conv length arithmetic (reference speech_encoder_prenet.py:356-374)."""
        out = in_length
        for _, k, s in self.layers:
            out = (out - k) // s + 1
        return out


@dataclass(frozen=True)
class MaskingConfig:
    """HuBERT span masking (reference speech_encoder_prenet.py:131-148, 234-272)."""

    mask_prob: float = 0.80
    mask_length: int = 10
    mask_selection: str = "static"
    min_masks: int = 2
    mask_channel_prob: float = 0.0
    mask_channel_length: int = 10


@dataclass(frozen=True)
class RelPosConfig:
    """Clipped-distance relative position embedding (reference encoder.py:40-59).

    An embedding table of size (2*max_distance, head_dim); distance i-j clipped to
    [-max_distance, max_distance-1].  Bias term B = q_scaled . pe_k[i-j]^T added to
    attention logits (reference multihead_attention.py:343-353).
    """

    enabled: bool = True
    max_distance: int = 160


@dataclass(frozen=True)
class TransformerConfig:
    d_model: int = 768
    ffn_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    activation: str = "gelu"
    layer_norm_first: bool = False  # pre-LN (True, Large) vs post-LN (False, Base)
    layer_norm_eps: float = 1e-5
    layerdrop: float = 0.0
    rel_pos: RelPosConfig = field(default_factory=RelPosConfig)
    # apply rel-pos bias inside self-attention.  The reference decoder builds its
    # self-attention WITHOUT has_relative_attention_bias (transformer_layer.py:229-242),
    # so its pos_emb is computed but never added; we replicate with use_rel_pos_bias=False.
    use_rel_pos_bias: bool = True
    # activation checkpointing: recompute each layer in the backward pass
    # (the reference's optional checkpoint_wrapper, decoder.py:88-91); in
    # the port torch.utils.checkpoint around each layer of a training
    # forward (models/encoder.py, models/decoder.py).
    remat: bool = False
    # materialize attention logits (scores + rel-pos bias) in f32.  The
    # default False keeps the [B, H, T, T] tensors in compute dtype —
    # softmax still reduces in f32.  The reference trains fp16 and also
    # materializes scores in compute dtype (fairseq fp16 path), so False is
    # the parity choice.  No effect when the compute dtype is f32.
    attn_scores_f32: bool = False
    # use the fused attention kernel with in-kernel banded rel-pos bias
    # (in the port: the CUDA kernel ops/cuda_kernels.banded_flash_attention)
    # for full (non-causal, uncached) self-attention at inference.
    use_pallas_attn: bool = False
    # differentiable fused attention for TRAINING passes (in-kernel
    # counter-hash dropout; in the port the CUDA kernels of
    # ops/cuda_kernels.banded_attention_train).
    use_pallas_attn_train: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclass(frozen=True)
class SpeechDecoderPrenetConfig:
    """Tacotron2 prenet -> linear -> scaled positional encoding
    (reference speech_decoder_prenet.py:21-110)."""

    layers: int = 2
    units: int = 256
    dropout: float = 0.5  # applied at train AND eval (Tacotron2 convention)


@dataclass(frozen=True)
class SpeechDecoderPostnetConfig:
    """feat_out/prob_out linears + Tacotron2 conv postnet
    (reference speech_decoder_postnet.py:17-76)."""

    postnet_layers: int = 5
    postnet_chans: int = 256
    postnet_filts: int = 5
    postnet_dropout: float = 0.5
    use_batch_norm: bool = True


@dataclass(frozen=True)
class QuantizerConfig:
    """Gumbel vector quantizer for codebook mixing (reference speecht5.py:93-107)."""

    enabled: bool = False
    latent_vars: int = 100
    latent_groups: int = 2
    latent_dim: int = 0  # 0 -> d_model
    temp_start: float = 2.0
    temp_end: float = 0.5
    temp_decay: float = 0.999995
    codebook_prob: float = 0.1


@dataclass(frozen=True)
class SIDConfig:
    """Speaker-identification (s2c) head (reference speecht5.py:305-390 flags,
    speaker_decoder_postnet.py:129-200).  num_classes == 0 disables the head.
    The released SID recipe (SpeechT5/README.md:606-652) uses pooling='decoder',
    no_pooling_bn=True, no_embed_postnet=True, softmax_type='softmax'."""

    num_classes: int = 0
    embed_dim: int = 128
    pooling: str = "decoder"        # decoder | encoder | encoder-cls
    softmax_type: str = "softmax"   # softmax | amsoftmax | aamsoftmax
    margin: float = 0.0
    scale: float = 1.0
    easy_margin: bool = False
    no_pooling_bn: bool = False
    no_embed_postnet: bool = False
    normalize_postnet: bool = False
    # prepend a [CLS] vector (zero token through the text decoder prenet) to
    # the encoder input; pooling='encoder-cls' then reads a real CLS state
    # (reference speecht5.py:826-828, _integrate_with_speaker_cls :965-990)
    encoder_cls: bool = False
    # shuffle encoder input frames during training (reference
    # speecht5.py:821-825, sid_shuffle_encoder_input)
    shuffle_encoder_input: bool = False


@dataclass(frozen=True)
class HubertHeadConfig:
    """Masked-frame NCE head (reference speech_encoder_postnet.py:17-124)."""

    final_dim: int = 256
    logit_temp: float = 0.1
    untie_final_proj: bool = True
    num_classes: Tuple[int, ...] = (504,)  # per label-set dictionary sizes


@dataclass(frozen=True)
class SpeechT5Config:
    """Unified-modal encoder-decoder (reference models/speecht5.py:47-1447)."""

    # dictionary
    vocab_size: int = 81
    pad_id: int = 1
    bos_id: int = 0
    eos_id: int = 2
    unk_id: int = 3
    blank_id: int = 4  # <ctc_blank> appended by the task (reference tasks/speecht5.py)

    encoder: TransformerConfig = field(default_factory=TransformerConfig)
    decoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(num_layers=6, use_rel_pos_bias=False)
    )

    conv_features: ConvFeatureConfig = field(default_factory=ConvFeatureConfig)
    masking: MaskingConfig = field(default_factory=MaskingConfig)

    # positions
    max_speech_positions: int = 4000
    max_text_positions: int = 450
    use_conv_pos: bool = True
    use_sinc_pos: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16

    # speech io
    n_mels: int = 80
    reduction_factor: int = 2
    sample_rate: int = 16000
    label_rate: float = 50.0  # km-label frames/sec for pretraining targets

    speech_prenet: SpeechDecoderPrenetConfig = field(default_factory=SpeechDecoderPrenetConfig)
    speech_postnet: SpeechDecoderPostnetConfig = field(default_factory=SpeechDecoderPostnetConfig)

    # speaker embedding
    spk_embed_dim: Optional[int] = 512
    spk_embed_integration: str = "pre"  # pre | add | concat

    # pretraining heads
    quantizer: QuantizerConfig = field(default_factory=QuantizerConfig)
    hubert: HubertHeadConfig = field(default_factory=HubertHeadConfig)

    # speaker identification head (s2c fine-tune)
    sid: SIDConfig = field(default_factory=SIDConfig)

    # SE (s2s) output mode: None | 'masking' | 'target' | 'delta' — how the
    # decoder postnet output combines with the source fbank (reference
    # speecht5.py:937-952; requires reduction_factor == 1 and the
    # se_decoder_input='source' data path supplying src_mel)
    se_predict: Optional[str] = None

    # ctc head over encoder output shares the text embedding when True
    share_ctc_embed: bool = False
    share_input_output_embed: bool = False

    feature_grad_mult: float = 0.1

    # numerics
    dtype: str = "float32"  # activation/compute dtype ("bfloat16" to serve)
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.spk_embed_integration not in ("pre", "add", "concat"):
            raise ValueError(
                f"spk_embed_integration={self.spk_embed_integration!r} not in "
                "('pre', 'add', 'concat')"
            )
        if self.se_predict not in (None, "masking", "target", "delta"):
            raise ValueError(
                f"se_predict={self.se_predict!r} not in "
                "(None, 'masking', 'target', 'delta')"
            )
        # NOTE: se_predict additionally requires reduction_factor == 1; that
        # cross-field constraint is checked at forward time (forward_s2s) so
        # that apply_overrides can set the two fields in either order.

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def d_model(self) -> int:
        return self.encoder.d_model


def speecht5_base(**kw) -> SpeechT5Config:
    """t5_transformer_base (reference speecht5.py:1385-1400)."""
    cfg = SpeechT5Config(
        encoder=TransformerConfig(layer_norm_first=False, layerdrop=0.05),
        decoder=TransformerConfig(
            num_layers=6, layer_norm_first=False, layerdrop=0.05, use_rel_pos_bias=False
        ),
        masking=MaskingConfig(mask_prob=0.80),
    )
    return replace(cfg, **kw)


def speecht5_base_asr(**kw) -> SpeechT5Config:
    """t5_transformer_base_asr (reference speecht5.py:1427-1447)."""
    cfg = speecht5_base()
    cfg = replace(
        cfg,
        encoder=replace(cfg.encoder, activation_dropout=0.1, layerdrop=0.1),
        decoder=replace(cfg.decoder, activation_dropout=0.1, layerdrop=0.1),
        masking=MaskingConfig(
            mask_prob=0.75, mask_channel_prob=0.5, mask_channel_length=64
        ),
        max_text_positions=600,
        feature_grad_mult=0.0,
    )
    return replace(cfg, **kw)


def speecht5_base_sid(num_classes: int = 1251, **kw) -> SpeechT5Config:
    """SID fine-tune preset (JAX config.py:394-408, reference
    SpeechT5/README.md:606-652): base arch, no masking, decoder pooling,
    plain softmax head without BN/embedding."""
    cfg = speecht5_base_asr()
    cfg = replace(
        cfg,
        masking=MaskingConfig(mask_prob=0.0, mask_channel_prob=0.0),
        max_speech_positions=8000,
        share_input_output_embed=True,
        feature_grad_mult=1.0,
        sid=SIDConfig(
            num_classes=num_classes, no_pooling_bn=True, no_embed_postnet=True
        ),
    )
    return replace(cfg, **kw)


def speecht5_tiny(**kw) -> SpeechT5Config:
    """Small config for tests: fast to init/jit on CPU."""
    enc = TransformerConfig(
        d_model=64, ffn_dim=128, num_layers=2, num_heads=4,
        dropout=0.0, attention_dropout=0.0,
        rel_pos=RelPosConfig(max_distance=16),
    )
    dec = TransformerConfig(
        d_model=64, ffn_dim=128, num_layers=2, num_heads=4,
        dropout=0.0, attention_dropout=0.0,
        rel_pos=RelPosConfig(max_distance=16), use_rel_pos_bias=False,
    )
    cfg = SpeechT5Config(
        vocab_size=32,
        encoder=enc,
        decoder=dec,
        conv_features=ConvFeatureConfig(layers=((32, 10, 5), (32, 8, 4), (64, 4, 4))),
        max_speech_positions=256,
        max_text_positions=64,
        conv_pos=16,
        conv_pos_groups=4,
        n_mels=20,
        spk_embed_dim=16,
        speech_prenet=SpeechDecoderPrenetConfig(layers=2, units=32),
        speech_postnet=SpeechDecoderPostnetConfig(postnet_layers=2, postnet_chans=32),
        hubert=HubertHeadConfig(final_dim=24, num_classes=(16,)),
    )
    return replace(cfg, **kw)
