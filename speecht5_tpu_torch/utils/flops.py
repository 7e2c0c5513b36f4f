"""Analytical FLOP counts for MFU reporting (the port's copy of
``speecht5_tpu/utils/flops.py``: the same functions, the same numbers).

Counts multiply-accumulates as 2 FLOPs, matmul [m,k]x[k,n] = 2*m*k*n.
Causal attention is counted at FULL score size, so MFU here is the
utilization of the program actually run, not an idealized model count.
Left out, as in JAX: the weight-norm positional conv (groups 16, k 128,
about 9.4 MFLOP a frame at Base), the prenets and postnets, norms,
softmax and the optimizer.

The peak is one H100 SXM's dense bf16 rate, 989 TFLOP/s (NVIDIA's data
sheet, at its 700 W limit): the figure the port's kernel bounds use.
"""

from __future__ import annotations

H100_BF16_PEAK = 989e12


def chip_peak_flops() -> float:
    return H100_BF16_PEAK


def conv_frontend_flops(cfg, B: int, T_wav: int) -> float:
    """wav2vec2-style Conv1d stack (config.ConvFeatureConfig.layers)."""
    total = 0.0
    t = T_wav
    c_in = 1
    for c_out, k, s in cfg.conv_features.layers:
        t = (t - k) // s + 1
        total += 2.0 * B * t * c_in * c_out * k
        c_in = c_out
    return total


def attention_flops(B: int, Tq: int, Tk: int, d_model: int,
                    rel_pos: bool = False, kv_proj: bool = True) -> float:
    """One MHA: q/o projections always; k/v projections optional (cached
    cross-attention skips them); scores + PV; optional rel-pos bias einsum."""
    f = 2.0 * 2 * B * Tq * d_model * d_model          # q, out proj
    if kv_proj:
        f += 2.0 * 2 * B * Tk * d_model * d_model     # k, v proj
    f += 2.0 * 2 * B * Tq * Tk * d_model              # scores + PV
    if rel_pos:
        f += 2.0 * B * Tq * Tk * d_model              # banded bias einsum
    return f


def ffn_flops(B: int, T: int, d_model: int, ffn_dim: int) -> float:
    return 2.0 * 2 * B * T * d_model * ffn_dim


def encoder_flops(tcfg, B: int, T: int) -> float:
    """Transformer encoder stack (models/encoder.py)."""
    per_layer = (
        attention_flops(
            B, T, T, tcfg.d_model,
            rel_pos=tcfg.rel_pos.enabled and tcfg.use_rel_pos_bias,
        )
        + ffn_flops(B, T, tcfg.d_model, tcfg.ffn_dim)
    )
    return per_layer * tcfg.num_layers


def decoder_teacher_flops(tcfg, B: int, T_dec: int, T_enc: int) -> float:
    """Teacher-forced decoder stack (self + cross attention)."""
    per_layer = (
        attention_flops(B, T_dec, T_dec, tcfg.d_model,
                        rel_pos=tcfg.rel_pos.enabled and tcfg.use_rel_pos_bias)
        + attention_flops(B, T_dec, T_enc, tcfg.d_model)
        + ffn_flops(B, T_dec, tcfg.d_model, tcfg.ffn_dim)
    )
    return per_layer * tcfg.num_layers


def asr_decode_flops(cfg, B: int, beam: int, T_wav: int, steps: int,
                     ctc: bool = True) -> float:
    """One ASR beam decode (decode/asr.py:ASRDecoder): conv frontend + encoder
    (+CTC head) + cross-KV precompute + `steps` AR decoder steps at B*beam
    rows with the grouped cross-attention (K/V untiled).
    """
    T_enc = cfg.conv_features.out_length(T_wav)
    D = cfg.decoder.d_model
    F = cfg.decoder.ffn_dim
    L = cfg.decoder.num_layers
    N = B * beam

    c_fe = cfg.conv_features.layers[-1][0]
    f = conv_frontend_flops(cfg, B, T_wav)
    f += 2.0 * B * T_enc * c_fe * cfg.d_model         # post-extract proj
    f += encoder_flops(cfg.encoder, B, T_enc)
    if ctc:
        f += 2.0 * B * T_enc * cfg.d_model * cfg.vocab_size   # CTC head
    # cross K/V precompute, once per layer, untiled [B, T_enc]
    f += L * 2.0 * 2 * B * T_enc * D * D

    # AR loop: per step and layer — self-attn q/k/v/o at Tq=1, scores over the
    # growing cache (sum_t t ~ steps^2/2), grouped cross (q/o proj + scores/PV
    # against untiled enc keys), FFN; plus embedding-out projection.
    per_step_proj = L * (2.0 * 4 * N * D * D          # self q,k,v,o
                         + 2.0 * 2 * N * D * D        # cross q,o
                         + 2.0 * 2 * N * T_enc * D    # cross scores + PV
                         + ffn_flops(N, 1, D, F))
    f += steps * (per_step_proj + 2.0 * N * D * cfg.vocab_size)
    f += L * 2.0 * 2 * N * D * (steps * steps / 2.0)  # self scores + PV
    return f


def s2t_train_flops(cfg, B: int, T_wav: int, L_tgt: int,
                    bwd_mult: float = 2.0) -> float:
    """One s2t training step (CE+CTC): forward + backward (~2x forward; the
    conv frontend backward is scaled by whether feature_grad_mult > 0)."""
    T_enc = cfg.conv_features.out_length(T_wav)
    c_fe = cfg.conv_features.layers[-1][0]
    fwd_conv = conv_frontend_flops(cfg, B, T_wav)
    fwd = (
        2.0 * B * T_enc * c_fe * cfg.d_model
        + encoder_flops(cfg.encoder, B, T_enc)
        + 2.0 * B * T_enc * cfg.d_model * cfg.vocab_size
        + decoder_teacher_flops(cfg.decoder, B, L_tgt, T_enc)
        + 2.0 * B * L_tgt * cfg.d_model * cfg.vocab_size
    )
    conv_mult = (1.0 + bwd_mult) if cfg.feature_grad_mult > 0 else 1.0
    return fwd * (1.0 + bwd_mult) + fwd_conv * conv_mult


def mfu(total_flops: float, seconds: float) -> float:
    return total_flops / seconds / chip_peak_flops()
