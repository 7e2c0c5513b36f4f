"""Losses (port of ``speecht5_tpu/train/criterions.py``), means with the
JAX package's denominators:

- s2t (:30-84): label-smoothed cross-entropy on the decoder plus weighted
  CTC on the encoder (reference criterions/speech_to_text_loss.py:113-337);
- t2s and s2s (:133-217): Tacotron2 L1 (and L2) on the frames before and
  after the postnet, BCE with pos_weight 5 on the stop logits, and the
  guided attention loss on the cross weights (reference
  criterions/text_to_speech_loss.py:72-427);
- s2c (:86-100): label-smoothed cross-entropy over the speaker classes and
  the accuracy (reference speech_to_text_loss.py:186-209; the margin is the
  model's);
- pretraining (:228-321): the HuBERT masked / unmasked cross-entropy
  (reference speech_pretrain_criterion.py:99-120, its NCE with the
  positive prepended being CE over the codebook), the speech pretraining
  loss (HuBERT, the feature penalty, the codebook diversity term and the
  TTS-style decoder loss) and the BART text loss.

Under data parallelism each rank computes its share of the global-batch
loss: the local sum over the global count (``data_allreduce`` of the local
counts), so the shares sum to JAX's loss over the global batch and the
gradients are summed across the data ranks.  Every metric is such a share;
a term that every rank computes whole (the codebook diversity, the
perplexities) enters divided by the number of data ranks
(``data_size``).  In one process both are the identity.
"""

from __future__ import annotations

import torch

from ..ops.ctc import ctc_loss
from ..parallel.distributed import data_allreduce, data_size
from ..utils.masks import length_mask


def label_smoothed_ce(logits, targets, valid, eps: float = 0.1):
    """fairseq label_smoothed_nll_loss semantics, mean over valid tokens.

    logits: [..., V] f32; targets: [...] int; valid: [...] bool ->
    (smoothed loss, nll), both scalars."""
    lprobs = torch.log_softmax(logits.float(), dim=-1)
    V = lprobs.shape[-1]
    nll = -torch.gather(lprobs, -1, targets[..., None].long())[..., 0]
    smooth = -lprobs.sum(-1)
    eps_i = eps / (V - 1)
    loss = (1.0 - eps - eps_i) * nll + eps_i * smooth
    w = valid.float()
    denom = data_allreduce(w.sum()).clamp_min(1.0)
    return (loss * w).sum() / denom, (nll * w).sum() / denom


def s2t_loss(dec_logits, ctc_logits, enc_valid, targets, pad_id: int,
             blank_id: int, *, eos_id: int = 2, ce_weight: float = 1.0,
             ctc_weight: float = 0.0, label_smoothing: float = 0.1,
             zero_infinity: bool = False):
    """dec_logits [B, T, V]; ctc_logits [B, Tenc, V] or None; enc_valid
    bool [B, Tenc]; targets [B, T] EOS-terminated -> (loss, metrics of
    0-dim tensors)."""
    valid = targets != pad_id
    metrics = {}
    loss = torch.zeros((), device=targets.device)
    if ce_weight > 0:
        ce, nll = label_smoothed_ce(dec_logits, targets, valid, label_smoothing)
        loss = loss + ce_weight * ce
        metrics["ce_loss"] = ce
        metrics["nll_loss"] = nll
        pred = dec_logits.argmax(-1)
        metrics["accuracy"] = (((pred == targets) & valid).sum()
                               / data_allreduce(valid.sum()).clamp_min(1))
    if ctc_weight > 0 and ctc_logits is not None:
        lp = torch.log_softmax(ctc_logits.float(), dim=-1)
        enc_lengths = enc_valid.sum(-1)
        # the CTC target is the tokens without EOS
        tgt_lengths = (valid & (targets != eos_id)).sum(-1)
        nll_ctc = ctc_loss(lp, enc_lengths, targets, tgt_lengths, blank_id,
                           zero_infinity=zero_infinity)
        ctc = nll_ctc.sum() / data_allreduce(tgt_lengths.sum()).clamp_min(1)
        loss = loss + ctc_weight * ctc
        metrics["ctc_loss"] = ctc
    metrics["loss"] = loss
    return loss, metrics


def sid_loss(logits, targets, label_smoothing: float = 0.0):
    """logits [B, C]; targets [B] class ids -> (loss, metrics loss,
    nll_loss, accuracy)."""
    valid = torch.ones(targets.shape, dtype=torch.bool, device=targets.device)
    ce, nll = label_smoothed_ce(logits.float(), targets, valid, label_smoothing)
    acc = ((logits.argmax(-1) == targets).float().sum()
           / data_allreduce(torch.tensor(float(targets.numel()), device=targets.device)))
    return ce, {"loss": ce, "nll_loss": nll, "accuracy": acc}


def guided_attention_loss(attn, enc_lengths, dec_lengths, sigma: float = 0.4,
                          num_layers: int = 2, num_heads: int = 2):
    """espnet GuidedAttentionLoss over the cross-attention maps of the first
    ``num_layers`` layers x first ``num_heads`` heads (reference
    text_to_speech_loss.py:370-427).  attn: [L, B, H, Tdec, Tenc]."""
    attn = attn[:num_layers, :, :num_heads]
    L, _, H, Td, Te = attn.shape
    dev = attn.device
    t_dec = torch.arange(Td, dtype=torch.float32, device=dev)[None, :, None]
    t_enc = torch.arange(Te, dtype=torch.float32, device=dev)[None, None, :]
    ilen = torch.clamp_min(enc_lengths, 1).float()[:, None, None]
    olen = torch.clamp_min(dec_lengths, 1).float()[:, None, None]
    w = 1.0 - torch.exp(-((t_enc / ilen - t_dec / olen) ** 2) / (2.0 * sigma ** 2))
    valid = (t_dec < olen) & (t_enc < ilen)
    w = torch.where(valid, w, torch.zeros((), device=dev))
    num = (attn.float() * w[None, :, None]).sum()
    return num / torch.clamp_min(data_allreduce(valid.sum()) * L * H, 1)


def tts_loss(before, after, stop_logits, target_mel, dec_lengths, *,
             reduction_factor: int = 2, bce_pos_weight: float = 5.0,
             bce_loss_lambda: float = 1.0, loss_type: str = "L1", attn=None,
             enc_lengths=None, use_guided_attn: bool = False,
             guided_attn_lambda: float = 1.0, guided_attn_sigma: float = 0.4):
    """Tacotron2 loss with the targets trimmed to a multiple of r (reference
    text_to_speech_loss.py:162-169, 263-345).  before / after / target_mel
    [B, T, n_mels]; stop_logits [B, T]; dec_lengths [B] full-rate frame
    counts; attn [L, B, H, Td, Te] for the guided loss -> (loss, metrics
    l1_loss, l2_loss, bce_loss[, enc_dec_attn_loss], loss)."""
    T = before.shape[1]
    r = reduction_factor
    olens = dec_lengths - dec_lengths % r
    mask = length_mask(olens, T)[..., None]
    w = mask.float()
    denom = torch.clamp_min(data_allreduce(w.sum()) * before.shape[-1], 1.0)
    tgt = target_mel.float()
    l1 = ((after - tgt).abs() * w).sum() / denom + ((before - tgt).abs() * w).sum() / denom
    l2 = (((after - tgt) ** 2) * w).sum() / denom + (((before - tgt) ** 2) * w).sum() / denom

    # stop label 1 at the last valid frame (reference :167-169)
    pos = torch.arange(T, device=before.device)[None, :]
    stop_labels = (pos == torch.clamp_min(olens - 1, 0)[:, None]).float()
    z = stop_logits.float()
    softplus_neg = torch.log1p(torch.exp(-z.abs()))
    bce_el = (torch.clamp_min(z, 0.0) - z * stop_labels + softplus_neg
              + (bce_pos_weight - 1.0) * stop_labels
              * (softplus_neg + torch.clamp_min(-z, 0.0)))
    wm = mask[..., 0].float()
    bce = (bce_el * wm).sum() / torch.clamp_min(data_allreduce(wm.sum()), 1.0)

    if loss_type == "L1":
        loss = l1 + bce_loss_lambda * bce
    elif loss_type == "L2":
        loss = l2 + bce_loss_lambda * bce
    else:
        loss = l1 + l2 + bce_loss_lambda * bce
    metrics = {"l1_loss": l1, "l2_loss": l2, "bce_loss": bce}
    if use_guided_attn and attn is not None:
        ga = guided_attention_loss(attn, enc_lengths, olens // r, guided_attn_sigma)
        loss = loss + guided_attn_lambda * ga
        metrics["enc_dec_attn_loss"] = ga
    metrics["loss"] = loss
    return loss, metrics


def hubert_loss(hubert_logits, target_list, time_mask, valid_mask, *,
                pred_masked_weight: float = 1.0, pred_nomask_weight: float = 0.0):
    """hubert_logits: list of [B, T, C] f32; target_list: list of [B, T]
    frame labels; time_mask (None: nothing masked) and valid_mask bool [B,
    T] -> (loss, metrics): per label set ``loss_m_i`` / ``loss_u_i``, the
    mean NLL over the masked / unmasked valid frames, and ``acc_m_i``."""
    if time_mask is None:
        time_mask = torch.zeros_like(valid_mask)
    m_b = time_mask & valid_mask
    u_b = ~time_mask & valid_mask
    n_masked = data_allreduce(m_b.sum()).clamp_min(1)
    n_unmasked = data_allreduce(u_b.sum()).clamp_min(1)
    m, u = m_b.float(), u_b.float()
    metrics = {}
    loss = torch.zeros((), device=valid_mask.device)
    for i, (logits, targets) in enumerate(zip(hubert_logits, target_list)):
        lp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(lp, -1, targets[..., None].long())[..., 0]
        loss_m = (nll * m).sum() / n_masked
        loss_u = (nll * u).sum() / n_unmasked
        metrics[f"loss_m_{i}"] = loss_m
        metrics[f"loss_u_{i}"] = loss_u
        metrics[f"acc_m_{i}"] = ((logits.argmax(-1) == targets) & m_b).sum() / n_masked
        if pred_masked_weight > 0:
            loss = loss + pred_masked_weight * loss_m
        if pred_nomask_weight > 0:
            loss = loss + pred_nomask_weight * loss_u
    return loss, metrics


def _diversity(q):
    """This rank's share of the codebook diversity term (G V - prob
    perplexity) / (G V), which every data rank computes whole."""
    return (q["num_vars"] - q["prob_perplexity"]) / q["num_vars"] / data_size()


def speech_pretrain_loss(out, target_list, target_mel, dec_lengths, enc_lengths, *,
                         reduction_factor: int = 2, dec_weight: float = 1.0,
                         hubert_weight: float = 1.0, feature_pen_weight: float = 10.0,
                         prob_ppl_weight: float = 0.1, use_guided_attn: bool = True):
    """``out``: ``forward_pretrain_speech``'s dict; target_mel [B, F,
    n_mels] with dec_lengths [B] frames; enc_lengths [B] conv frames ->
    (loss, metrics; the decoder's prefixed ``dec_``)."""
    loss, metrics = hubert_loss(out["hubert_logits"], target_list, out["time_mask"],
                                out["valid_mask"])
    loss = hubert_weight * loss + feature_pen_weight * out["features_pen"]
    metrics["features_pen"] = out["features_pen"]
    q = out.get("quantizer")
    if q is not None:
        loss = loss + prob_ppl_weight * _diversity(q)
        metrics["prob_perplexity"] = q["prob_perplexity"] / data_size()
        metrics["code_perplexity"] = q["code_perplexity"] / data_size()
    if dec_weight > 0:
        dec_loss, dmetrics = tts_loss(
            out["before"], out["after"], out["stop_logits"], target_mel, dec_lengths,
            reduction_factor=reduction_factor, attn=out.get("attn"),
            enc_lengths=enc_lengths, use_guided_attn=use_guided_attn)
        loss = loss + dec_weight * dec_loss
        metrics.update({f"dec_{k}": v for k, v in dmetrics.items()})
    metrics["loss"] = loss
    return loss, metrics


def text_pretrain_loss(out, targets, pad_id: int, *, label_smoothing: float = 0.1,
                       bart_weight: float = 1.0, prob_ppl_weight: float = 0.1):
    """``out``: ``forward_pretrain_text``'s dict; targets [B, T] the clean
    tokens -> (loss, metrics: bart_loss, nll_loss[, prob_perplexity])."""
    ce, nll = label_smoothed_ce(out["logits"], targets, targets != pad_id,
                                label_smoothing)
    loss = bart_weight * ce
    metrics = {"bart_loss": ce, "nll_loss": nll}
    q = out.get("quantizer")
    if q is not None:
        loss = loss + prob_ppl_weight * _diversity(q)
        metrics["prob_perplexity"] = q["prob_perplexity"] / data_size()
    metrics["loss"] = loss
    return loss, metrics


def fasttext2unit_loss(logits, out_valid, unit_targets, log_dur_out, durations, src_valid,
                       *, label_smoothing: float = 0.0, dur_loss_weight: float = 1.0):
    """FastText2Unit loss (JAX criterions.py:102-131; reference speechlm/
    criterions/fasttext2unit_loss.py:71-115): label-smoothed CE over the
    regulated frames plus ``dur_loss_weight`` x the MSE of log(dur + 1).
    logits [B, L, V]; out_valid bool [B, L]; unit_targets [B, L];
    log_dur_out, durations, src_valid [B, T] -> (loss, metrics loss,
    ce_loss, nll_loss, dur_loss, accuracy)."""
    ce, nll = label_smoothed_ce(logits.float(), unit_targets, out_valid, label_smoothing)
    log_dur = torch.log(durations.float() + 1.0)
    sv = src_valid.float()
    dur_mse = ((log_dur_out - log_dur) ** 2 * sv).sum() / torch.clamp_min(sv.sum(), 1.0)
    loss = ce + dur_loss_weight * dur_mse
    acc = (((logits.argmax(-1) == unit_targets) & out_valid).sum()
           / torch.clamp_min(out_valid.sum(), 1))
    return loss, {"loss": loss, "ce_loss": ce, "nll_loss": nll, "dur_loss": dur_mse,
                  "accuracy": acc}
