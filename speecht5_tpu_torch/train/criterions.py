"""Speech-to-text loss (port of ``speecht5_tpu/train/criterions.py``
:30-84): label-smoothed cross-entropy on the decoder plus weighted CTC on
the encoder, token means with the JAX package's denominators (reference
criterions/speech_to_text_loss.py:113-337).  The other tasks' losses arrive
with their slices.
"""

from __future__ import annotations

import torch

from ..ops.ctc import ctc_loss


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
    denom = w.sum().clamp_min(1.0)
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
                               / valid.sum().clamp_min(1))
    if ctc_weight > 0 and ctc_logits is not None:
        lp = torch.log_softmax(ctc_logits.float(), dim=-1)
        enc_lengths = enc_valid.sum(-1)
        # the CTC target is the tokens without EOS
        tgt_lengths = (valid & (targets != eos_id)).sum(-1)
        nll_ctc = ctc_loss(lp, enc_lengths, targets, tgt_lengths, blank_id,
                           zero_infinity=zero_infinity)
        ctc = nll_ctc.sum() / tgt_lengths.sum().clamp_min(1)
        loss = loss + ctc_weight * ctc
        metrics["ctc_loss"] = ctc
    metrics["loss"] = loss
    return loss, metrics
