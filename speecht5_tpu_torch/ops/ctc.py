"""CTC loss (port of ``speecht5_tpu/ops/ctc.py``).

The JAX package runs the forward algorithm as a log-semiring scan; the port
calls ``torch.nn.functional.ctc_loss`` (no TPU kernel stands behind this
function), with the same per-sample contract and ``zero_infinity``.
"""

from __future__ import annotations

import torch.nn.functional as F


def ctc_loss(log_probs, logit_lengths, labels, label_lengths, blank_id: int = 0,
             zero_infinity: bool = False):
    """Per-sample negative log likelihood [B] (summed over frames).

    log_probs: [B, T, V] log-softmax over the vocabulary (blank included);
    logit_lengths: [B] valid frames; labels: [B, L] (padding beyond
    label_lengths is ignored); label_lengths: [B].  ``zero_infinity``
    zeroes the loss and gradient of samples whose alignment is infeasible
    (the reference ASR recipe's --zero-infinity)."""
    return F.ctc_loss(
        log_probs.float().transpose(0, 1), labels.long(), logit_lengths.long(),
        label_lengths.long(), blank=blank_id, reduction="none",
        zero_infinity=zero_infinity)
