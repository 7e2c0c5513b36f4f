"""HuBERT-style span masking (port of ``speecht5_tpu/ops/masking.py``).

Sampling and applying are split: ``sample_feature_masks`` draws the masks
on the host from a CPU ``torch.Generator`` (no device sync; the JAX package
draws them on device from a PRNG key), and ``apply_feature_masks`` is a
function of given masks, so a test can hand both packages the same masks.
The distribution is the JAX package's (fairseq "static" selection):

- per sample, num_spans = floor(mask_prob * length / span_len + u),
  u ~ U[0, 1), at least ``min_masks``, at most
  int(mask_prob * max_len / span_len) + min_masks + 1;
- span starts uniform without replacement in [0, max(length - span_len, 1))
  (top-k of uniform scores);
- the mask is the union of the spans, cut to the sample's length.
"""

from __future__ import annotations

import torch


def compute_span_mask(lengths, max_len: int, mask_prob: float, span_len: int,
                      min_masks: int = 2, generator=None):
    """bool[B, max_len] span masks on the CPU; True = masked.  Only
    positions < lengths are ever masked."""
    lengths = torch.as_tensor(lengths, dtype=torch.int64).cpu()
    B = lengths.shape[0]
    usable = torch.clamp(lengths - span_len, min=1)
    u = torch.rand(B, generator=generator)
    num_spans = torch.floor(mask_prob * lengths.float() / span_len + u).long()
    max_spans = min(int(mask_prob * max_len / span_len) + min_masks + 1, max_len)
    num_spans = num_spans.clamp(min_masks, max_spans)
    scores = torch.rand(B, max_len, generator=generator)
    pos = torch.arange(max_len)
    scores = torch.where(pos[None, :] < usable[:, None], scores,
                         torch.full((), -1.0))
    starts = torch.topk(scores, max_spans, dim=1).indices       # [B, S]
    active = torch.arange(max_spans)[None, :] < num_spans[:, None]
    t = pos[None, None, :]
    s = starts[:, :, None]
    in_span = (t >= s) & (t < s + span_len) & active[:, :, None]
    return in_span.any(dim=1) & (pos[None, :] < lengths[:, None])


def sample_feature_masks(lengths, T: int, C: int, masking, generator=None):
    """(time_mask bool[B, T], channel_mask bool[B, C] or None) for a
    ``MaskingConfig``; None for the time mask when mask_prob is 0."""
    time_mask = chan_mask = None
    if masking.mask_prob > 0:
        time_mask = compute_span_mask(lengths, T, masking.mask_prob,
                                      masking.mask_length, masking.min_masks,
                                      generator)
        if masking.mask_channel_prob > 0:
            B = len(lengths)
            chan_mask = compute_span_mask(
                torch.full((B,), C), C, masking.mask_channel_prob,
                masking.mask_channel_length, 0, generator)
    return time_mask, chan_mask


def apply_feature_masks(x, time_mask, mask_emb, chan_mask=None):
    """HuBERT time masking (frames replaced by ``mask_emb``) and channel
    masking (channels zeroed): x [B, T, C] -> x."""
    x = torch.where(time_mask[:, :, None], mask_emb.to(x.dtype)[None, None, :], x)
    if chan_mask is not None:
        x = torch.where(chan_mask[:, None, :], torch.zeros((), dtype=x.dtype,
                                                           device=x.device), x)
    return x
