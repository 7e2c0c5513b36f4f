"""Encoder-only CTC greedy decoding.

Port of the greedy arm of ``speecht5_tpu/decode/asr.py`` (:295-380): one
encoder + CTC-head forward for the whole batch, the argmax on the device,
and only the ``[B, T]`` int32 frame ids and the frame lengths copied to the
host for the greedy collapse (JAX asr.py:332-337).  The joint CTC/attention
beam (``ASRDecoder``), the lexicon arm and ``RescoreDecoder`` arrive with
the beam slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.masks import mask_lengths
from ..utils.device import resolve_device


class CTCDecoder:
    """Greedy (viterbi) CTC decode over a port ``SpeechT5Model``."""

    def __init__(self, model, *, blank_id: int, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.blank_id = blank_id

    def _inputs(self, wav, lengths):
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        return wav, lengths

    @torch.inference_mode()
    def logits(self, wav, lengths):
        """f32 CTC logits [B, T, V] and int32 frame lengths [B] (device)."""
        enc = self.model.encode_speech(*self._inputs(wav, lengths), with_ctc=True)
        return enc["ctc_logits"], mask_lengths(enc["valid_mask"])

    @torch.inference_mode()
    def frame_ids(self, wav, lengths):
        """Per-frame argmax ids [B, T] int32 and frame lengths [B], as numpy:
        the argmax runs on the device, only the ids cross to the host."""
        logits, frame_lengths = self.logits(wav, lengths)
        ids = torch.argmax(logits, dim=-1).to(torch.int32)
        return ids.cpu().numpy(), frame_lengths.cpu().numpy()

    def __call__(self, wav, lengths) -> list:
        """Returns a list of B token-id lists (letters + word-sep tokens)."""
        ids, frame_lengths = self.frame_ids(wav, lengths)
        return greedy_collapse(ids, frame_lengths, self.blank_id)


def greedy_collapse(ids: np.ndarray, lengths: np.ndarray,
                    blank_id: int) -> list:
    """Collapse repeats + drop blanks over per-frame argmax ids [B, T]."""
    out = []
    for b in range(ids.shape[0]):
        seq = ids[b, : lengths[b]]
        if len(seq) == 0:
            out.append([])
            continue
        seq = seq[np.concatenate([[True], seq[1:] != seq[:-1]])]
        out.append(seq[seq != blank_id].tolist())
    return out


def greedy_ctc(ctc_logits, lengths, blank_id: int) -> list:
    """Greedy CTC decode (collapse repeats, drop blanks) of [B, T, V] logits —
    the reference's in-training WER decode (reference
    criterions/speech_to_text_loss.py:232-297)."""
    ids = torch.argmax(torch.as_tensor(ctc_logits), dim=-1)
    return greedy_collapse(ids.cpu().numpy(), np.asarray(torch.as_tensor(lengths).cpu()),
                           blank_id)
