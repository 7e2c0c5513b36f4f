"""SID inference: batched speaker classification on the device (port of
``speecht5_tpu/decode/sid.py``; reference scripts/generate_class.py:15-153,
models/speecht5.py:1171-1186): the whole batch classifies in one forward
through ``SpeechT5Model.generate_class``."""

from __future__ import annotations

import torch

from ..utils.device import resolve_device


class SIDClassifier:
    """``model``: a SpeechT5Model with a speaker head (``sid.num_classes``
    > 0), run in eval mode on ``device``."""

    def __init__(self, model, device="cuda"):
        self.model = model.eval()
        self.device = resolve_device(device)

    @torch.no_grad()
    def __call__(self, wav, wav_lengths):
        """wav: [B, T] raw 16 kHz waveform; wav_lengths: [B] -> predicted
        class ids [B] (int64, on the device)."""
        wav = torch.as_tensor(wav).to(self.device, torch.float32)
        return self.model.generate_class(wav, torch.as_tensor(wav_lengths).to(torch.int64))
