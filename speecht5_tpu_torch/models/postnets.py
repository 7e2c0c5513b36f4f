"""Text decoder postnet (port of ``speecht5_tpu/models/postnets.py``
:127-147): decoder features -> f32 vocabulary logits, through its own
bias-free projection or, with ``share_input_output_embed``, the decoder
embedding matrix.  The speech and HuBERT postnets arrive with their slices.
"""

from __future__ import annotations

from torch import nn

from ..config import SpeechT5Config


class TextDecoderPostnet(nn.Module):
    def __init__(self, cfg: SpeechT5Config):
        super().__init__()
        self.cfg = cfg
        self.output_projection = (
            None if cfg.share_input_output_embed
            else nn.Linear(cfg.d_model, cfg.vocab_size, bias=False))

    def forward(self, x, embed_matrix=None):
        """x: [..., D] -> f32 logits [..., V].  The tied variant needs the
        decoder embedding matrix [V, D]."""
        if self.output_projection is None:
            if embed_matrix is None:
                raise ValueError("share_input_output_embed needs embed_matrix")
            return x.float() @ embed_matrix.float().t()
        return self.output_projection(x.float())
