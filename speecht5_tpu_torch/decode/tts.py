"""TTS / VC inference: autoregressive mel decoding with the decoder's KV
cache (port of ``speecht5_tpu/decode/tts.py``).

Behaviour of the reference (models/speecht5.py:1188-1249, generate_speech):
encode the text (TTS) or the source speech (VC), integrate the speaker
x-vector, then per step the decoder
gives r mel frames (``feat_out``) and r stop probabilities
(``sigmoid(prob_out)``); a row stops at the first step where a probability
reaches ``threshold`` (once ``min_len_ratio`` allows it) or at its
``max_len_ratio`` bound; the conv postnet refines the whole mel once at
the end; the length ratios act on the encoder's frames (text ids, or the
speech encoder's conv frames).  The Tacotron prenet's dropout stays on
(ROADMAP C.4), drawn from a device generator seeded per call.

JAX runs the loop on the device (``lax.while_loop``); here the host runs
it, one cached decode step at a time (``SpeechT5Model.speech_decode_step``:
the prenet on the new frame only, the decode-step kernel reading the cache
and the text's K/V in place with ``decoder.use_pallas_attn``), and reads
the ``done`` flags on the host only every ``CHECK_EVERY`` steps, as the
beam reads its loop condition.  Steps past the one where JAX's loop ends
change nothing it returns: a finished row's length and focus sum are
frozen, and the frames written after the last row stopped are zeroed, so
the buffers equal JAX's fixed-size ones ([B, max_frames, n_mels], zeros
past the last step) and the postnet, which sees across the end of a row,
gives the same mel.

The focus rate (reference scripts/generate_speech.py:54-66) is, per row,
the largest over decoder layers and heads of the mean over its steps of
the largest cross-attention probability over the text; the decode-step
kernel returns that probability from the same launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.device import resolve_device

# the host reads the done flags every this many steps (a read waits for the
# card), as the beam reads its loop condition
CHECK_EVERY = 4


class TTSResult(NamedTuple):
    mel: torch.Tensor            # [B, L, n_mels] postnet-refined
    mel_before: torch.Tensor     # [B, L, n_mels]
    lengths: torch.Tensor        # [B] frames generated
    stop_probs: torch.Tensor     # [B, L]
    wav: Optional[torch.Tensor] = None           # [B, L * hop] with a vocoder
    wav_lengths: Optional[torch.Tensor] = None   # [B] samples
    focus_rate: Optional[torch.Tensor] = None    # [B]


class TTSDecoder:
    """``model``: a SpeechT5Model (eval mode); ``vocoder``: a
    ``models/hifigan.HiFiGANGenerator`` run on the refined mel, or None.
    ``max_frames`` bounds the output buffer (``max_frames // r`` steps);
    ``seed``: the prenet dropout generator's seed when a call gives none."""

    def __init__(self, model, *, max_len_ratio: float = 10.0,
                 min_len_ratio: float = 0.0, threshold: float = 0.5,
                 max_frames: int = 1600, vocoder=None, seed: int = 0, device="cuda"):
        self.model = model
        self.cfg = model.cfg
        self.threshold = threshold
        self.max_len_ratio = max_len_ratio
        self.min_len_ratio = min_len_ratio
        self.max_steps = max_frames // self.cfg.reduction_factor
        self.vocoder = vocoder
        self.seed = seed
        self.device = resolve_device(device)
        self.steps_run = 0      # decode steps, over all calls

    @torch.no_grad()
    def text_to_speech(self, tokens, spkembs=None, generator=None) -> TTSResult:
        """tokens: [B, T] int (pad_id-padded); spkembs: [B, spk_embed_dim]
        or None; ``generator``: a ``torch.Generator`` on the device for the
        prenet's dropout (one seeded ``seed`` when None)."""
        dev = self.device
        tokens = torch.as_tensor(tokens).to(dev, torch.int64)
        if spkembs is not None:
            spkembs = torch.as_tensor(spkembs).to(dev, torch.float32)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(self.seed)
        enc = self.model.encode_text(tokens)
        return self._run(enc, spkembs, generator)

    @torch.no_grad()
    def speech_to_speech(self, wav, wav_lengths, spkembs=None,
                         generator=None) -> TTSResult:
        """VC (JAX :74-78): wav [B, T] f32 16 kHz, wav_lengths [B];
        spkembs: the target speaker's x-vectors [B, spk_embed_dim] or None;
        ``generator`` as in ``text_to_speech``."""
        dev = self.device
        wav = torch.as_tensor(wav).to(dev, torch.float32)
        wav_lengths = torch.as_tensor(wav_lengths).to(torch.int64)
        if spkembs is not None:
            spkembs = torch.as_tensor(spkembs).to(dev, torch.float32)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(self.seed)
        enc = self.model.encode_speech(wav, wav_lengths)
        return self._run(enc, spkembs, generator)

    def _run(self, enc, spkembs, generator) -> TTSResult:
        cfg, model = self.cfg, self.model
        r, n_mels, S = cfg.reduction_factor, cfg.n_mels, self.max_steps
        valid = enc["valid_mask"]
        B, dev = valid.shape[0], valid.device
        enc_len = valid.to(torch.int32).sum(-1).to(torch.float32)
        max_steps_b = torch.clamp_max((enc_len * self.max_len_ratio / r).to(torch.int32), S)
        min_steps_b = (enc_len * self.min_len_ratio / r).to(torch.int32)
        cache = model.init_speech_cache(enc, B, S + 1, spkembs=spkembs)
        L, H = cfg.decoder.num_layers, cfg.decoder.num_heads
        mel_buf = torch.zeros(B, S * r, n_mels, device=dev)
        prob_buf = torch.zeros(B, S * r, device=dev)
        prev = torch.zeros(B, 1, n_mels, device=dev)     # the zero BOS frame
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        lengths = torch.zeros(B, dtype=torch.int32, device=dev)
        focus_acc = torch.zeros(L, B, H, device=dev)
        step = 0
        while step < S:
            frames, probs, cache, attn = model.speech_decode_step(
                prev, cache, spkembs=spkembs, enc_valid=valid, need_attn=True,
                generator=generator)
            focus_acc += attn * (~done).to(torch.float32)[None, :, None]
            mel_buf[:, step * r:(step + 1) * r] = frames
            prob_buf[:, step * r:(step + 1) * r] = probs
            hit_stop = (probs >= self.threshold).any(-1)
            newly = ~done & ((hit_stop & (step + 1 >= min_steps_b))
                             | (step + 1 >= max_steps_b))
            lengths = torch.where(newly, torch.full_like(lengths, (step + 1) * r), lengths)
            done = done | newly
            prev = frames[:, -1:]
            step += 1
            if step % CHECK_EVERY == 0 and bool(done.all()):
                break
        self.steps_run += step
        # every row is done by step S (max_steps_b <= S): JAX's loop ends at
        # the step where the last row stopped; zero what came after
        written = torch.arange(S * r, device=dev) < lengths.max()
        mel_buf = mel_buf * written[None, :, None]
        prob_buf = prob_buf * written[None, :]
        steps_b = torch.clamp_min(lengths // r, 1).to(torch.float32)
        focus_rate = (focus_acc / steps_b[None, :, None]).amax(dim=(0, 2))
        mel = model.postnet_refine(mel_buf)
        wav = wav_lengths = None
        if self.vocoder is not None:
            wav = self.vocoder(mel)
            wav_lengths = lengths * (wav.shape[-1] // mel.shape[1])
        return TTSResult(mel=mel, mel_before=mel_buf, lengths=lengths,
                         stop_probs=prob_buf, wav=wav, wav_lengths=wav_lengths,
                         focus_rate=focus_rate)
