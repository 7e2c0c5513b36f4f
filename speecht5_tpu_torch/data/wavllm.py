"""WavLLM SFT / inference data: the reference's TSV format, the LLaMA-2 chat
template and the Whisper feature protocol.

A copy of ``speecht5_tpu/data/wavllm.py`` (numpy only, on the port's own
``ops/mel.py`` helpers and ``data/audio.read_audio``), so items and
collates are bit-equal to JAX's.  Reference WavLLM/wavllm/data/
speechllm_dataset.py:
- TSV columns ``id, audio, n_frames, prompt, tgt_text, with_speech``;
- LLaMA-2 chat packing (:226-233, 419-431): the left prompt
  ``[INST]<<SYS>>\\n{SYSTEM}\\n<</SYS>>\\n\\n<SPEECH>`` tokenized with BOS,
  the right prompt `` </SPEECH> {prompt} [/INST]`` without, the target with
  EOS; packed as [left | audio | right prompt | target], which is
  ``WavLLMModel.forward_sft(left_tokens=..., prompt_tokens=...)``;
- Whisper's log-mel (HF ``WhisperFeatureExtractor``): hann(400), hop 160,
  the power spectrum of all frames but the last, slaney mel(80, fmax
  8000), log10 clamped to [max - 8, max], then (x + 4) / 4.  This is not
  the log-mel kernel's function (SpeechT5's magnitude mel at n_fft 1024,
  hop 256): it runs here on the host.

Tokenization is a callable (the released LLaMA SentencePiece model, or the
recipe's byte tokenizer).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence

import numpy as np

from ..ops.mel import hann_window, mel_filterbank
from .audio import read_audio

# LLaMA-2 chat template constants (reference speechllm_dataset.py:227-233)
B_INST, E_INST = "[INST]", "[/INST]"
B_SYS, E_SYS = "<<SYS>>\n", "\n<</SYS>>\n\n"
B_SPEECH, E_SPEECH = "<SPEECH>", "</SPEECH>"
SYSTEM = (
    "As a helpful language and speech assistant, you are able to understand "
    "the speech content provided by the user, and assist the user with a "
    "variety of tasks using natural language."
)

WHISPER_SR = 16000
WHISPER_N_FFT = 400
WHISPER_HOP = 160
WHISPER_N_MELS = 80
WHISPER_CHUNK_SAMPLES = 30 * WHISPER_SR  # 480000


def prompt_strings(prompt: str) -> tuple:
    """(left, right) prompt strings around the audio segment
    (speechllm_dataset.py:422-424)."""
    left = B_INST + B_SYS + SYSTEM + E_SYS + B_SPEECH
    right = " " + E_SPEECH + " " + prompt + " " + E_INST
    return left, right


def whisper_log_mel(wav: np.ndarray, pad_to_chunk: bool = True) -> np.ndarray:
    """[T] float waveform -> [n_frames, 80] Whisper-protocol log-mel: the
    centre-padded (reflect) hann(400) frames at hop 160, |rfft|^2 without
    the final frame, slaney mel (fmin 0, fmax 8000), log10 of at least
    1e-10, floored at the global max - 8, (x + 4) / 4.  With
    ``pad_to_chunk`` the signal is zero-padded or cut to 30 s first (3000
    frames, the released encoder's fixed input)."""
    wav = np.asarray(wav, np.float32)
    if pad_to_chunk:
        if len(wav) >= WHISPER_CHUNK_SAMPLES:
            wav = wav[:WHISPER_CHUNK_SAMPLES]
        else:
            wav = np.pad(wav, (0, WHISPER_CHUNK_SAMPLES - len(wav)))
    half = WHISPER_N_FFT // 2
    padded = np.pad(wav, (half, half), mode="reflect")
    n_frames = 1 + (len(padded) - WHISPER_N_FFT) // WHISPER_HOP
    idx = (np.arange(n_frames)[:, None] * WHISPER_HOP
           + np.arange(WHISPER_N_FFT)[None, :])
    frames = padded[idx] * hann_window(WHISPER_N_FFT)
    power = np.abs(np.fft.rfft(frames, axis=-1)[:-1]) ** 2  # drop the last frame
    filters = mel_filterbank(WHISPER_SR, WHISPER_N_FFT, WHISPER_N_MELS, fmin=0.0, fmax=8000.0)
    mel = power @ filters.T
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def load_wavllm_tsv(path: str) -> List[Dict[str, str]]:
    """Rows of a reference-format TSV (id / audio / n_frames / prompt /
    tgt_text / with_speech; extra columns kept verbatim; short rows
    skipped)."""
    with open(path, encoding="utf-8") as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = []
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < len(header):
                continue
            rows.append(dict(zip(header, parts)))
    return rows


@dataclass
class WavLLMDataset:
    """SFT / inference examples from a reference-format TSV.

    ``tokenize(text) -> list[int]`` adds no BOS / EOS: the template adds
    ``bos_id`` to the left prompt and ``eos_id`` to the target
    (speechllm_dataset.py:303-324).  Audio paths resolve against
    ``audio_root`` (the TSV's directory by default), falling back to the
    basename there when the listed path does not exist."""

    tsv_path: str
    tokenize: Callable[[str], Sequence[int]]
    audio_root: str = ""
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = 0
    mel_chunk: bool = False  # True: the fixed 30 s / 3000-frame features
    rows: List[Dict[str, str]] = field(init=False)

    def __post_init__(self):
        self.rows = load_wavllm_tsv(self.tsv_path)
        if not self.audio_root:
            self.audio_root = os.path.dirname(os.path.abspath(self.tsv_path))

    def __len__(self):
        return len(self.rows)

    def resolve_audio(self, row: Dict[str, str]) -> str:
        cand = os.path.join(self.audio_root, row["audio"])
        if os.path.exists(cand):
            return cand
        return os.path.join(self.audio_root, os.path.basename(row["audio"]))

    def __getitem__(self, i: int) -> Dict:
        row = self.rows[i]
        wav, sr = read_audio(self.resolve_audio(row))
        if sr != WHISPER_SR:
            raise ValueError(f"{row['id']}: expected 16 kHz, got {sr}")
        left_str, right_str = prompt_strings(row["prompt"])
        item = {
            "id": row["id"],
            "wav": wav.astype(np.float32),
            "mel": whisper_log_mel(wav, pad_to_chunk=self.mel_chunk),
            "left_tokens": [self.bos_id] + list(self.tokenize(left_str)),
            "prompt_tokens": list(self.tokenize(right_str)),
            "target_text": row.get("tgt_text", ""),
        }
        if item["target_text"]:
            item["target_tokens"] = list(self.tokenize(item["target_text"])) + [self.eos_id]
        return item

    def collate(self, items: List[Dict], with_targets: bool = True) -> Dict[str, np.ndarray]:
        """Pad to the batch's maxima -> the keyword arguments of
        ``WavLLMModel.forward_sft`` / ``generate`` as numpy arrays (mel,
        mel_lengths, wav, wav_lengths, prompt_tokens, left_tokens[,
        target_tokens]), int32 tokens and lengths."""
        B = len(items)

        def pad_tokens(key):
            L = max(len(it[key]) for it in items)
            out = np.full((B, L), self.pad_id, np.int32)
            for b, it in enumerate(items):
                out[b, : len(it[key])] = it[key]
            return out

        mel_lengths = np.asarray([it["mel"].shape[0] for it in items], np.int32)
        wav_lengths = np.asarray([len(it["wav"]) for it in items], np.int32)
        mel = np.zeros((B, mel_lengths.max(), WHISPER_N_MELS), np.float32)
        wav = np.zeros((B, wav_lengths.max()), np.float32)
        for b, it in enumerate(items):
            mel[b, : it["mel"].shape[0]] = it["mel"]
            wav[b, : len(it["wav"])] = it["wav"]
        batch = {
            "mel": mel, "mel_lengths": mel_lengths,
            "wav": wav, "wav_lengths": wav_lengths,
            "prompt_tokens": pad_tokens("prompt_tokens"),
            "left_tokens": pad_tokens("left_tokens"),
        }
        if with_targets and all("target_tokens" in it for it in items):
            batch["target_tokens"] = pad_tokens("target_tokens")
        return batch
