"""Waveform IO without external audio libraries (the port's copy of
``speecht5_tpu/data/audio.py``: PCM WAV through the standard library).
FLAC decoding goes through the JAX package's native library there and is
not ported yet."""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono waveform, sample_rate)."""
    if path.lower().endswith(".flac"):
        raise NotImplementedError(
            f"{path}: FLAC decoding is not ported yet; convert to WAV")
    return read_wav(path)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def write_wav(path: str, wav: np.ndarray, sr: int = 16000):
    x = np.clip(wav, -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def layer_norm_wav(wav: np.ndarray) -> np.ndarray:
    """Per-utterance normalization (reference speech_to_text_dataset.py
    :259-269 applies F.layer_norm over the waveform when task.normalize)."""
    m = wav.mean()
    v = wav.var()
    return (wav - m) / np.sqrt(v + 1e-5)
