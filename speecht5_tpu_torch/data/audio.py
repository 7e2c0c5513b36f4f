"""Waveform IO without external audio libraries (the port's copy of
``speecht5_tpu/data/audio.py``): PCM WAV through the standard library,
FLAC through the native decoder (``csrc/flac.cpp``, loaded by the port's
``data/native.py``), and windowed-sinc resampling."""

from __future__ import annotations

import wave
from math import ceil, gcd
from typing import Tuple

import numpy as np

# output samples a resampling chunk computes: its [chunk, taps] f64
# temporaries stay a few MB whatever the file's length
RESAMPLE_CHUNK = 2048


def read_audio(path: str, target_sr: int = None) -> Tuple[np.ndarray, int]:
    """Read WAV or FLAC by extension -> (float32 mono waveform, sample_rate);
    a multi-channel file is mixed down by the mean of its channels.
    ``target_sr`` resamples on read (JAX audio.py:18-34)."""
    if path.lower().endswith(".flac"):
        from .native import read_flac

        wav, sr = read_flac(path, normalize=True)
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        wav = wav.astype(np.float32)
    else:
        wav, sr = read_wav(path)
    if target_sr is not None and sr != target_sr:
        return resample(wav, sr, target_sr), target_sr
    return wav, sr


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


def resample(wav: np.ndarray, sr_in: int, sr_out: int = 16000,
             num_zeros: int = 16) -> np.ndarray:
    """Rational windowed-sinc resampling with JAX audio.py:68-103's filter:
    output j sits at input position j*M/L (L/M = sr_out/sr_in reduced) and
    is the window's input samples weighted by a Hann-windowed sinc cut at
    min(sr_in, sr_out)/2, ``num_zeros`` zero-crossings a side, summed in
    f64 and returned as f32.  JAX builds [n_out, taps] f64 temporaries at
    once (several GB for a minute of audio); here they are built
    ``RESAMPLE_CHUNK`` outputs at a time, and the filter row of each
    distinct phase (j*M mod L) of a chunk once, from the exact fraction
    (JAX's j*M/L in f64 moves it by ~1e-10)."""
    if sr_in == sr_out:
        return wav.astype(np.float32)
    g = gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    n_in = len(wav)
    n_out = int(ceil(n_in * L / M))
    fc_rel = 0.5 * min(1.0, L / M)
    radius = int(ceil(num_zeros / (2.0 * fc_rel)))
    taps = np.arange(2 * radius + 1)
    out = np.empty(n_out, np.float32)
    for j0 in range(0, n_out, RESAMPLE_CHUNK):
        pos = np.arange(j0, min(j0 + RESAMPLE_CHUNK, n_out), dtype=np.int64) * M
        phases, row = np.unique(pos % L, return_inverse=True)
        dt = (taps - radius)[None, :] - (phases / L)[:, None]
        win = 0.5 * (1.0 + np.cos(np.pi * dt / (radius + 1)))
        hmat = 2.0 * fc_rel * np.sinc(2.0 * fc_rel * dt) * win
        idx = (pos // L - radius)[:, None] + taps[None, :]
        valid = (idx >= 0) & (idx < n_in)
        samples = np.where(valid, wav[np.clip(idx, 0, n_in - 1)].astype(np.float64), 0.0)
        out[j0 : j0 + len(pos)] = (hmat[row] * samples).sum(axis=1)
    return out


def layer_norm_wav(wav: np.ndarray) -> np.ndarray:
    """Per-utterance normalization (reference speech_to_text_dataset.py
    :259-269 applies F.layer_norm over the waveform when task.normalize)."""
    m = wav.mean()
    v = wav.var()
    return (wav - m) / np.sqrt(v + 1e-5)
