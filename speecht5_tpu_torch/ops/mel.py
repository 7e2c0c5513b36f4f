"""Log-mel filterbank, librosa parity (the port's copy of
``speecht5_tpu/ops/mel.py``, which imports JAX).

The reference computes fbanks on the host per utterance with librosa
(reference text_to_speech_dataset.py:97-138: STFT(n_fft=1024, hop=256,
hann, center/reflect) -> |mag| -> mel(80, fmin 80, fmax 7600, slaney norm)
-> log10(max(1e-10, .))).  ``log_mel_spectrogram`` is the all-product
formulation on tensors and the plain twin of the log-mel kernel; the train
step's batched call (JAX ``device_log_mel``) is the kernel's wrapper
``ops/cuda_kernels.fused_log_mel``, which takes this twin on CPU tensors;
``log_mel_numpy`` is the host path (numpy rfft, float64) of ``--host-mel``.

The filterbank and the DFT tables are built in float64 numpy and cast to
f32, as the JAX package does.  No product here may run in TF32 or bf16:
reduced precision distorts the low-energy bins after the log, which is why
the JAX graph forces ``Precision.HIGHEST`` (mel.py:124-126).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann, matching scipy.signal.get_window('hann', n, fftbins=True)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel(f):
    """Slaney mel scale (librosa htk=False): linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    # maximum() keeps the unused log branch finite at f=0
    log_branch = min_log_mel + np.log(
        np.maximum(f, 1e-10) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, mel)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freq = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freq)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int = 16000, n_fft: int = 1024, n_mels: int = 80,
                   fmin: float = 80.0, fmax: float = 7600.0) -> np.ndarray:
    """librosa.filters.mel parity (slaney norm, htk=False): [n_mels, 1 + n_fft//2]
    f32.  Cached: treat the result as read-only."""
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int) -> tuple:
    """Real/imag DFT bases [n_fft, n_bins] f32 so the DFT runs as a product.
    Cached: treat the results as read-only."""
    n_bins = 1 + n_fft // 2
    t = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def frame_signal(wav, n_fft: int, hop: int, center: bool = True):
    """[..., T] -> [..., n_frames, n_fft] (a strided view), with reflect
    padding when ``center``."""
    if center:
        shape = wav.shape
        wav = F.pad(wav.reshape(-1, 1, shape[-1]), (n_fft // 2, n_fft // 2),
                    mode="reflect").reshape(*shape[:-1], -1)
    return wav.unfold(-1, n_fft, hop)


def log_mel_spectrogram(wav, *, sr: int = 16000, n_fft: int = 1024,
                        hop: int = 256, n_mels: int = 80, fmin: float = 80.0,
                        fmax: float = 7600.0, eps: float = 1e-10,
                        center: bool = True):
    """[..., T] waveform -> [..., n_frames, n_mels] f32 log10-mel.

    n_frames = 1 + T // hop (center=True), 1 + (T - n_fft) // hop
    (center=False: the batched train path reflect-pads each utterance on the
    host before batch zero-padding).  All-product formulation: windowed
    frames times the DFT bases, |mag| times the mel matrix, all in f32."""
    x = wav.float()
    frames = frame_signal(x, n_fft, hop, center=center)
    dev = x.device
    win = torch.from_numpy(hann_window(n_fft)).to(dev)
    cos_b, sin_b = (torch.from_numpy(m).to(dev) for m in _dft_matrices(n_fft))
    frames = frames * win
    re = frames @ cos_b
    im = frames @ sin_b
    mag = torch.sqrt(re * re + im * im + 1e-30)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(dev)
    mel = mag @ fb.t()
    return torch.log10(torch.clamp_min(mel, eps))


def log_mel_numpy(wav: np.ndarray, **kw) -> np.ndarray:
    """Host-side reference path (numpy rfft, float64) for the data pipeline
    and the tests: [T] -> [1 + T // hop, n_mels] f32, center=True."""
    sr = kw.get("sr", 16000)
    n_fft = kw.get("n_fft", 1024)
    hop = kw.get("hop", 256)
    n_mels = kw.get("n_mels", 80)
    fmin = kw.get("fmin", 80.0)
    fmax = kw.get("fmax", 7600.0)
    eps = kw.get("eps", 1e-10)
    x = np.pad(wav.astype(np.float64), (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[idx] * hann_window(n_fft).astype(np.float64)
    mag = np.abs(np.fft.rfft(frames, axis=-1))
    mel = mag @ mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T.astype(np.float64)
    return np.log10(np.maximum(eps, mel)).astype(np.float32)


def mel_to_audio(log10_mel, *, sr: int = 16000, n_fft: int = 1024, hop: int = 256,
                 n_mels: int = 80, fmin: float = 80.0, fmax: float = 7600.0,
                 n_iter: int = 48, seed: int = 0) -> torch.Tensor:
    """Invert a log10-mel spectrogram [T, n_mels] (a tensor on any device,
    or a numpy array) to a waveform [T * hop] f32 on the same device, by
    Griffin-Lim (JAX ops/mel.py:148, the same iterations and initial phase):
    the least-squares linear magnitude pinv(filterbank) . 10**mel clipped
    at 0, a random initial phase drawn by numpy's ``default_rng(seed)``,
    then ``n_iter`` rounds of ``torch.istft`` / ``torch.stft`` (hann,
    centred, reflect-padded as numpy pads), all in float64; the result is scaled to a
    peak of at most 1.  The checkpoint-free vocoder of ``/tts
    --griffin-lim``."""
    mel = torch.as_tensor(log10_mel)
    dev = mel.device
    f64 = dict(dtype=torch.float64, device=dev)
    mel = torch.pow(10.0, mel.to(torch.float64))
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax), **f64)
    mag = torch.clamp_min(torch.linalg.pinv(fb) @ mel.T, 0.0)    # [bins, T]
    win = torch.as_tensor(hann_window(n_fft), **f64)
    n_frames = mag.shape[1]
    length = n_frames * hop
    rng = np.random.default_rng(seed)
    angles = torch.exp(2j * np.pi * torch.as_tensor(rng.random(tuple(mag.shape)), **f64))

    def istft(spec):
        return torch.istft(spec, n_fft, hop, window=win, center=True, length=length)

    # numpy's reflect padding, which also pads a signal shorter than n_fft / 2
    # (a few frames), as the JAX function's np.pad does
    pad_idx = torch.as_tensor(np.pad(np.arange(length), n_fft // 2, mode="reflect"),
                              device=dev)

    def stft(wav):
        return torch.stft(wav[pad_idx], n_fft, hop, window=win, center=False,
                          return_complex=True)[:, :n_frames]

    for _ in range(n_iter):
        spec = stft(istft(mag * angles))
        angles = spec / torch.clamp_min(spec.abs(), 1e-8)
    wav = istft(mag * angles)
    peak = wav.abs().max()
    wav = torch.where(peak > 1.0, wav / peak, wav)
    return wav.to(torch.float32)
