"""The port's log-mel path held against the JAX package's.

The same seeded numpy waveforms go through ``speecht5_tpu/ops/mel.py``
(XLA graph at ``highest`` matmul precision, tests/conftest.py), the Pallas
``fused_log_mel`` in interpret mode, and the port's ``ops/mel.py`` and
``fused_log_mel`` (its plain twin: the tensors lie on the CPU).  Cases
are the specification's (tests/test_pallas_kernels.py:14-44,
tests/test_device_mel.py:39-106): n_fft 512 / hop 128 / 24 mels, a frame
count that is not a multiple of the Pallas block, center=False on a
reflect-padded waveform, and the t2s collator's device-mel batches.

Tolerances: the filterbank, the DFT tables and the numpy host path are the
same float64 numpy arithmetic, so they must be equal; log10-mel values
within 2e-3 absolute (the JAX spec's atol for the kernel), and 1e-4 where
both sides are the same f32 product formulation.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from speecht5_tpu.data.manifests import collate_mel_targets as jax_collate
from speecht5_tpu.ops import mel as JM
from speecht5_tpu.ops.pallas_kernels import fused_log_mel as pallas_log_mel
from speecht5_tpu.train.trainer import device_mel_batch as jax_device_mel_batch

import torch

from speecht5_tpu_torch.data.manifests import MEL_HOP, MEL_N_FFT, collate_mel_targets
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.ops import mel as PM
from speecht5_tpu_torch.train.trainer import device_mel_batch

N_MELS, R = 24, 2


def _wav(shape, seed=0, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (16000, 1024, 80, 80.0, 7600.0), (16000, 512, 24, 80.0, 7600.0),
    (16000, 400, 80, 0.0, 8000.0)])
def test_filterbank_window_and_dft_tables_equal_jax(sr, n_fft, n_mels, fmin, fmax):
    np.testing.assert_array_equal(PM.mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                                  JM.mel_filterbank(sr, n_fft, n_mels, fmin, fmax))
    np.testing.assert_array_equal(PM.hann_window(n_fft), JM.hann_window(n_fft))
    for a, b in zip(PM._dft_matrices(n_fft), JM._dft_matrices(n_fft)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PM._hz_to_mel([0.0, 500.0, 4000.0]),
                                  JM._hz_to_mel([0.0, 500.0, 4000.0]))
    np.testing.assert_array_equal(PM._mel_to_hz([1.0, 20.0, 40.0]),
                                  JM._mel_to_hz([1.0, 20.0, 40.0]))


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n_fft,hop,n_mels,T", [(512, 128, 24, 5000), (1024, 256, 80, 8000)])
def test_log_mel_spectrogram_and_host_path_match_jax(center, n_fft, hop, n_mels, T):
    wav = _wav((2, T), seed=T)
    kw = dict(n_fft=n_fft, hop=hop, n_mels=n_mels, center=center)
    want = np.asarray(JM.log_mel_spectrogram(jnp.asarray(wav), **kw))
    got = PM.log_mel_spectrogram(torch.from_numpy(wav), **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    frames = PM.frame_signal(torch.from_numpy(wav), n_fft, hop, center).numpy()
    jframes = np.asarray(JM.frame_signal(jnp.asarray(wav), n_fft, hop, center))
    np.testing.assert_array_equal(frames, jframes)
    host = PM.log_mel_numpy(wav[0], n_fft=n_fft, hop=hop, n_mels=n_mels)
    np.testing.assert_array_equal(host, JM.log_mel_numpy(wav[0], n_fft=n_fft, hop=hop,
                                                         n_mels=n_mels))


@pytest.mark.parametrize("shape,block,center", [
    ((2, 16000), 32, True),        # tests/test_pallas_kernels.py:15
    ((1, 12800), 16, True),        # :26
    ((1, 5000), 32, True),         # :36, frames not a multiple of the block
    ((1, 2048 + MEL_N_FFT), 8, False),  # tests/test_device_mel.py:64
])
def test_fused_log_mel_twin_matches_pallas_interpret(shape, block, center):
    wav = _wav(shape, seed=shape[1])
    if center:
        kw = dict(n_fft=512, hop=128, n_mels=24, center=True)
    else:   # a reflect-padded utterance, framed as given
        wav = np.pad(wav[:, : shape[1] - MEL_N_FFT],
                     ((0, 0), (MEL_N_FFT // 2, MEL_N_FFT // 2)), mode="reflect")
        kw = dict(n_mels=N_MELS, center=False)
    want = np.asarray(pallas_log_mel(jnp.asarray(wav), block_frames=block, **kw))
    K.reset_launch_counts()
    got = K.fused_log_mel(torch.from_numpy(wav), **kw)
    assert K.fused_log_mel.launches == 0       # the CPU takes the twin
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    np.testing.assert_array_equal(
        got.numpy(), K.fused_log_mel_plain(torch.from_numpy(wav), **kw).numpy())


def test_log_mel_tables_fold_the_window_as_the_tpu_kernel():
    cosw, sinw, fb = K.log_mel_tables(512, 24, 16000, 80.0, 7600.0, "cpu")
    cos_b, sin_b = JM._dft_matrices(512)
    win = JM.hann_window(512)[:, None]
    np.testing.assert_array_equal(cosw.numpy(), cos_b * win)
    np.testing.assert_array_equal(sinw.numpy(), sin_b * win)
    np.testing.assert_array_equal(fb.numpy(), JM.mel_filterbank(16000, 512, 24).T)
    assert K.log_mel_tables(512, 24, 16000, 80.0, 7600.0, "cpu")[0] is cosw


def _items(lengths, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for i, n in enumerate(lengths):
        wav = (0.3 * np.sin(np.arange(n) * (0.02 + 0.01 * i))
               + 0.01 * rng.standard_normal(n)).astype(np.float32)
        items.append({"id": i, "tgt_wav_raw": wav,
                      "mel": JM.log_mel_numpy(wav, n_mels=N_MELS)})
    return items


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("lengths", [(2000, 1537, 2600), (900, 900)])
def test_device_mel_batch_matches_jax(lengths, bucketed):
    """tests/test_device_mel.py:81-106: the device-mode collation and
    device_mel_batch against JAX's, and against the host collator; padding
    rows exactly 0."""
    items = _items(lengths)
    dev = collate_mel_targets(items, R, N_MELS, bucketed=bucketed, device_mel=True)
    jdev = jax_collate(items, R, N_MELS, bucketed=bucketed, device_mel=True)
    assert dev.keys() == jdev.keys()
    for k in dev:
        np.testing.assert_array_equal(dev[k], jdev[k])
    assert (dev["tgt_wav"].shape[1] - MEL_N_FFT) % MEL_HOP == 0
    out = device_mel_batch({k: torch.from_numpy(v) for k, v in dev.items()}, N_MELS, R)
    jout = jax_device_mel_batch({k: jnp.asarray(v) for k, v in jdev.items()}, N_MELS, R)
    assert "tgt_wav" not in out and set(out) == set(jout)
    host = collate_mel_targets(items, R, N_MELS, bucketed=bucketed, device_mel=False)
    for k in ("target_mel", "prev_mel"):
        got = out[k].numpy()
        np.testing.assert_allclose(got, np.asarray(jout[k]), atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(got, host[k], atol=2e-3, rtol=1e-3)
    for b, n in enumerate(host["dec_lengths"]):
        assert (out["target_mel"][b, n:] == 0).all()
        assert (out["prev_mel"][b, host["dec_lengths_r"][b]:] == 0).all()
    passthrough = {"target_mel": torch.zeros(1)}
    assert device_mel_batch(passthrough, N_MELS, R) is passthrough
