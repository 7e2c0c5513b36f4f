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


@pytest.mark.parametrize("n_fft,n_mels,fmin,fmax", [
    (1024, 80, 80.0, 7600.0), (512, 24, 80.0, 7600.0), (256, 128, 0.0, 8000.0)])
def test_log_mel_sparse_filterbank_unpacks_to_the_dense_one(n_fft, n_mels, fmin, fmax):
    """The kernel's sparse filterbank (per mel a [start, start + len) slice,
    its weights in column m, zero below len) unpacks to ``mel_filterbank``
    exactly, mels with no non-zero weight included; the window is the
    twin's."""
    win, tw, fb_w, fb_idx = K.log_mel_tables(n_fft, n_mels, 16000, fmin, fmax, "cpu")
    dense = JM.mel_filterbank(16000, n_fft, n_mels, fmin, fmax)
    got = np.zeros_like(dense)
    for m, (start, n) in enumerate(fb_idx.numpy()):
        got[m, start : start + n] = fb_w.numpy()[:n, m]
        assert (fb_w.numpy()[n:, m] == 0).all()
    np.testing.assert_array_equal(got, dense)
    assert fb_idx[:, 1].sum().item() == np.count_nonzero(dense)   # no zero inside
    assert fb_w.shape == (fb_idx[:, 1].max().item(), n_mels)
    np.testing.assert_array_equal(win.numpy(), JM.hann_window(n_fft))
    assert tw.shape == (3 * n_fft // 2, 2) and fb_idx.dtype == torch.int32
    assert K.log_mel_tables(n_fft, n_mels, 16000, fmin, fmax, "cpu")[0] is win


def _dif(a, N, tw):
    """Radix-2 DIF over the last axis, as the kernel runs it (in registers,
    or across a warp's lanes by shuffles): output in bit-reversed order."""
    a, L = a.copy(), a.shape[-1]
    h = L // 2
    while h >= 1:
        j = np.arange(h)
        for s in range(0, L, 2 * h):
            u, v = a[..., s + j], a[..., s + j + h]
            a[..., s + j], a[..., s + j + h] = u + v, (u - v) * tw[j * (N // (2 * h))]
        h //= 2
    return a


def _bitrev(k, bits):
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def _kernel_model(wav, n_fft, hop, n_mels, center, eps=1e-10):
    """numpy model of the log-mel kernel's algorithm on its own f32 tables:
    framing (reflect padding when ``center``), the windowed samples packed
    as z[n] = x[2n] + i x[2n+1], the four-step FFT of M = N1 x 32 points in
    complex64 (an N1-point DIF per lane over z[lane + 32 n1], the middle
    twiddles, a 32-point DIF across the lanes; lane l holds Z[k1 + N1
    bitrev5(l)]), the split into the real transform's bins, the
    magnitudes, the sparse filterbank and the log."""
    win, tw, fb_w, fb_idx = (t.numpy() for t in
                             K.log_mel_tables(n_fft, n_mels, 16000, 80.0, 7600.0, "cpu"))
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    N, M = n_fft, n_fft // 2
    N1, tw_n, tw_m = M // 32, tw[:n_fft], tw[n_fft:]
    frames = PM.frame_signal(torch.from_numpy(wav), n_fft, hop, center).numpy() * win
    z = (frames[..., 0::2] + 1j * frames[..., 1::2]).astype(np.complex64)
    a = _dif(np.swapaxes(z.reshape(*z.shape[:-1], N1, 32), -1, -2), N, tw_n)  # [lane, n1]
    a = a[..., [_bitrev(k, N1.bit_length() - 1) for k in range(N1)]]
    c = _dif(np.swapaxes(a * tw_m.reshape(N1, 32).T, -1, -2), N, tw_n)       # [k1, lane]
    Z = np.empty_like(z)
    for lane in range(32):
        Z[..., np.arange(N1) + N1 * _bitrev(lane, 5)] = c[..., lane]
    kk = np.arange(M + 1)
    za, zc = Z[..., kk & (M - 1)], np.conj(Z[..., (M - kk) & (M - 1)])
    e, dd = np.complex64(0.5) * (za + zc), np.complex64(0.5) * (za - zc)
    X = e + tw_n[: M + 1] * (dd.imag - 1j * dd.real).astype(np.complex64)
    mag = np.sqrt(X.real * X.real + X.imag * X.imag + np.float32(1e-30))
    mel = np.stack([mag[..., s : s + n] @ fb_w[:n, m] for m, (s, n) in enumerate(fb_idx)],
                   -1)
    return np.log10(np.maximum(np.float32(eps), mel))


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n_fft,hop,n_mels", [(512, 128, 24), (1024, 256, 80),
                                              (256, 64, 40), (2048, 512, 80)])
def test_fft_model_of_the_log_mel_kernel_matches_the_twin(n_fft, hop, n_mels, center):
    """The kernel's algorithm and table layout, checked here because the
    kernel itself runs only on the card: the numpy model agrees with the
    twin (the f32 all-product DFT) within 1e-5 on log10-mel at every FFT
    size the kernel takes (N1 = 4, 8, 16, 32), and a zero tail gives the
    floor exactly."""
    wav = _wav((2, 6000), seed=n_fft)
    wav[-1, 3000:] = 0.0
    want = K.fused_log_mel_plain(torch.from_numpy(wav), n_fft=n_fft, hop=hop,
                                 n_mels=n_mels, center=center).numpy()
    got = _kernel_model(wav, n_fft, hop, n_mels, center)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[-1, -2:] == np.log10(np.float32(1e-10))).all()    # the floor


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
