"""The port's audio input held against the JAX package: FLAC decoding
through the native library (``data/native.py``: ``flac_info``,
``read_flac``), ``read_audio``'s dispatch and mix-down, chunked
resampling, and the native batcher, WAV batch reader and collator.

FLAC files are written by ``chip_smoke.write_flac`` (the smoke writes its
FLAC corpus with it): VERBATIM, CONSTANT and FIXED order 0-4 subframes with
Rice residuals, 16 and 24 bits, mono and stereo, and streams whose
STREAMINFO gives no length.  Decoded samples must equal JAX's bit for bit
and the written integers scaled by 2^-(bps-1); the STREAMINFO MD5 must be
the samples' own.  Resampling must match JAX's within 1e-6 absolute.
"""

import hashlib
import tracemalloc

import numpy as np
import pytest

import chip_smoke
from speecht5_tpu.data import audio as JA
from speecht5_tpu.data import native as JN
from speecht5_tpu_torch.data import audio as PA
from speecht5_tpu_torch.data import native as PN
from speecht5_tpu_torch.data import prep as PP


def _samples(n, bps, ch, seed):
    """Two tones and noise at ``bps`` bits, the first block one constant
    value (a CONSTANT subframe)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    amp = 0.4 * 2 ** (bps - 1)
    x = amp * np.sin(t * np.array([0.013, 0.021])[:ch]) + rng.normal(0, 2 ** (bps - 9), (n, ch))
    x = np.clip(np.round(x), -2 ** (bps - 1), 2 ** (bps - 1) - 1).astype(np.int64)
    x[:1024] = -5
    return x


# (bits, channels, FIXED order or None for VERBATIM, STREAMINFO gives the length)
FLAC_CASES = [(16, 1, None, True), (16, 1, 0, True), (16, 1, 1, True), (16, 1, 2, True),
              (16, 1, 3, True), (16, 1, 4, True), (24, 1, 2, True), (24, 1, None, True),
              (16, 2, None, True), (16, 2, 3, True), (24, 2, 4, True),
              (16, 1, 1, False), (24, 2, None, False)]


@pytest.mark.parametrize("bps,ch,order,total", FLAC_CASES)
def test_flac_decodes_bit_equal_to_jax_with_its_md5(tmp_path, bps, ch, order, total):
    x = _samples(5000, bps, ch, seed=bps + ch + (order or 0))
    path = str(tmp_path / "a.flac")
    md5 = chip_smoke.write_flac(path, x[:, 0] if ch == 1 else x, 16000, bps=bps,
                                order=order, block=1024, total_samples=total)
    width = {16: "<i2", 24: "<i4"}[bps]
    le = np.frombuffer(x.astype(width).tobytes(), np.uint8).reshape(-1, int(width[-1]))
    assert md5 == hashlib.md5(le[:, :bps // 8].tobytes()).digest()
    info = PN.flac_info(path)
    assert info == JN.flac_info(path)
    assert info == ((5000 if total else 0), 16000, ch, bps, md5)
    raw, sr = PN.read_flac(path, normalize=False)
    assert sr == 16000 and np.array_equal(raw.reshape(5000, ch), x)
    got, sr = PA.read_audio(path)
    ref, jsr = JA.read_audio(path)
    assert sr == jsr == 16000 and got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)
    scaled = x.astype(np.float32) / float(1 << (bps - 1))
    assert np.array_equal(got, scaled[:, 0] if ch == 1 else scaled.mean(axis=-1))
    assert PP.flac_num_samples(path) == (5000 if total else 0)


def test_flac_crcs_are_the_formats():
    """CRC-8 (poly 0x07) and CRC-16 (poly 0x8005) on the standard check
    string: 0xF4 and 0xFEE8; leading zero bytes change no CRC-16."""
    crc8 = 0
    for b in b"123456789":
        crc8 = int(chip_smoke.CRC8[crc8 ^ b])
    assert crc8 == 0xF4
    crcs = chip_smoke._crc16_frames([b"123456789", b"\x00\x00123456789", b"1"])
    assert crcs.tolist()[:2] == [0xFEE8, 0xFEE8]


def test_non_flac_file_is_refused_on_both_sides(tmp_path):
    path = str(tmp_path / "x.flac")
    JA.write_wav(path, np.zeros(800, np.float32))
    for read in (PA.read_audio, JA.read_audio, PP.flac_num_samples):
        with pytest.raises(ValueError):
            read(path)


def test_wav_read_and_mixdown_equal_jax(tmp_path):
    import wave

    rng = np.random.default_rng(1)
    pcm = rng.integers(-20000, 20000, (3000, 2)).astype("<i2")
    path = str(tmp_path / "s.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(22050)
        f.writeframes(pcm.tobytes())
    for target in (None, 16000):
        got, sr = PA.read_audio(path, target_sr=target)
        ref, jsr = JA.read_audio(path, target_sr=target)
        assert sr == jsr and np.array_equal(got, ref)


@pytest.mark.parametrize("sr_in", [8000, 44100, 48000, 16000])
def test_resample_matches_jax(sr_in):
    x = (0.3 * np.random.default_rng(sr_in).standard_normal(sr_in // 2)).astype(np.float32)
    got, ref = PA.resample(x, sr_in, 16000), JA.resample(x, sr_in, 16000)
    assert got.dtype == np.float32 and got.shape == ref.shape == (8000,)
    assert np.abs(got - ref).max() <= 1e-6


def test_read_audio_resamples_flac_on_read_as_jax(tmp_path):
    x = _samples(48000, 16, 1, seed=3)[:, 0]
    path = str(tmp_path / "hi.flac")
    chip_smoke.write_flac(path, x, 48000)
    got, sr = PA.read_audio(path, target_sr=16000)
    ref, jsr = JA.read_audio(path, target_sr=16000)
    assert sr == jsr == 16000 and got.shape == ref.shape == (16000,)
    assert np.abs(got - ref).max() <= 1e-6


def test_resample_memory_does_not_grow_with_the_file():
    """60 s of 44.1 kHz noise (JAX's version would build [960000, 91] f64
    temporaries, several GB, so it is not run here) within 64 MB of
    traced memory, the 10.6 MB input included."""
    x = (0.3 * np.random.default_rng(0).standard_normal(60 * 44100)).astype(np.float32)
    tracemalloc.start()
    try:
        y = PA.resample(x, 44100, 16000)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert y.shape == (960000,) and np.isfinite(y).all()
    assert peak < 64 * 2 ** 20, peak


def _wavs(tmp_path, rng):
    paths = []
    for i in range(3):
        p = str(tmp_path / f"x{i}.wav")
        JA.write_wav(p, np.clip(rng.standard_normal(4000 + 500 * i) * 0.2, -1, 1))
        paths.append(p)
    return paths + [str(tmp_path / "missing.wav")]


@pytest.mark.parametrize("case", ["batch_by_size", "batch_by_size_max_sentences",
                                  "read_wav_batch", "collate_tokens"])
def test_native_batcher_reader_and_collator_equal_jax(tmp_path, case):
    rng = np.random.default_rng(0)
    if case.startswith("batch_by_size"):
        sizes = rng.integers(10, 5000, 500)
        kw = {"max_sentences": 4} if case.endswith("sentences") else {}
        got, ref = PN.batch_by_size_native(sizes, 20000, **kw), JN.batch_by_size_native(
            sizes, 20000, **kw)
        assert len(got) == len(ref) > 10
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
        assert sorted(int(i) for b in got for i in b) == list(range(500))
    elif case == "read_wav_batch":
        paths = _wavs(tmp_path, rng)
        (out, lengths), (jout, jlengths) = (PN.read_wav_batch_native(paths, 4800),
                                            JN.read_wav_batch_native(paths, 4800))
        assert lengths.tolist() == jlengths.tolist() == [4000, 4500, 4800, -1]
        assert np.array_equal(out, jout) and not out[0, 4000:].any()
    else:
        toks = [rng.integers(4, 80, n) for n in (5, 9, 1, 12)]
        got, ref = (PN.collate_tokens_native(toks, 10, pad_id=1, eos_id=2),
                    JN.collate_tokens_native(toks, 10, pad_id=1, eos_id=2))
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
        assert got[1][0, 0] == 2 and (got[0][2, 1:] == 1).all()
