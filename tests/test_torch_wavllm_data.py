"""``data/wavllm.py`` in the port, bit-equal to the JAX package's.

On a reference-format TSV and WAVs the test writes itself (the reference's
fixtures are not in the repository): the Whisper log-mel (30 s chunk and
unpadded, trimmed past 30 s), the chat template's strings, each item's
waveform, mel and tokens, every collated array with and without targets,
the basename fallback for a stale audio path, the skipped short row, and
the refusal of another sample rate.
"""

import os

import numpy as np
import pytest

from speecht5_tpu.data import wavllm as JD

import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch.data import wavllm as PD
from speecht5_tpu_torch.data.audio import write_wav


def tokenize(text):
    """A BOS / EOS-free byte tokenizer into a vocabulary of 48."""
    return [4 + (b % 44) for b in text.encode("utf-8")]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three clips (0.4-2.2 s) listed in a TSV: one by a stale absolute
    path (resolved by its basename), one by its relative path, one with no
    target; a short row that both loaders skip."""
    d = tmp_path_factory.mktemp("wavllm")
    rng = np.random.default_rng(0)
    rows = ["id\taudio\tn_frames\tprompt\ttgt_text\twith_speech"]
    for i, secs in enumerate((1.3, 0.4, 2.2)):
        n = int(secs * 16000)
        wav = 0.3 * np.sin(np.arange(n) * 0.05 * (i + 1)) + 0.05 * rng.standard_normal(n)
        write_wav(str(d / f"a{i}.wav"), wav.astype(np.float32))
        audio = f"/stale/place/a{i}.wav" if i == 0 else f"a{i}.wav"
        target = ["hello world", "a longer answer, with punctuation!", ""][i]
        rows.append(f"u{i}\t{audio}\t{n}\tTranscribe clip {i}.\t{target}\tTrue")
    rows.append("short\trow")
    (d / "t.tsv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    write_wav(str(d / "low.wav"), np.zeros(800, np.float32), sr=8000)
    (d / "low.tsv").write_text("id\taudio\tn_frames\tprompt\ttgt_text\twith_speech\n"
                               "low\tlow.wav\t800\tx\ty\tTrue\n", encoding="utf-8")
    return d


def same(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (msg, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def test_constants_and_prompt_strings_equal_jax():
    for name in ("B_INST", "E_INST", "B_SYS", "E_SYS", "B_SPEECH", "E_SPEECH", "SYSTEM",
                 "WHISPER_SR", "WHISPER_N_FFT", "WHISPER_HOP", "WHISPER_N_MELS",
                 "WHISPER_CHUNK_SAMPLES"):
        assert getattr(PD, name) == getattr(JD, name), name
    assert PD.prompt_strings("Say it.") == JD.prompt_strings("Say it.")


@pytest.mark.parametrize("samples, chunk", [(16000, False), (23456, True), (16000, True),
                                            (PD.WHISPER_CHUNK_SAMPLES + 5000, True)])
def test_whisper_log_mel_is_bit_equal_to_jax(samples, chunk):
    wav = (np.random.default_rng(samples).standard_normal(samples) * 0.1).astype(np.float32)
    got = PD.whisper_log_mel(wav, pad_to_chunk=chunk)
    same(got, JD.whisper_log_mel(wav, pad_to_chunk=chunk))
    assert got.shape == ((3000 if chunk else samples // 160), 80)


@pytest.mark.parametrize("mel_chunk", [False, True])
def test_items_and_collates_are_bit_equal_to_jax(corpus, mel_chunk):
    kw = dict(mel_chunk=mel_chunk, bos_id=1, eos_id=2, pad_id=0)
    pds = PD.WavLLMDataset(str(corpus / "t.tsv"), tokenize, **kw)
    jds = JD.WavLLMDataset(str(corpus / "t.tsv"), tokenize, **kw)
    assert len(pds) == len(jds) == 3
    assert pds.rows == jds.rows == PD.load_wavllm_tsv(str(corpus / "t.tsv"))
    assert pds.resolve_audio(pds.rows[0]) == str(corpus / "a0.wav")
    items = []
    for i in range(3):
        p, j = pds[i], jds[i]
        assert set(p) == set(j), i
        for k in p:
            if isinstance(p[k], np.ndarray):
                same(p[k], j[k], f"{i} {k}")
            else:
                assert p[k] == j[k], (i, k)
        items.append((p, j))
    assert items[0][0]["left_tokens"][0] == 1 and items[0][0]["target_tokens"][-1] == 2
    for sel in ([0, 1], [0, 1, 2]):
        for targets in (True, False):
            pc = pds.collate([items[i][0] for i in sel], with_targets=targets)
            jc = jds.collate([items[i][1] for i in sel], with_targets=targets)
            assert set(pc) == set(jc), (sel, targets)
            assert ("target_tokens" in pc) == (targets and 2 not in sel)
            for k in pc:
                same(pc[k], jc[k], f"{sel} {targets} {k}")


def test_another_sample_rate_is_refused_as_jax_refuses(corpus):
    for mod in (PD, JD):
        with pytest.raises(ValueError, match="16 kHz"):
            mod.WavLLMDataset(str(corpus / "low.tsv"), tokenize)[0]
    assert os.path.exists(corpus / "low.wav")
