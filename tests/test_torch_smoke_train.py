"""The CPU rehearsal of ``chip_smoke.py``'s s2t train and train-parity phases,
and of the train phase's FLAC corpus with its prep chain, at the tiny
preset, in a file of its own so that ``--dist loadfile`` runs it on a worker
of its own (moved from tests/test_torch_hygiene.py, names kept)."""

import os

import chip_smoke
import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch import config as C


def test_chip_smoke_train_phases_run_on_cpu_with_twins(tmp_path):
    """The train phase (cli/train.main, resume) and the train parity phase
    at the tiny preset on the CPU: the kernels' twins run, so no launches;
    every encoder layer runs (the tiny preset has no layerdrop)."""
    flags = ["--batch-size", "2", "--accum", "2", "--ctc-weight", "0.5",
             "--normalize"]
    trained = chip_smoke.phase_train(str(tmp_path), "speecht5_tiny", device="cpu",
                                     n_utts=4, updates=2, seconds=(0.3, 0.8),
                                     flags=flags)
    assert set(trained["counts"].values()) == {0}
    assert trained["layer_runs"] == 2 * 2 * 2 and len(trained["history"]) == 3
    parity = chip_smoke.phase_train_parity(C.speecht5_tiny(), device="cpu",
                                           batch=2, seconds=(0.8, 1.2))
    assert parity["loss_rel_diff"] < 1e-5


def test_chip_smoke_flac_corpus_and_prep_chain_run_on_cpu(tmp_path):
    """The train phase's corpus: even utterances 16 kHz FLAC, odd ones 48 kHz
    FLAC resampled by cli/prep.py to 16 kHz WAV; the manifest lists both
    kinds with their decoded lengths, the labels follow its order."""
    from speecht5_tpu_torch.data.audio import read_audio
    from speecht5_tpu_torch.data.native import flac_info

    manifest, labels, dict_path, secs = chip_smoke.write_flac_corpus(
        str(tmp_path), 5, seconds=(0.3, 0.6), seed=2)
    rows = [l.split("\t") for l in open(manifest).read().splitlines()[1:]]
    assert sorted(r for r, _ in rows) == ["utt0.flac", "utt1.wav", "utt2.flac", "utt3.wav",
                                         "utt4.flac"]
    assert set(secs) == {"write_flac", "resample", "manifest_wrd2ltr", "decode_check"}
    n48, *fmt, _ = flac_info(str(tmp_path / "raw48k" / "utt1.flac"))
    assert fmt == [48000, 1, 16] and dict(rows)["utt1.wav"] == str(-(-n48 // 3))
    wav, sr = read_audio(str(tmp_path / "audio" / "utt0.flac"))
    assert sr == 16000 and not wav[:chip_smoke.FLAC_BLOCK].any() and wav.any()
    ltr = open(labels).read().splitlines()
    assert len(ltr) == 5 and all(l.endswith("|") for l in ltr)
    assert os.path.basename(dict_path) == "dict.ltr.txt"
