"""The CPU rehearsal of ``chip_smoke.py``'s t2s train and t2s parity phases at
the tiny preset, in a file of its own so that ``--dist loadfile`` runs it on
a worker of its own (moved from tests/test_torch_hygiene.py, names kept)."""

import pytest

import chip_smoke
import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch import config as C


def test_chip_smoke_t2s_phases_run_on_cpu_with_twins():
    """The t2s train phase (cli/train.main --task t2s with device mels,
    resume) and the t2s parity phase at the tiny preset on the CPU: the
    twins run, so no launches; every text-encoder layer runs once per
    micro-batch (the tiny preset has no layerdrop)."""
    flags = ["--guided-attn", "--batch-size", "2", "--accum", "2"]
    trained = chip_smoke.phase_train_t2s("speecht5_tiny", device="cpu", n_utts=4,
                                         updates=2, seconds=(0.3, 0.8), flags=flags)
    assert set(trained["counts"].values()) == {0}
    assert trained["micro_batches"] == 4 and trained["layer_runs"] == 2 * 4
    assert len(trained["history"]) == 3
    with pytest.raises(AssertionError, match="t2s path launches wrong"):
        chip_smoke.check_t2s_counts(trained)     # the card's launch check
    parity = chip_smoke.phase_t2s_parity(C.speecht5_tiny(), device="cpu", batch=2,
                                         seconds=(0.3, 0.8))
    assert parity["mel_max_abs_err"] == 0.0 and parity["loss_rel_diff"] < 1e-6
