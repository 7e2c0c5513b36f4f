"""The CPU rehearsal of ``chip_smoke.py``'s serve and CTC parity phases (1-2)
at the tiny preset, in a file of its own so that ``--dist loadfile`` runs it
on a worker of its own (moved from tests/test_torch_hygiene.py, names kept)."""

import chip_smoke
import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch import config as C


def test_chip_smoke_phases_run_on_cpu_with_twins():
    base = C.speecht5_tiny()
    served = chip_smoke.phase_serve(base, device="cpu", dtype="float32",
                                    requests_s=(0.3, 1.1, 2.1), buckets="1,2")
    assert [r["chunks"] for r in served["requests"]] == [1, 1, 2]
    assert set(served["counts"].values()) == {0}
    parity = chip_smoke.phase_parity(base, device="cpu",
                                     requests_s=(0.3, 2.1), buckets="1,2")
    assert parity["frames"] > 0 and parity["differing_frames"] == 0
