"""The CPU rehearsal of ``chip_smoke.py``'s parity sweep phase at the tiny
preset, in a file of its own so that ``--dist loadfile`` runs it on a worker
of its own (moved from tests/test_torch_hygiene.py, names kept)."""

import chip_smoke
import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch import config as C


def test_chip_smoke_parity_sweep_runs_on_cpu_with_twins():
    """The parity sweep's dry run at the tiny preset, every kernel flag on
    (their twins on the CPU): a report-only record with finite WERs for
    the beam and both arms, and no launch; its MFU helpers say "not
    measured" off the card."""
    sweep = chip_smoke.phase_parity_sweep(device="cpu", arch="speecht5_tiny", dtype="float32")
    assert set(sweep["counts"].values()) == {0}
    assert sweep["record"]["status"] == "report_only"
    assert set(sweep["record"]["arms"]) == {"ctc_greedy", "ctc_rescore"}
    cfg = C.speecht5_tiny()
    calls = [{"ms": 1.0, "batch": 4, "samples": 4000, "steps": 8, "models": 2, "beam": 2}]
    dec = chip_smoke.decode_mfu(cfg, calls, "cpu")
    from speecht5_tpu_torch.utils import flops

    assert dec["decode_flops"] == [2 * flops.asr_decode_flops(cfg, 4, 2, 4000, 8)]
    assert dec["mfu"].startswith("not measured")
