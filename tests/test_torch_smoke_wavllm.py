"""The CPU rehearsal of ``chip_smoke.py``'s WavLLM phases (38-39) at the
tiny presets, in a file of its own so that ``--dist loadfile`` runs it on a
worker of its own: every branch and check of each phase, the twins in
place of the kernels, no launch."""

import pytest

import chip_smoke
import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch.ops import cuda_kernels as K


@pytest.mark.parametrize("phase", ["wavllm", "wavllm_parity"])
def test_chip_smoke_wavllm_phases_run_on_cpu_with_twins(phase):
    out = getattr(chip_smoke, f"phase_{phase}")(device="cpu", tiny=True)
    assert out["ok"], out
    assert sum(K.launch_counts().values()) == 0
