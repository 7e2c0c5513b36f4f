"""The CPU rehearsal of ``chip_smoke.py``'s warm-start, /tts and TTS parity
phases at the tiny preset, in a file of its own so that ``--dist loadfile``
runs it on a worker of its own (moved from tests/test_torch_hygiene.py,
names kept)."""

import chip_smoke
import torch_cpu  # noqa: F401  (one torch thread a process)
from speecht5_tpu_torch import config as C


def test_chip_smoke_warm_start_and_tts_phases_run_on_cpu_with_twins():
    """The warm-start phase (a fairseq .pt written on the spot, cli/convert,
    the bit-for-bit warm-start check, cli/train --finetune-from, a greedy
    request from the converted checkpoint, a SIGTERM'd train subprocess and
    its resume), the /tts phase (HiFi-GAN at a narrower width, Griffin-Lim)
    and the TTS parity phase at the tiny preset on the CPU: the twins run,
    so no launches."""
    from speecht5_tpu_torch.models.hifigan import HiFiGANConfig

    flags = ["--batch-size", "2", "--accum", "2", "--ctc-weight", "0.5", "--normalize"]
    warm = chip_smoke.phase_warm_start("speecht5_tiny", device="cpu", n_utts=4, updates=2,
                                       seconds=(0.3, 0.8), flags=flags, src_vocab=40,
                                       request_s=1.1, buckets="2")
    assert warm["fresh_tensors"] == 5 and warm["loaded_tensors"] > 100
    assert set(warm["train_counts"].values()) == set(warm["serve_counts"].values()) == {0}
    assert warm["layer_runs"] == 2 * 2 * 2 and warm["preempt"]["resumed_to"] == 3
    voc = HiFiGANConfig(in_dim=20, upsample_initial_channel=32)
    texts = ("hi", "hello there")
    tts = chip_smoke.phase_serve_tts(C.speecht5_tiny(), device="cpu", dtype="float32",
                                     texts=texts, max_frames=48, bucket_tokens=16,
                                     vocoder_cfg=voc)
    steps = [r["decode_steps"] for r in tts["requests"]]
    assert steps == [16, 24, 16, 24] and set(tts["counts"].values()) == {0}
    parity = chip_smoke.phase_tts_parity(C.speecht5_tiny(), device="cpu", texts=texts,
                                         max_frames=48, bucket_tokens=16, vocoder_cfg=voc)
    assert parity["lengths_kernel"] == [30, 48] and parity["mel_max_abs_err"] < 1e-4
    # the second run stops the longer text by threshold, before its bound
    early = parity["early_stop"]
    assert early["lengths_kernel"] == early["lengths_plain"] == early["expected_lengths"]
    assert early["row"] == 1 and 2 * 15 <= early["lengths_kernel"][1] < 48
    # the card's launch rule: 12 encoder layers x 2 bf16 launches a request,
    # 6 decoder layers x (self + cross) a step
    want = chip_smoke.tts_launches_expected(C.speecht5_base(dtype="bfloat16"), 10)
    assert want["banded_flash_attention"] == 24 and want["flash_attention_bias"] == 120
    assert sum(want.values()) == 144
