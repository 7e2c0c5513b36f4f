"""The CPU rehearsal of ``chip_smoke.py``'s joint pretraining phase at Large's
shape at the tiny preset, in a file of its own so that ``--dist loadfile``
runs it on a worker of its own (moved from tests/test_torch_hygiene.py,
names kept)."""

import chip_smoke
import torch_cpu  # noqa: F401  (one torch thread a process)


def test_chip_smoke_pretrain_large_reads_binarized_text_on_cpu():
    """Phase 24 at the Large-shaped tiny preset: the text corpus binarized
    by the port's writer, its blocks equal to the raw file's, read through
    --text-file <prefix>.bin by cli/train.main for 3 updates of both tasks
    and a resume; the twins run, so no launches."""
    ovs = ["encoder.layer_norm_first=True", "decoder.layer_norm_first=True",
           "conv_features.mode='layer_norm'", "quantizer.enabled=True",
           "hubert.num_classes=(504,)"]
    r = chip_smoke.phase_train_pretrain_large(device="cpu", arch="speecht5_tiny",
                                              overrides=ovs, seconds=(0.5, 1.2), n_utts=8)
    assert set(r["counts"].values()) == {0} and r["text_blocks"] > 3
    assert {"pretrain_speech", "pretrain_text"} <= set(r["tasks"][:3])
    assert r["text_file"] == "text.bin"
