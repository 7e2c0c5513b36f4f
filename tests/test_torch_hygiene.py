"""Import hygiene, device defaults and the CUDA build line of the port, and
``chip_smoke.py``'s phases run on the CPU at the tiny preset.

A machine that runs the port need not have JAX, flax, transformers or
sentencepiece, so neither the port nor ``chip_smoke.py`` may reach them or
the JAX package; a subprocess with those modules blocked imports everything.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

import chip_smoke
from speecht5_tpu_torch import config as C
from speecht5_tpu_torch.ops import cuda_kernels as K

REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "flax", "speecht5_tpu", "transformers", "sentencepiece")


def _env():
    from conftest import cpu_subprocess_env

    return cpu_subprocess_env()


def test_port_and_smoke_import_with_jax_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import speecht5_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke, torch_serve_profile, torch_train_profile\n"
        "print(' '.join(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 15
    assert {"speecht5_tpu_torch.decode.beam_search", "speecht5_tpu_torch.decode.ctc_prefix",
            "speecht5_tpu_torch.decode.asr", "speecht5_tpu_torch.cli.serve",
            "speecht5_tpu_torch.decode.tts", "speecht5_tpu_torch.models.hifigan",
            "speecht5_tpu_torch.cli.convert", "speecht5_tpu_torch.utils.convert_hf",
            "speecht5_tpu_torch.utils.profiling", "speecht5_tpu_torch.decode.sid",
            "speecht5_tpu_torch.data.native", "speecht5_tpu_torch.decode.lexicon",
            "speecht5_tpu_torch.decode.nbest", "speecht5_tpu_torch.models.lm",
            "speecht5_tpu_torch.cli.evaluate", "speecht5_tpu_torch.models.quantizer",
            "speecht5_tpu_torch.ops.heads", "speecht5_tpu_torch.data.text_noising"} <= names


def test_no_import_lines_reach_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|speecht5_tpu)\b")
    files = list((REPO / "speecht5_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "torch_serve_profile.py",
        REPO / "torch_train_profile.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits


def test_jax_checkpoint_converter_stays_outside_the_port():
    """convert_jax_checkpoint.py imports JAX; neither the port nor the smoke
    may import it."""
    src = (REPO / "convert_jax_checkpoint.py").read_text()
    assert "from speecht5_tpu.utils.checkpoint import CheckpointManager" in src
    files = list((REPO / "speecht5_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert not [f for f in files if "convert_jax_checkpoint" in f.read_text()
                and re.search(r"^\s*(import|from)\s+convert_jax_checkpoint",
                              f.read_text(), re.M)]


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    import inspect

    from speecht5_tpu_torch.cli.serve import Service
    from speecht5_tpu_torch.decode.asr import CTCDecoder
    from speecht5_tpu_torch.decode.sid import SIDClassifier
    from speecht5_tpu_torch.decode.tts import TTSDecoder
    from speecht5_tpu_torch.models.hifigan import init_hifigan
    from speecht5_tpu_torch.models.speecht5 import init_model
    from speecht5_tpu_torch.utils.device import resolve_device

    for fn in (init_model, CTCDecoder.__init__, Service.__init__, resolve_device,
               TTSDecoder.__init__, init_hifigan, SIDClassifier.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("a card is present: asking for cuda does not raise here")
    with pytest.raises(RuntimeError, match="cuda"):
        init_model(C.speecht5_tiny())
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()


def test_decoders_and_evaluate_default_to_cuda():
    import inspect

    from speecht5_tpu_torch.cli import evaluate
    from speecht5_tpu_torch.decode.asr import ASRDecoder, RescoreDecoder
    from speecht5_tpu_torch.models.lm import init_lm

    for fn in (ASRDecoder.__init__, RescoreDecoder.__init__, init_lm):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert evaluate.build_parser().get_default("device") == "cuda"


def test_native_loader_builds_outside_csrc(tmp_path, monkeypatch):
    """The port's loader compiles csrc/'s sources with csrc/Makefile's flags
    into build/native/<hash>/ and writes nothing under csrc/: on a copy of
    csrc/ the listing and every mtime are the same after a build.  A failed
    build raises with the compiler's stderr."""
    from speecht5_tpu_torch.data import native

    cmd = native.build_command(native.build_dir() / native.LIB_NAME)
    assert cmd[0] == "g++" and "-shared" in cmd and "-O3" in cmd and "-fPIC" in cmd
    assert native.build_dir().parent == REPO / "build" / "native"
    assert not any(c.startswith(str(native.CSRC_DIR)) and c.endswith(".so") for c in cmd)
    csrc = tmp_path / "csrc"
    shutil.copytree(native.CSRC_DIR, csrc, ignore=shutil.ignore_patterns("*.so"))
    before = {p.name: p.stat().st_mtime_ns for p in csrc.iterdir()}
    monkeypatch.setattr(native, "CSRC_DIR", csrc)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build" / "native")
    lib = native.build()
    assert lib.is_file() and lib.parent.parent == tmp_path / "build" / "native"
    assert {p.name: p.stat().st_mtime_ns for p in csrc.iterdir()} == before
    assert native.build() == lib                     # built once, then found
    (csrc / "ctc_beam.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="error"):
        native.build()


def test_nvcc_command_targets_sm90a_under_build():
    assert "banded_attention_train.cu" in K.SOURCES.values()
    for src in K.SOURCES.values():
        assert (K.CSRC_DIR / src).is_file()
        out = K.build_dir() / f"lib{src}.so"
        cmd = K.nvcc_command("nvcc", K.CSRC_DIR / src, out)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "--use_fast_math" not in cmd and "-shared" in cmd
        assert out.parent.parent == REPO / "build" / "torch_kernels"
        assert str(out) in cmd and str(K.CSRC_DIR / src) in cmd


def test_train_cli_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    from speecht5_tpu_torch.cli import train as cli_train

    assert cli_train.build_parser().get_default("device") == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: asking for cuda does not raise here")
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(["--task", "s2t", "--manifest", "m.tsv", "--labels", "l",
                        "--save-dir", str(tmp_path)])


def test_build_without_nvcc_raises(monkeypatch):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("an nvcc is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.find_nvcc()


def test_chip_smoke_phases_run_on_cpu_with_twins():
    base = C.speecht5_tiny()
    served = chip_smoke.phase_serve(base, device="cpu", dtype="float32",
                                    requests_s=(0.3, 1.1, 2.1), buckets="1,2")
    assert [r["chunks"] for r in served["requests"]] == [1, 1, 2]
    assert set(served["counts"].values()) == {0}
    parity = chip_smoke.phase_parity(base, device="cpu",
                                     requests_s=(0.3, 2.1), buckets="1,2")
    assert parity["frames"] > 0 and parity["differing_frames"] == 0


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


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok": true' not in out.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = _env()
    env["PYTHONPATH"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok": true' not in out.stdout


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


def test_chip_smoke_kernels_line_lists_every_kernel():
    assert set(chip_smoke.KERNELS) == {fn.__name__ for fn in K.WRAPPERS}
    assert set(chip_smoke.MAIN_CASE) == set(chip_smoke.KERNELS)
    for meta in chip_smoke.KERNELS.values():
        assert (REPO / meta["source"]).is_file()
    rec = {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 1.0, "bound_ms": 0.1,
           "bound_by": "operations", "library_ms": None, "tolerance": "atol 0",
           "shape": {}}
    records = {n: {case: dict(rec)} for n, case in chip_smoke.MAIN_CASE.items()}
    records["conv_stack"][chip_smoke.MAIN_CASE["conv_stack"]].update(
        chip_smoke._achieved(flops=1e9, bound_ms=0.1, ms=1.0))
    by_path = {"a": {n: 1 for n in chip_smoke.KERNELS}, "b": {n: 2 for n in chip_smoke.KERNELS}}
    line = chip_smoke.kernels_line(records, {n: 3 for n in chip_smoke.KERNELS}, by_path)
    assert len(line["kernels"]) == 7
    for k in line["kernels"]:
        assert k["route"] == "cuda" and k["launches"] == 3
        assert k["launches_by_path"] == {"a": 1, "b": 2}
        assert {"name", "source", "replaces", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms"} <= set(k)
    mel = [k for k in line["kernels"] if k["name"] == "fused_log_mel"][0]
    assert mel["dtype"] == "float32" and mel["replaces"].endswith("pallas_kernels.py:154")
    conv = [k for k in line["kernels"] if k["name"] == "conv_stack"][0]
    assert conv["bound_share"] == 0.1 and conv["achieved_tflops"] == 1.0
    assert "bound_share" not in mel


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
