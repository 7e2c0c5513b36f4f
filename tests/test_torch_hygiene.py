"""Import hygiene, device defaults and the CUDA build line of the port, and
``chip_smoke.py``'s refusal without a card and its kernels line (its
phases' CPU rehearsals are in tests/test_torch_smoke_*.py, a file each).

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
import torch_cpu  # noqa: F401  (one torch thread a process)
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
            "speecht5_tpu_torch.ops.heads", "speecht5_tpu_torch.data.text_noising",
            "speecht5_tpu_torch.data.binarized", "speecht5_tpu_torch.data.sentencepiece",
            "speecht5_tpu_torch.data.prep", "speecht5_tpu_torch.cli.prep",
            "speecht5_tpu_torch.utils.flops", "speecht5_tpu_torch.cli.parity",
            "speecht5_tpu_torch.models.speechlm", "speecht5_tpu_torch.models.speechut",
            "speecht5_tpu_torch.models.speech2c", "speecht5_tpu_torch.models.fastspeech2",
            "speecht5_tpu_torch.models.registry", "speecht5_tpu_torch.train.joint",
            "speecht5_tpu_torch.data.multicorpus", "speecht5_tpu_torch.data.multitask",
            "speecht5_tpu_torch.recipes", "speecht5_tpu_torch.recipes.common",
            "speecht5_tpu_torch.recipes.speechlm_ctc_finetune",
            "speecht5_tpu_torch.recipes.speechut_joint_pretrain",
            "speecht5_tpu_torch.recipes.speech2c_pretrain"} <= names


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


def test_parity_cli_defaults_to_cuda_and_raises_before_its_fixtures(tmp_path):
    from speecht5_tpu_torch.cli import parity

    assert parity.build_parser().get_default("device") == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: asking for cuda does not raise here")
    with pytest.raises(RuntimeError, match="cuda"):
        parity.main(["--ckpt-dir", str(tmp_path / "c"), "--data-dir", str(tmp_path / "d"),
                     "--dry-run"])
    assert not (tmp_path / "c").exists() and not (tmp_path / "d").exists()


def test_prep_cli_is_host_only():
    """cli/prep.py takes no device: none of its subcommands has a --device."""
    src = (REPO / "speecht5_tpu_torch" / "cli" / "prep.py").read_text()
    assert "--device" not in src and not re.search(r"^\s*(import|from)\s+torch\b", src, re.M)


def test_parallel_package_imports_without_jax_and_nccl_needs_a_card(tmp_path):
    """``parallel/`` imports with JAX and the JAX package blocked, and a
    backend that needs a card raises on a machine without one instead of
    falling back to gloo on the CPU, through ``initialize`` and through
    ``cli/train.py --distributed-platform nccl``."""
    code = (f"import sys\nfor m in {BLOCKED!r}:\n    sys.modules[m] = None\n"
            "import speecht5_tpu_torch.parallel.distributed as D\n"
            "import speecht5_tpu_torch.parallel.sharding as S\n"
            "print(D.backend_for(None, 'cpu'), D.backend_for('cpu'), D.backend_for(None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["gloo", "gloo", "nccl"]
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|speecht5_tpu)\b")
    files = list((REPO / "speecht5_tpu_torch" / "parallel").glob("*.py"))
    assert len(files) == 3 and not [f for f in files
                                    if any(pat.match(l) for l in f.read_text().splitlines())]
    if torch.cuda.is_available():
        pytest.skip("a card is present: nccl does not raise here")
    from speecht5_tpu_torch.cli import train as cli_train
    from speecht5_tpu_torch.parallel import distributed as D

    with pytest.raises(RuntimeError, match="nccl backend needs a card"):
        D.initialize(f"file://{tmp_path}/store", 1, 0, "nccl", "cpu")
    with pytest.raises(RuntimeError, match="nccl backend needs a card"):
        cli_train.main(["--task", "s2t", "--manifest", "m.tsv", "--labels", "l",
                        "--save-dir", str(tmp_path), "--device", "cpu",
                        "--distributed-num-processes", "1", "--distributed-platform", "nccl"])
    assert not torch.distributed.is_initialized()


