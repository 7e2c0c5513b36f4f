"""The rest of the port's train CLI: ``--finetune-from`` against the JAX
package's, the SIGTERM save-and-exit with its resume, and ``--profile-dir``.

A fairseq-format ``.pt`` of a seeded tiny model is converted by both
packages' ``cli/convert.py`` (JAX: an orbax directory; the port: a
model-only checkpoint), and both ``cli/train.py --task s2t --finetune-from``
take one update on the same 8 synthetic utterances with every stochastic
part at 0 (the tiny preset has no dropout or layerdrop; ``--mask-prob 0``).
The first update's loss agrees within 1e-4 relative (JAX prints it rounded
to 4 decimals: the bound adds 5e-5 absolute for that rounding).  The
preemption test sends the process SIGTERM from inside the first update
(accum 2): the run must finish that update, save a resumable checkpoint at
update 1 and return; the resume must give the same update count and the
same weights, bit for bit, as a run that is not interrupted.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

import chip_smoke
from speecht5_tpu_torch import config as PC
from speecht5_tpu_torch.cli import convert as cli_convert
from speecht5_tpu_torch.cli import train as cli_train
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.train import trainer as PT
from speecht5_tpu_torch.utils.checkpoint import checkpoints, restore_model

torch.backends.cuda.matmul.allow_tf32 = False


def _corpus(d, n=8):
    return chip_smoke.write_corpus(d, n, seconds=(0.3, 0.8), seed=3)


def _fairseq_pt(d, seed=11):
    model = init_model(PC.speecht5_tiny(**chip_smoke.DICT_CFG),
                       torch.Generator().manual_seed(seed), "cpu")
    return chip_smoke.write_fairseq_checkpoint(os.path.join(d, "pre.pt"),
                                               model.state_dict(), lacked={})


def _train_args(manifest, labels, dict_path, save_dir, *extra):
    return ["--task", "s2t", "--arch", "speecht5_tiny", "--manifest", manifest,
            "--labels", labels, "--dict", dict_path, "--save-dir", save_dir,
            "--batch-size", "8", "--ctc-weight", "0.5", "--mask-prob", "0",
            "--log-interval", "1", "--seed", "3", *extra]


def test_finetune_first_update_loss_matches_jax(tmp_path, capsys):
    from speecht5_tpu.cli.convert import main as jconvert
    from speecht5_tpu.cli.train import main as jtrain

    d = str(tmp_path)
    manifest, labels, dict_path = _corpus(d)
    pt = _fairseq_pt(d)
    jconvert(["--pt", pt, "--arch", "speecht5_tiny", "--dict", dict_path,
              "--out", f"{d}/jax_conv"])
    cli_convert.main(["--pt", pt, "--arch", "speecht5_tiny", "--dict", dict_path,
                      "--out", f"{d}/port_conv"])
    capsys.readouterr()
    jtrain(_train_args(manifest, labels, dict_path, f"{d}/jax_ckpt", "--max-updates", "1",
                       "--finetune-from", f"{d}/jax_conv"))
    jout = capsys.readouterr().out
    assert f"warm start from {d}/jax_conv" in jout
    jloss = [json.loads(l) for l in jout.splitlines() if l.startswith('{"step"')][0]["loss"]
    out = cli_train.main(_train_args(manifest, labels, dict_path, f"{d}/port_ckpt",
                                     "--max-updates", "1", "--device", "cpu",
                                     "--finetune-from", f"{d}/port_conv"))
    assert f"warm start from {d}/port_conv" in capsys.readouterr().out
    loss = out["history"][0]["loss"]
    assert abs(loss - jloss) <= 1e-4 * abs(jloss) + 5e-5, (loss, jloss)
    # a fairseq .pt is taken directly too, with the same weights
    fresh = init_model(PC.speecht5_tiny(**chip_smoke.DICT_CFG), device="cpu")
    cli_train.warm_start(fresh, pt)
    state, _ = restore_model(f"{d}/port_conv")
    assert all(torch.equal(v, state[k]) for k, v in fresh.state_dict().items())


def test_finetune_from_no_longer_refused(tmp_path):
    d = str(tmp_path)
    manifest, labels, dict_path = _corpus(d)
    with pytest.raises(SystemExit) as e:
        cli_train.main(_train_args(manifest, labels, dict_path, f"{d}/ckpt",
                                   "--device", "cpu", "--finetune-from", f"{d}/empty"))
    assert "no checkpoint" in str(e.value) and "not ported" not in str(e.value)


def test_sigterm_saves_at_an_update_boundary_and_resume_matches(tmp_path, monkeypatch,
                                                                capsys):
    d = str(tmp_path)
    manifest, labels, dict_path = _corpus(d, n=16)
    args = lambda save: _train_args(manifest, labels, dict_path, save, "--batch-size", "4",
                                    "--accum", "2", "--max-updates", "3", "--device", "cpu")
    whole = cli_train.main(args(f"{d}/whole"))
    assert whole["steps"] == 3 and not whole["preempted"]

    real = PT.Trainer.train_step
    calls = []

    def step_then_signal(self, micro):
        calls.append(len(micro))
        if len(calls) == 1:        # mid-update: the update must still finish
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, micro)

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(PT.Trainer, "train_step", step_then_signal)
    cut = cli_train.main(args(f"{d}/cut"))
    assert cut["preempted"] and cut["steps"] == 1 and calls == [2]
    assert signal.getsignal(signal.SIGTERM) is before       # handlers restored
    assert [s for s, _ in checkpoints(f"{d}/cut")] == [1]
    saved = torch.load(checkpoints(f"{d}/cut")[0][1], weights_only=True)
    assert saved["data_state"] == {"epoch": 0, "batch": 2} and "optimizer" in saved
    assert '{"preempted": true, "step": 1}' in capsys.readouterr().out
    monkeypatch.setattr(PT.Trainer, "train_step", real)
    resumed = cli_train.main(args(f"{d}/cut"))
    assert resumed["steps"] == 3 and len(resumed["history"]) == 2
    a, _ = restore_model(f"{d}/whole")
    b, _ = restore_model(f"{d}/cut")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert [round(h["loss"], 6) for h in resumed["history"]] == \
        [round(h["loss"], 6) for h in whole["history"][1:]]


def test_profile_dir_writes_a_trace_after_update_10(tmp_path):
    d = str(tmp_path)
    manifest, labels, dict_path = _corpus(d, n=4)
    out = cli_train.main(_train_args(manifest, labels, dict_path, f"{d}/ckpt",
                                     "--batch-size", "2", "--max-updates", "11",
                                     "--device", "cpu", "--profile-dir", f"{d}/prof"))
    assert out["steps"] == 11
    trace = json.load(open(f"{d}/prof/trace.json"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert os.path.getsize(f"{d}/prof/key_averages.txt") > 0
    short = cli_train.main(_train_args(manifest, labels, dict_path, f"{d}/ckpt2",
                                       "--batch-size", "2", "--max-updates", "3",
                                       "--device", "cpu", "--profile-dir", f"{d}/prof2"))
    assert short["steps"] == 3 and not os.path.exists(f"{d}/prof2")
