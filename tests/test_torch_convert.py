"""Checkpoints into the port, held against the JAX package: the fairseq
loader (without fairseq or omegaconf), the state-dict operations of
fine-tuning, ``cli/convert.py`` into ``cli/serve.py``, and the JAX->port
converter script.

A fairseq-format ``.pt`` is written on the spot from a seeded tiny port
model (``chip_smoke.write_fairseq_checkpoint``: fairseq's key names, an
``argparse`` ``args`` entry, keys of modules the model lacks), plus an
omegaconf-style ``cfg`` object whose class lives in a stand-in module
that exists only while the file is written and while JAX reads it.  Every
comparison is exact (``torch.equal`` / ``np.array_equal``): both sides only
move, transpose and cast the same f32 numbers; the average sums in float64
on both sides.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import jax
from flax.traverse_util import flatten_dict

import speecht5_tpu.config as JC
from speecht5_tpu.models.speecht5 import init_model as jinit_model
from speecht5_tpu.utils import checkpoint as JCk
from speecht5_tpu.utils.convert import load_fairseq_checkpoint as jload
from speecht5_tpu.utils.convert import map_speecht5_key

import torch

import chip_smoke
from speecht5_tpu_torch import config as PC
from speecht5_tpu_torch.cli import convert as cli_convert
from speecht5_tpu_torch.cli import serve
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.utils import checkpoint as PCk
from speecht5_tpu_torch.utils.convert import (PORTED_SUBTREES, from_jax_batch_stats,
                                              from_jax_params, load_fairseq_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules the port has that the tiny preset leaves out, the quantizer (of
# pretraining) and a speaker head (of s2c): the loader converts them, the
# model takes no such key
LACKED = {"quantizer.vars": (1, 4, 8), "quantizer.weight_proj.weight": (4, 64)}
SPEAKER_KEY = {"speaker_decoder_postnet.output_embedding.weight": (6, 64)}


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _nested(sd):
    """A port state dict as a nested dict of numpy arrays (keys split on '.')."""
    out = {}
    for key, value in sd.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value.numpy()
    return out


def _tiny_state(seed, **kw):
    model = init_model(PC.speecht5_tiny(**{**chip_smoke.DICT_CFG, **kw}),
                       torch.Generator().manual_seed(seed), "cpu")
    sd = model.state_dict()
    g = torch.Generator().manual_seed(seed + 100)
    for k in sd:      # BatchNorm statistics off their init
        if k.endswith(("running_mean", "running_var")):
            sd[k] = torch.rand(sd[k].shape, generator=g) + 0.5
    return sd


def _omegaconf_module():
    """A stand-in ``omegaconf.dictconfig`` whose DictConfig pickles its
    content the way omegaconf's does (object state with ``_content``)."""
    pkg = types.ModuleType("omegaconf")
    mod = types.ModuleType("omegaconf.dictconfig")

    class DictConfig:
        def __init__(self, content):
            self._content = content
            self._metadata = {"object_type": dict}

    DictConfig.__module__, DictConfig.__qualname__ = "omegaconf.dictconfig", "DictConfig"
    mod.DictConfig = DictConfig
    pkg.dictconfig = mod
    return pkg, mod


@pytest.fixture
def fairseq_pt(tmp_path, monkeypatch):
    """(path, the port state it holds): a fairseq .pt with an omegaconf
    ``cfg``, an ``args`` namespace, keys of modules the port lacks and a key
    the reference does not know."""
    sd = _tiny_state(3)
    path = str(tmp_path / "speecht5.pt")
    chip_smoke.write_fairseq_checkpoint(path, sd, lacked={**LACKED, **SPEAKER_KEY})
    pkg, mod = _omegaconf_module()
    monkeypatch.setitem(sys.modules, "omegaconf", pkg)
    monkeypatch.setitem(sys.modules, "omegaconf.dictconfig", mod)
    ckpt = torch.load(path, weights_only=False)
    ckpt["cfg"] = mod.DictConfig({"model": mod.DictConfig({"encoder_layers": 2}),
                                  "task": {"_name": "speecht5"}})
    ckpt["model"]["mystery_head.weight"] = torch.ones(3)
    torch.save(ckpt, path)
    return path, sd


def test_fairseq_loader_matches_jax_without_omegaconf(fairseq_pt, monkeypatch):
    path, sd = fairseq_pt
    jvars, _, junknown = jload(path)             # JAX's loader needs the classes
    monkeypatch.delitem(sys.modules, "omegaconf")
    monkeypatch.delitem(sys.modules, "omegaconf.dictconfig")
    state, cfg, unknown = load_fairseq_checkpoint(path)
    want = {**from_jax_params(_flat(jvars["params"])),
            **from_jax_batch_stats(_flat(jvars["batch_stats"]))}
    assert set(state) == set(want)
    for key, value in want.items():
        assert state[key].dtype == torch.float32 and torch.equal(state[key], value), key
    # every module JAX maps, the port has: the unknown keys are JAX's
    assert all(map_speecht5_key(k)[0][0] in PORTED_SUBTREES for k in LACKED)
    assert sorted(unknown) == sorted(junknown)
    assert "mystery_head.weight" in junknown
    # every tensor of the model came back under its own name (the HuBERT
    # head's too), and the quantizer's and the speaker head's keys under
    # their own
    assert any(k.startswith("speech_encoder_postnet.") for k in sd)
    assert set(state) == set(sd) | set(SPEAKER_KEY) | set(LACKED)
    assert all(torch.equal(state[k], sd[k]) for k in sd)
    assert cfg["model"]["encoder_layers"] == 2 and cfg["task"]["_name"] == "speecht5"


def test_fairseq_loader_reads_args_and_refuses_what_it_cannot_read(tmp_path):
    sd = _tiny_state(4)
    path = str(tmp_path / "a.pt")
    chip_smoke.write_fairseq_checkpoint(path, sd, lacked={})
    state, cfg, unknown = load_fairseq_checkpoint(path)
    assert cfg["arch"] == "t5_transformer_base_asr" and unknown == []
    ckpt = torch.load(path, weights_only=False)
    ckpt["model"]["encoder.layer_norm.weight"] = "not a tensor"
    torch.save(ckpt, path)
    with pytest.raises(ValueError, match="encoder.layer_norm.weight"):
        load_fairseq_checkpoint(path)
    torch.save({"model": {"something.else": torch.ones(2)}}, path)
    with pytest.raises(ValueError, match="no key of a SpeechT5 model"):
        load_fairseq_checkpoint(path)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep=".").items()}


@pytest.mark.parametrize("include,exclude", [(None, None), (["encoder"], None),
                                             (None, ["decoder", "encoder"])])
def test_partial_load_matches_jax(include, exclude):
    """Module filters, a source missing keys and a head at another
    vocabulary size (kept from the target), against JAX's partial_load."""
    target = _tiny_state(1)
    source = _tiny_state(2, vocab_size=40, blank_id=39)
    del source["encoder.layer_norm.weight"]
    got = PCk.partial_load(target, source, include, exclude)
    want = _flat_np(JCk.partial_load(_nested(target), _nested(source), include, exclude))
    assert set(got) == set(want) == set(target)
    for k in got:
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert torch.equal(got["text_decoder_prenet.embed_tokens.weight"],
                       target["text_decoder_prenet.embed_tokens.weight"])
    with pytest.raises(ValueError, match="shape mismatch"):
        PCk.partial_load(target, source, strict_shapes=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        JCk.partial_load(_nested(target), _nested(source), strict_shapes=True)


@pytest.mark.parametrize("task", ["s2t", "t2s", "s2s", "s2c"])
def test_prune_for_task_matches_jax(task):
    sd = _tiny_state(1)
    got = PCk.prune_for_task(sd, task)
    want = _flat_np(JCk.prune_for_task({"params": _nested(sd)}, task)["params"])
    assert set(got) == set(want)
    assert PCk.TASK_MODULES == JCk.TASK_MODULES


def test_average_checkpoints_matches_jax():
    sds = [_tiny_state(s) for s in (1, 2, 3)]
    got = PCk.average_checkpoints(sds)
    want = _flat_np(JCk.average_checkpoints([_nested(sd) for sd in sds]))
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == sds[0][k].dtype and np.array_equal(got[k].numpy(), want[k]), k


def test_model_only_checkpoints_save_and_restore(tmp_path):
    sd = _tiny_state(5)
    path = PCk.save_model_only(tmp_path, sd, step=7)
    assert path.name == "checkpoint_7.pt"
    assert set(torch.load(path, weights_only=True)) == {"step", "model"}
    state, step = PCk.restore_model(tmp_path)
    assert step == 7 and all(torch.equal(state[k], sd[k]) for k in sd)
    assert PCk.restore_model(tmp_path / "none") == (None, None)


def test_convert_cli_then_serve_restores_the_converted_weights(fairseq_pt, tmp_path):
    """cli/convert.py --format fairseq writes a model-only checkpoint that
    cli/serve.py restores: every converted tensor as the file holds it, the
    rest at the converter's seeded initial values; --strict refuses the
    file's unknown keys."""
    path, sd = fairseq_pt
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    out = str(tmp_path / "converted")
    report = cli_convert.main(["--pt", path, "--arch", "speecht5_tiny",
                               "--dict", dict_path, "--out", out])
    assert report["missing"] == [] and report["shape_mismatches"] == []
    assert "mystery_head.weight" in report["unknown_keys"]
    args = serve.build_parser().parse_args([
        "--ckpt", out, "--arch", "speecht5_tiny", "--dict", dict_path,
        "--decoder", "ctc_greedy", "--asr-buckets", "1", "--dtype", "float32"])
    svc = serve.Service(args, device="cpu")
    for key, value in svc.model.state_dict().items():
        assert torch.equal(value, sd[key]), key
    assert svc.transcribe(chip_smoke.synth_audio(0.5, seed=1)) is not None
    with pytest.raises(SystemExit, match="mystery_head"):
        cli_convert.main(["--pt", path, "--arch", "speecht5_tiny", "--dict", dict_path,
                          "--out", str(tmp_path / "strict"), "--strict"])


def test_jax_checkpoint_converter_script(tmp_path):
    """convert_jax_checkpoint.py restores an orbax checkpoint of the JAX
    package (written here with save_model_only) and writes the port's
    model-only checkpoint: from_jax_params of the same tree, exactly."""
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    jcfg = JC.speecht5_tiny(**chip_smoke.DICT_CFG)
    _, variables = jinit_model(jcfg, jax.random.PRNGKey(3))
    mgr = JCk.CheckpointManager(str(tmp_path / "jax"))
    mgr.save_model_only(4, variables)
    mgr.wait()
    out = str(tmp_path / "port")
    from conftest import cpu_subprocess_env

    env = dict(cpu_subprocess_env(), PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "convert_jax_checkpoint.py", "--ckpt",
                          str(tmp_path / "jax"), "--arch", "speecht5_tiny", "--dict",
                          dict_path, "--out", out], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    # the HuBERT head crosses too: no sub-net of the JAX model is left out
    assert line["step"] == 4 and line["left_out"] == []
    state, step = PCk.restore_model(out)
    want = {**from_jax_params(_flat(variables["params"])),
            **from_jax_batch_stats(_flat(variables["batch_stats"]))}
    assert step == 4 and set(state) == set(want)
    assert any(k.startswith("speech_encoder_postnet.") for k in state)
    assert all(torch.equal(state[k], want[k]) for k in want)
    model = init_model(PC.speecht5_tiny(**chip_smoke.DICT_CFG), device="cpu")
    model.load_state_dict(state)        # every key of the port's model
