"""The port's serve entry point restores the port's own checkpoints.

``cli/train.main --task s2t --device cpu`` trains the tiny preset for two
updates and writes ``checkpoint_2.pt``; ``Service`` built from ``--ckpt``
(no model handed in) restores it and must give, request by request, the
texts of the JAX package's ``Service.transcribe`` path on the same weights,
carried into JAX through ``speecht5_tpu/utils/convert.py:convert_state_dict``
(the port keeps torch layouts; its few module names that differ from the
fairseq ones are renamed first).  ``main`` without a checkpoint exits, as
the JAX entry point does.  Texts must be equal.
"""

import re
import threading

import numpy as np
import pytest

import jax.numpy as jnp

import speecht5_tpu.config as JC
from speecht5_tpu.cli import serve as jserve
from speecht5_tpu.data.dictionary import letters_to_text as jletters_to_text
from speecht5_tpu.data.dictionary import load_cli_dictionary as jload_dict
from speecht5_tpu.decode.asr import CTCDecoder as JCTCDecoder
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel
from speecht5_tpu.utils.convert import convert_state_dict

import torch

import chip_smoke
from speecht5_tpu_torch.cli import serve
from speecht5_tpu_torch.cli import train as cli_train

torch.backends.cuda.matmul.allow_tf32 = False

# port module name -> fairseq module name, where they differ
FAIRSEQ_NAMES = chip_smoke.FAIRSEQ_NAMES


def to_fairseq(state):
    out = {}
    for key, value in state.items():
        for pat, rep in FAIRSEQ_NAMES:
            key = re.sub(pat, rep, key)
        out[key] = value.numpy()
    return out


def _jax_service(cfg, variables, dict_path, args):
    """The JAX Service's ASR path around in-memory variables (its
    constructor restores an orbax checkpoint): the same request methods,
    decoder and detokenizer."""
    svc = object.__new__(jserve.Service)
    svc._jnp = jnp
    svc._letters_to_text = jletters_to_text
    svc.lock = threading.Lock()
    svc.args = args
    svc.dictionary, _ = jload_dict(dict_path, None)
    svc.max_batch = 1
    svc.asr_calls = svc.asr_requests = 0
    svc.asr = jserve._CTCAdapter(JCTCDecoder(JModel(cfg), variables,
                                             blank_id=cfg.blank_id))
    return svc


def _serve_args(ckpt, dict_path):
    return serve.build_parser().parse_args([
        "--arch", "speecht5_tiny", "--ckpt", ckpt, "--dict", dict_path,
        "--decoder", "ctc_greedy", "--dtype", "float32", "--asr-buckets", "1,2",
        "--device", "cpu"])


def test_service_restores_the_trained_checkpoint_and_matches_jax(tmp_path, capsys):
    d = str(tmp_path)
    manifest, labels, dict_path = chip_smoke.write_corpus(d, 4, seconds=(0.3, 0.8))
    out = cli_train.main([
        "--task", "s2t", "--arch", "speecht5_tiny", "--manifest", manifest,
        "--labels", labels, "--dict", dict_path, "--save-dir", f"{d}/ckpt",
        "--batch-size", "2", "--ctc-weight", "0.5", "--lr", "1e-3", "--warmup", "1",
        "--max-updates", "2", "--device", "cpu"])
    assert out["checkpoint"].endswith("checkpoint_2.pt")
    args = _serve_args(f"{d}/ckpt", dict_path)
    assert serve.build_parser().get_default("device") == "cuda"
    svc = serve.Service(args, device=args.device)
    assert "loaded checkpoint step 2" in capsys.readouterr().out
    state = torch.load(out["checkpoint"], weights_only=True)["model"]
    for k, v in svc.model.state_dict().items():
        assert torch.equal(v, state[k]), k

    params, batch_stats, unknown = convert_state_dict(to_fairseq(state))
    assert not unknown, unknown
    _, cfg_kw = jload_dict(dict_path, None)
    jcfg = JC.speecht5_tiny(**cfg_kw, dtype="float32")
    jsvc = _jax_service(jcfg, {"params": params, "batch_stats": batch_stats},
                        dict_path, args)
    texts = []
    for i, secs in enumerate((0.4, 1.3, 2.5)):
        wav = chip_smoke.synth_audio(secs, seed=30 + i)
        texts.append(svc.transcribe(wav))
        assert texts[-1] == jsvc.transcribe(wav)
    assert svc.asr_requests == jsvc.asr_requests == 4   # 2.5 s -> 2 chunks
    assert any(texts)


def test_serve_main_without_a_checkpoint_exits(tmp_path):
    dict_path = chip_smoke.write_dictionary(str(tmp_path))
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no checkpoint"):
        serve.main(["--ckpt", str(tmp_path / "empty"), "--dict", dict_path,
                    "--decoder", "ctc_greedy", "--arch", "speecht5_tiny",
                    "--device", "cpu"])
