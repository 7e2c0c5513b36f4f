"""The port's entry points across processes on the CPU: ``cli/train.py`` as
2 gloo ranks (``--distributed-*``, a file store in ``tmp_path``, children in
the conftest's hermetic environment) against 1 process, an FSDP checkpoint
resumed in one process, and ``cli/evaluate.py --data-parallel`` over 2 ranks
against the one-process port and JAX's data-parallel decode on its 8-device
mesh (tests/test_cli.py and tests/test_distributed.py:219-227 are the
specification: the final loss within 1e-3, hypotheses equal).
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

import speecht5_tpu.config as JC
from speecht5_tpu.data.dictionary import letters_to_text
from speecht5_tpu.decode.asr import ASRDecoder as JASR
from speecht5_tpu.models.speecht5 import init_model as jinit_model
from speecht5_tpu.parallel.sharding import (make_mesh as jax_mesh,
                                            shard_decode_batch as jshard_batch,
                                            shard_decode_variables as jshard_vars)

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.cli import evaluate, train as cli_train
from speecht5_tpu_torch.data.dictionary import load_cli_dictionary
from speecht5_tpu_torch.data.manifests import SpeechToTextDataset
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.utils.checkpoint import save_model_only
from speecht5_tpu_torch.utils.convert import from_jax_batch_stats, from_jax_params

from torch_parallel_worker import launch

N_UTTS = 8
STILL = ["--mask-prob", "0", "--override", "encoder.layerdrop=0.0",
         "--override", "decoder.layerdrop=0.0"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("pcli")
    manifest, labels, dict_path = chip_smoke.write_corpus(str(d), N_UTTS, seconds=(0.3, 0.6))
    return d, manifest, labels, dict_path


def _train_args(corpus, save_dir, *extra):
    _, manifest, labels, dict_path = corpus
    return ["--task", "s2t", "--arch", "speecht5_tiny", "--manifest", manifest,
            "--labels", labels, "--dict", dict_path, "--save-dir", str(save_dir),
            "--batch-size", "4", "--ctc-weight", "0.5", "--log-interval", "1",
            "--device", "cpu", *STILL, *extra]


def _ranks(module, args_of_rank, store, world=2):
    """Run ``python -m module`` as ``world`` gloo ranks -> their outputs."""
    return launch(lambda r: [
        sys.executable, "-m", module, *args_of_rank(r), "--distributed-num-processes",
        str(world), "--distributed-process-id", str(r), "--distributed-coordinator",
        f"file://{store}", "--distributed-platform", "cpu"], world,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _lines(out):
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


def test_train_two_processes_equal_one_and_only_rank0_validates(corpus, tmp_path, capsys):
    """Two data ranks of 2 rows against one process of 4: the final loss
    within 1e-3 (JAX's tolerance); only rank 0 prints the log and the
    validation lines (``valid_uer``, summed over the ranks' rows), and it
    writes ``best``."""
    valid = ["--valid-manifest", corpus[1], "--valid-interval", "2",
             "--best-checkpoint-metric", "uer", "--max-updates", "3"]
    one = cli_train.main(_train_args(corpus, tmp_path / "one", *valid))
    out1 = capsys.readouterr().out
    outs = _ranks("speecht5_tpu_torch.cli.train",
                  lambda r: _train_args(corpus, tmp_path / "two", *valid), tmp_path / "store")
    lines = [_lines(o) for o in outs]
    done = [l[-1] for l in lines]
    assert [d["process"] for d in done] == [0, 1] and all(d["steps"] == 3 for d in done)
    for d in done:
        np.testing.assert_allclose(d["final_loss"], one["final_loss"], rtol=1e-3)
    v1 = [l for l in _lines(out1) if "valid_uer" in l]
    v2 = [l for l in lines[0] if "valid_uer" in l]
    assert len(v2) == 1 and not any("valid_uer" in l for l in lines[1])
    assert not any("step" in l and "loss" in l for l in lines[1])
    np.testing.assert_allclose(v2[0]["valid_uer"], v1[0]["valid_uer"], atol=1e-6)
    np.testing.assert_allclose(v2[0]["valid_loss"], v1[0]["valid_loss"], rtol=1e-3)
    assert lines[0][0]["parallel"] == {"backend": "gloo", "world": 2,
                                       "mesh": {"data": 2, "model": 1}, "fsdp": False,
                                       "device": "cpu"}
    assert os.path.exists(tmp_path / "two" / "best" / "best.json")
    assert sorted(os.listdir(tmp_path / "two" / "best")) == sorted(
        os.listdir(tmp_path / "one" / "best"))


def test_fsdp_checkpoint_resumes_in_one_process(corpus, tmp_path):
    """A 2-rank ``--fsdp`` run saved at update 2 (parameters and AdamW
    moments gathered whole, written by rank 0) resumes in one process;
    update 3 equals the uninterrupted one-process run's within 1e-5."""
    full = cli_train.main(_train_args(corpus, tmp_path / "full", "--max-updates", "3"))
    _ranks("speecht5_tpu_torch.cli.train",
           lambda r: _train_args(corpus, tmp_path / "fsdp", "--max-updates", "2", "--fsdp"),
           tmp_path / "store")
    resumed = cli_train.main(_train_args(corpus, tmp_path / "fsdp", "--max-updates", "3"))
    assert resumed["steps"] == 3 and len(resumed["history"]) == 1
    for k, v in resumed["history"][0].items():
        np.testing.assert_allclose(v, full["history"][2][k], rtol=1e-5, err_msg=k)


def test_evaluate_data_parallel_equals_one_process_and_jax(corpus, tmp_path, capsys):
    """Batch 8 over 2 ranks (4 rows each), 6 of the 8 utterances so the tail
    batch is padded: the hypotheses rank 0 writes equal the one-process
    port's and those of JAX's ``--data-parallel`` decode (the batch sharded
    over its 8 devices, the weights replicated)."""
    d, manifest, labels, dict_path = corpus
    lines = open(manifest, encoding="utf-8").read().splitlines()
    man6 = str(tmp_path / "six.tsv")
    lab6 = str(tmp_path / "six.ltr")
    with open(man6, "w", encoding="utf-8") as f:
        f.write("\n".join(lines[:7]) + "\n")
    with open(lab6, "w", encoding="utf-8") as f:
        f.write("\n".join(open(labels, encoding="utf-8").read().splitlines()[:6]) + "\n")
    cfg = JC.speecht5_tiny(**chip_smoke.DICT_CFG)
    jm, variables = jinit_model(cfg, jax.random.PRNGKey(3), wav_len=4000)
    ckpt = tmp_path / "ckpt"
    model = init_model(PC.speecht5_tiny(**chip_smoke.DICT_CFG), device="cpu")
    flat = lambda tree: {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}
    model.load_state_dict({**from_jax_params(flat(variables["params"])),
                           **from_jax_batch_stats(flat(variables["batch_stats"]))})
    save_model_only(ckpt, model.state_dict(), 1)
    args = ["--task", "s2t", "--arch", "speecht5_tiny", "--manifest", man6, "--labels", lab6,
            "--dict", dict_path, "--ckpt", str(ckpt), "--batch-size", "8", "--beam", "3",
            "--max-len", "8", "--ctc-weight", "0.3", "--device", "cpu"]
    one = evaluate.main(args + ["--results-path", str(tmp_path / "one")])
    capsys.readouterr()
    outs = _ranks("speecht5_tpu_torch.cli.evaluate",
                  lambda r: args + ["--data-parallel", "--results-path", str(tmp_path / "two")],
                  tmp_path / "store")
    assert "data-parallel decode over 2 ranks" in outs[0] and not _lines(outs[1])
    two = _lines(outs[0])[-1]
    hyps = [open(tmp_path / p / "hyps.txt", encoding="utf-8").read().splitlines()
            for p in ("one", "two")]
    assert hyps[0] == hyps[1] and len(hyps[0]) == 6 and two["value"] == one["value"]

    dictionary, _ = load_cli_dictionary(dict_path)
    ds = SpeechToTextDataset(manifest=man6, labels=lab6, dictionary=dictionary)
    items = [ds[i] for i in range(6)]
    batch = ds.collate(items + [items[-1]] * 2, cfg.eos_id, cfg.pad_id)
    mesh = jax_mesh(n_data=8, n_model=1)
    dec = JASR(jm, jshard_vars(variables, mesh), beam_size=3, max_len=8, ctc_weight=0.3)
    res = dec(*jshard_batch((jnp.asarray(batch["wav"]), jnp.asarray(batch["wav_lengths"])),
                            mesh))
    toks, lens = np.asarray(res.tokens)[:, 0], np.asarray(res.lengths)[:, 0]
    want = [letters_to_text(dictionary.string(toks[b, 1 : max(int(lens[b]) - 1, 1)]))
            for b in range(6)]
    assert hyps[1] == want and any(want)
