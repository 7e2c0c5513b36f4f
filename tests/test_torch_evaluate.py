"""The port's ``cli/evaluate.py`` held against the JAX package's decoders
(tests/test_cli.py:51 and :349 are the specification): on the same weights
(JAX ``tiny`` s2t parameters carried by ``from_jax_params`` into port
checkpoints) and the same collated batches, the hypotheses that
``evaluate --results-path`` writes and its corpus WER equal those of JAX's
``ASRDecoder`` (with a fusion LM from ``--lm-ckpt``, with
``--ensemble-last 2``), ``CTCDecoder`` (greedy; with ``--avg-last 2``; the
lexicon arm) and ``RescoreDecoder``.  ``--task s2c`` and ``--task t2s``
(with ``--griffin-lim``) run on checkpoints that ``cli/train.py`` wrote and
print their metric; the flags JAX refuses are refused.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict
import torch

import speecht5_tpu.config as JC
from speecht5_tpu.data.dictionary import letters_to_text
from speecht5_tpu.decode.asr import (ASRDecoder as JASR, CTCDecoder as JCTC,
                                     RescoreDecoder as JRescore)
from speecht5_tpu.decode.lexicon import LexiconDecoder as JLexicon
from speecht5_tpu.models.lm import TransformerLM as JLM, lm_tiny as jlm_tiny
from speecht5_tpu.models.speecht5 import SpeechT5Model as JModel
from speecht5_tpu.utils.checkpoint import average_checkpoints as javg
from speecht5_tpu.utils.metrics import corpus_wer as jwer

import chip_smoke
import speecht5_tpu_torch.config as PC
from speecht5_tpu_torch.cli import evaluate, train as cli_train
from speecht5_tpu_torch.data.dictionary import load_cli_dictionary
from speecht5_tpu_torch.data.manifests import SpeechToTextDataset
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.utils.checkpoint import save_model_only
from speecht5_tpu_torch.utils.convert import lm_from_jax_params
from test_torch_beam import _init_jax, _load

torch.backends.cuda.matmul.allow_tf32 = False
N_UTTS = 6


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Six 0.3-0.7 s utterances, two port checkpoints (steps 1 and 2: the
    JAX weights and 0.9 times them), a tiny fusion LM's model-only
    checkpoint, a lexicon and a word 3-gram over random words."""
    d = str(tmp_path_factory.mktemp("eval"))
    manifest, labels, dict_path = chip_smoke.write_corpus(d, N_UTTS, seconds=(0.3, 0.7))
    cfg = JC.speecht5_tiny(**chip_smoke.DICT_CFG)
    v1 = _init_jax(cfg)
    v2 = jax.tree_util.tree_map(lambda a: a * 0.9, v1)
    pcfg = PC.speecht5_tiny(**chip_smoke.DICT_CFG)
    ckpt = os.path.join(d, "ckpt")
    for step, v in ((1, v1), (2, v2)):
        save_model_only(ckpt, _load(init_model(pcfg, device="cpu"), v).state_dict(), step)
    jlm = JLM(dataclasses.replace(jlm_tiny(), vocab_size=cfg.vocab_size, pad_id=cfg.pad_id))
    lm_v = jlm.init(jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32))
    save_model_only(os.path.join(d, "lm"), lm_from_jax_params(_flat(lm_v["params"])), 1)
    lexicon, arpa = chip_smoke.write_lexicon_lm(d, 30, seed=2)
    dictionary, _ = load_cli_dictionary(dict_path)
    ds = SpeechToTextDataset(manifest=manifest, labels=labels, dictionary=dictionary)
    batches = [ds.collate([ds[i] for i in range(s, min(s + 4, N_UTTS))], cfg.eos_id,
                          cfg.pad_id) for s in range(0, N_UTTS, 4)]
    refs = [letters_to_text(line) for line in ds.label_lines]
    return {"dir": d, "manifest": manifest, "labels": labels, "dict": dict_path,
            "ckpt": ckpt, "cfg": cfg, "v1": v1, "v2": v2, "jlm": jlm, "lm_v": lm_v,
            "lexicon": lexicon, "arpa": arpa, "dictionary": dictionary,
            "batches": batches, "refs": refs}


def _run(setup, tmp_path, *flags):
    out = str(tmp_path / "res")
    result = evaluate.main([
        "--task", "s2t", "--arch", "speecht5_tiny", "--manifest", setup["manifest"],
        "--labels", setup["labels"], "--dict", setup["dict"], "--ckpt", setup["ckpt"],
        "--batch-size", "4", "--results-path", out, "--device", "cpu", *flags])
    hyps = open(os.path.join(out, "hyps.txt"), encoding="utf-8").read().splitlines()
    return result, hyps


def _jax_hyps(setup, rows_fn):
    """JAX's decoder over the same batches -> texts (JAX evaluate's loop)."""
    hyps = []
    for batch in setup["batches"]:
        for row in rows_fn(jnp.asarray(batch["wav"]), jnp.asarray(batch["wav_lengths"])):
            hyps.append(letters_to_text(setup["dictionary"].string(np.asarray(row))))
    return hyps


def _beam_rows(dec):
    def rows(wav, wlen):
        res = dec(wav, wlen)
        toks, lens = np.asarray(res.tokens)[:, 0], np.asarray(res.lengths)[:, 0]
        return [toks[b, 1 : max(int(lens[b]) - 1, 1)] for b in range(toks.shape[0])]
    return rows


def _jlexicon(setup, beam=50):
    d = setup["dictionary"]
    return JLexicon(setup["lexicon"], list(d.symbols), arpa_path=setup["arpa"],
                    blank=setup["cfg"].blank_id, sep=d.index("|"), lm_weight=0.5,
                    word_score=1.0, beam=beam)


LEX = ["--lm-weight", "0.5", "--word-score", "1"]


@pytest.mark.parametrize("name", ["beam_lm", "beam_ensemble", "ctc_greedy_avg",
                                  "ctc_lexicon", "ctc_rescore", "ctc_rescore_lexicon"])
def test_evaluate_s2t_equals_jax_decoders(setup, tmp_path, capsys, name):
    cfg, v1, v2 = setup["cfg"], setup["v1"], setup["v2"]
    model = JModel(cfg)
    beam = ["--beam", "3", "--max-len", "8", "--ctc-weight", "0.3"]
    lex = ["--lexicon", setup["lexicon"], "--lm-path", setup["arpa"], *LEX]
    if name == "beam_lm":
        flags = [*beam, "--lm-ckpt", os.path.join(setup["dir"], "lm"), "--lm-arch", "tiny",
                 "--lm-weight", "0.5"]
        rows = _beam_rows(JASR(model, v2, beam_size=3, max_len=8, ctc_weight=0.3,
                               lm=setup["jlm"], lm_variables=setup["lm_v"], lm_weight=0.5))
    elif name == "beam_ensemble":
        flags = [*beam, "--ensemble-last", "2"]
        rows = _beam_rows(JASR(model, [v1, v2], beam_size=3, max_len=8, ctc_weight=0.3))
    elif name == "ctc_greedy_avg":
        flags = ["--decoder", "ctc_greedy", "--avg-last", "2"]
        avg = {"params": javg([v1["params"], v2["params"]])}
        rows = JCTC(model, avg, blank_id=cfg.blank_id)
    elif name == "ctc_lexicon":
        flags = ["--decoder", "ctc_lexicon", *lex]
        rows = JCTC(model, v2, blank_id=cfg.blank_id, lexicon=_jlexicon(setup))
    else:
        lexicon = name == "ctc_rescore_lexicon"
        flags = ["--decoder", "ctc_rescore", "--ctc-weight", "0.3", "--max-len", "8",
                 *(lex if lexicon else [])]
        rows = JRescore(model, v2, blank_id=cfg.blank_id, eos_id=cfg.eos_id,
                        pad_id=cfg.pad_id, nbest=8, beam=50, ctc_weight=0.3, max_len=8,
                        lexicon=_jlexicon(setup) if lexicon else None)
    result, hyps = _run(setup, tmp_path, *flags)
    want = _jax_hyps(setup, rows)
    assert hyps == want and any(want)
    assert result["metric"] == "wer" and result["n_utts"] == N_UTTS
    assert result["value"] == jwer(setup["refs"], want)
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == result
    if name == "beam_lm":
        assert "fusion LM loaded (step 1), weight 0.5" in out
    if name == "beam_ensemble":
        assert "ensemble of 2 checkpoints [1, 2]" in out
    if name == "ctc_greedy_avg":
        assert "averaged 2 checkpoints [1, 2]" in out


def test_evaluate_refuses_what_jax_refuses(setup, tmp_path, capsys):
    base = ["--task", "s2t", "--arch", "speecht5_tiny", "--manifest", setup["manifest"],
            "--labels", setup["labels"], "--dict", setup["dict"], "--ckpt",
            setup["ckpt"], "--device", "cpu"]
    with pytest.raises(SystemExit):          # a word LM without a lexicon
        evaluate.main(base + ["--decoder", "ctc_lexicon", "--lm-path", setup["arpa"]])
    assert "--lm-path requires --lexicon" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="requires --decoder beam"):
        evaluate.main(base + ["--decoder", "ctc_greedy", "--ensemble-last", "2"])
    with pytest.raises(SystemExit, match="no best checkpoint"):
        evaluate.main(base + ["--use-best"])
    assert evaluate.build_parser().get_default("device") == "cuda"


def test_evaluate_s2c_and_t2s_run_on_checkpoints_train_wrote(tmp_path, capsys):
    """--task s2c reads class_map.txt next to the checkpoint and reports an
    accuracy; --task t2s reports MCD and the focus rate and writes a mel
    and a Griffin-Lim WAV per utterance; --use-best reads <ckpt>/best."""
    d = str(tmp_path)
    manifest = chip_smoke.write_sid_corpus(d, 4, seconds=(0.3, 0.5), speakers=2)
    sid = ["--arch", "speecht5_tiny", "--manifest", manifest, "--device", "cpu",
           "--override", "sid.no_pooling_bn=True", "--override", "sid.no_embed_postnet=True"]
    cli_train.main(["--task", "s2c", *sid, "--save-dir", f"{d}/sid", "--batch-size", "2",
                    "--max-updates", "1"])
    result = evaluate.main(["--task", "s2c", *sid, "--ckpt", f"{d}/sid", "--batch-size", "4"])
    assert result["metric"] == "accuracy" and result["n_utts"] == 4
    assert 0.0 <= result["value"] <= 1.0
    tdir = os.path.join(d, "t2s")
    os.makedirs(tdir)
    man, labels, dict_path, spk = chip_smoke.write_t2s_corpus(tdir, 2, seconds=(0.3, 0.5),
                                                              spk_dim=16)
    t2s = ["--arch", "speecht5_tiny", "--manifest", man, "--labels", labels, "--dict",
           dict_path, "--spkemb-dir", spk, "--device", "cpu"]
    cli_train.main(["--task", "t2s", *t2s, "--save-dir", f"{d}/tts", "--batch-size", "2",
                    "--max-updates", "1", "--valid-manifest", man, "--valid-labels", labels,
                    "--valid-interval", "1", "--best-checkpoint-metric", "loss"])
    res_dir = os.path.join(d, "out")
    result = evaluate.main(["--task", "t2s", *t2s, "--ckpt", f"{d}/tts", "--use-best",
                            "--max-frames", "16", "--results-path", res_dir,
                            "--griffin-lim"])
    assert result["metric"] == "mcd" and np.isfinite(result["value"])
    assert 0.0 <= result["focus_rate"] <= 1.0
    assert sorted(os.listdir(res_dir)) == ["0.npy", "0.wav", "1.npy", "1.wav"]
    out = capsys.readouterr().out
    assert "loaded BEST checkpoint step 1" in out and '"metric": "mcd"' in out


def test_chip_smoke_evaluate_phase_runs_on_cpu_with_twins(tmp_path):
    """Phase 19 at the tiny preset on the CPU, in the train phase's
    directory: two checkpoints kept, the four decoders' WER lines."""
    flags = ["--batch-size", "2", "--accum", "2", "--ctc-weight", "0.5", "--normalize"]
    d = str(tmp_path)
    trained = chip_smoke.phase_train(d, "speecht5_tiny", device="cpu", n_utts=4,
                                     updates=2, seconds=(0.3, 0.8), flags=flags)
    ev = chip_smoke.phase_evaluate(d, trained["args"], 2, device="cpu",
                                   arch="speecht5_tiny", n_utts=3, seconds=(0.3, 0.6),
                                   max_len=8, n_words=50)
    assert set(ev["results"]) == {"beam", "ctc_greedy", "ctc_lexicon", "ctc_rescore"}
    assert all(r["n_utts"] == 3 for r in ev["results"].values())
    assert set(ev["counts"].values()) == {0}
