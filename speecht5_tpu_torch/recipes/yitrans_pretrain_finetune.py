"""YiTrans end to end: stage-1 joint pretraining -> ASR / MT / ST fine-tunes.

The port of the JAX package's ``recipes/yitrans_pretrain_finetune.py``
(reference YiTrans/yitrans_iwslt22/: models/pretrain_ed.py:200,
tasks/iwslt_joint_pretraining.py:360-540, tasks/
iwslt_translation_from_pretrain.py:135-205, finetune_asr.py:115 /
finetune_mt.py:89 / finetune_st.py:85):

  stage 1: ``MultiCorpusLoader`` over speech with km units and denoised
           mono text in two languages (``[en_XX]`` / ``[de_DE]`` tags, one
           "text_mono" stream), ``train/joint.yitrans_pretrain_loss``;
  stage 2: fine-tunes each warm-started from stage 1: ASR (0.7 CE + 0.3
           CTC), MT (``LangPairDataset``, prev BOS = the ``[tgt]`` tag) and
           ST (CE);
  decode:  the beam through ``decode/asr.ASRDecoder`` (``encode_text`` for
           MT, ``encode_speech`` for ASR and ST).

Synthetic corpora drawn from ``--seed`` as the JAX recipe draws them; the
weights are random.  It prints one JSON line per update and decode.

    python -m speecht5_tpu_torch.recipes.yitrans_pretrain_finetune \\
        [--pretrain-steps N] [--finetune-steps N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np
import torch

from ..data.dictionary import Dictionary
from ..data.multicorpus import MultiCorpusLoader, TokenCorpusSpec
from ..data.text_noising import NoisingConfig
from ..data.yitrans import LangPairDataset, MultilingualDenoisingDataset, \
    add_multilingual_symbols
from ..decode.asr import ASRDecoder
from ..models.yitrans import init_yitrans, yitrans_tiny
from ..ops.ctc import ctc_loss
from ..train.criterions import label_smoothed_ce
from ..train.joint import JointLossConfig, yitrans_pretrain_loss
from ..utils.device import resolve_device
from .common import adamw

DEFAULT_PRETRAIN_STEPS, DEFAULT_FINETUNE_STEPS = 12, 10
T_WAV, B_SP, B_TXT, L_TXT, N_WORDS = 4000, 2, 4, 12, 40
LANGS = ("en_XX", "de_DE")
TASKS = ("asr", "mt", "st")
#: the JAX recipe's sizes; ``synthetic_data(**sizes)`` takes others
TINY = dict(n_speech=16, wav_samples=(T_WAV, T_WAV), n_mono=20, text_tokens=(L_TXT, L_TXT),
            n_pair=12, pair_tokens=(L_TXT, L_TXT), n_words=N_WORDS, b_sp=B_SP, b_txt=B_TXT,
            tgt_tokens=8)


def _length(rng, bounds) -> int:
    lo, hi = bounds
    return lo if lo == hi else int(rng.integers(lo, hi + 1))


def text_lines(n: int, seed: int, n_words: int = N_WORDS, tokens=(L_TXT, L_TXT)):
    r = np.random.default_rng(seed)
    return [" ".join(f"w{i}" for i in r.integers(0, n_words, _length(r, tokens)))
            for _ in range(n)]


def make_dictionary(n_words: int = N_WORDS):
    """Words ``w0``.. plus the ``[lang]`` tags and ``<mask>`` -> (dictionary,
    {lang: index})."""
    d = Dictionary()
    for i in range(n_words):
        d.add_symbol(f"w{i}")
    return d, add_multilingual_symbols(d, LANGS)


def synthetic_data(cfg, seed: int, device, *, max_sentences=None, **sizes) -> dict:
    """The JAX recipe's corpora (``TINY`` sizes by default; lengths drawn
    in the given (min, max) bounds otherwise) and the stage-1 loader, its
    batches tensors on ``device``; ``max_sentences`` batches the loader by
    count instead of the JAX recipe's token budgets.  -> dict(dictionary,
    lang_ids, speech, mono, pair, loader, rng, sizes); ``rng`` continues
    the recipe's draws (the fine-tune batches)."""
    sz = {**TINY, **sizes}
    d, lang_ids = make_dictionary(sz["n_words"])
    rng = np.random.default_rng(seed)
    speech = []
    for _ in range(sz["n_speech"]):
        n = _length(rng, sz["wav_samples"])
        speech.append({"wav": rng.standard_normal(n).astype(np.float32) * 0.1,
                       "units": rng.integers(0, cfg.unit_vocab_size,
                                             cfg.conv_features.out_length(n), np.int64)})
    noising = NoisingConfig(mask_ratio=0.3)
    mono = [MultilingualDenoisingDataset(
        text_lines(sz["n_mono"], 10 + i, sz["n_words"], sz["text_tokens"]), d, lang,
        noising, seed=seed)
        for i, lang in enumerate(LANGS)]
    pair = LangPairDataset(
        text_lines(sz["n_pair"], 20, sz["n_words"], sz["pair_tokens"]),
        text_lines(sz["n_pair"], 21, sz["n_words"], sz["pair_tokens"]), d, d, *LANGS,
        append_source_id=False, mask_text_ratio=0.2, seed=seed)

    def collate_speech(items):
        T = max(len(x["wav"]) for x in items)
        wav = np.zeros((len(items), T), np.float32)
        units = np.zeros((len(items), cfg.conv_features.out_length(T)), np.int64)
        for b, x in enumerate(items):
            wav[b, : len(x["wav"])] = x["wav"]
            units[b, : len(x["units"])] = x["units"]
        return {"wav": torch.from_numpy(wav).to(device),
                "wav_lengths": torch.tensor([len(x["wav"]) for x in items],
                                            dtype=torch.int32, device=device),
                "units": torch.from_numpy(units).to(device)}

    def collate_text(ds):
        return lambda items: {k: torch.from_numpy(v).long().to(device)
                              for k, v in ds.collate(items, bucketed=False).items()}

    total = len(speech) + sum(len(m) for m in mono)
    wav_budget = sz["wav_samples"][1] * sz["b_sp"]
    # both languages share the "text_mono" stream (the reference concatenates
    # them, iwslt_joint_pretraining.py:449-489)
    text_ratio = (sz["text_tokens"][1] + 1) * sz["b_txt"] / wav_budget
    specs = [TokenCorpusSpec("speech", speech, collate_speech,
                             [len(x["wav"]) for x in speech],
                             sample_ratio=len(speech) / total)]
    specs += [TokenCorpusSpec(f"text_mono.{lang}", m, collate_text(m), m.sizes,
                              sample_ratio=len(m) / total, max_tokens_ratio=text_ratio,
                              stream="text_mono") for lang, m in zip(LANGS, mono)]
    if max_sentences is None:
        loader = MultiCorpusLoader(specs, max_tokens=wav_budget, seed=seed)
    else:
        loader = MultiCorpusLoader(specs, max_tokens=10 ** 12, seed=seed,
                                   max_sentences=max_sentences)
    return {"dictionary": d, "lang_ids": lang_ids, "speech": speech, "mono": mono,
            "pair": pair, "loader": loader, "rng": rng, "sizes": sz}


def finetune_batch(data, task: str, device) -> dict:
    """The JAX recipe's next fine-tune batch (:212-231), from its rng: MT
    a ``LangPairDataset`` collate of ``b_txt`` random pairs; ASR / ST
    ``b_sp`` random utterances with random targets, prev = [de_DE] +
    targets[:-1]."""
    rng, sz = data["rng"], data["sizes"]
    if task == "mt":
        pair = data["pair"]
        idx = rng.integers(0, len(pair), sz["b_txt"])
        b = pair.collate([pair[int(j)] for j in idx], bucketed=False)
        return {k: torch.from_numpy(v).long().to(device) for k, v in b.items()}
    picks = rng.integers(0, len(data["speech"]), sz["b_sp"])
    wavs = [data["speech"][int(j)]["wav"] for j in picks]
    tgt = rng.integers(4, sz["n_words"], (sz["b_sp"], sz["tgt_tokens"]))
    wav = np.zeros((len(wavs), max(len(w) for w in wavs)), np.float32)
    for b, w in enumerate(wavs):
        wav[b, : len(w)] = w
    prev = np.concatenate([np.full((sz["b_sp"], 1), data["lang_ids"]["de_DE"]), tgt[:, :-1]], 1)
    return {"wav": torch.from_numpy(wav).to(device),
            "wav_lengths": torch.tensor([len(w) for w in wavs], dtype=torch.int32,
                                        device=device),
            "prev_tokens": torch.from_numpy(prev).to(device),
            "targets": torch.from_numpy(tgt).to(device)}


def finetune_loss(model, task: str, batch, generator=None):
    """The JAX recipe's fine-tune losses (:165-203): MT and ST label-smoothed
    CE (0.1); ASR 0.7 CE + 0.3 CTC (per-utterance NLL mean / 8) with the
    HuBERT masks on."""
    cfg = model.cfg
    tgt = batch["targets"]
    valid = tgt != cfg.pad_id
    if task == "mt":
        logits = model.forward_mt(batch["src_tokens"], batch["prev_tokens"],
                                  generator=generator)
        return label_smoothed_ce(logits.float(), tgt, valid, 0.1)[0]
    if task == "st":
        logits = model.forward_st(batch["wav"], batch["wav_lengths"], batch["prev_tokens"],
                                  mask=False, generator=generator)
        return label_smoothed_ce(logits.float(), tgt, valid, 0.1)[0]
    logits, ctc_logits, enc_valid = model.forward_asr(
        batch["wav"], batch["wav_lengths"], batch["prev_tokens"], mask=True,
        generator=generator)
    ce, _ = label_smoothed_ce(logits.float(), tgt, valid, 0.1)
    lp = torch.log_softmax(ctc_logits.float(), dim=-1)
    nll = ctc_loss(lp, enc_valid.sum(-1), tgt, valid.sum(-1), cfg.blank_id)
    return 0.7 * ce + 0.3 * nll.mean() / 8


def pretrain(model, loader, steps: int, lr: float, *, jcfg=JointLossConfig(),
             generator=None, log=print):
    """``steps`` stage-1 updates over ``loader``, epoch after epoch ->
    (losses, the last update's metrics as floats)."""
    model.train()
    opt = adamw(model, lr)
    losses, metrics, epoch = [], {}, 0
    while len(losses) < steps:
        for _, joint in loader.iter_epoch(epoch):
            loss, m = yitrans_pretrain_loss(model, joint, jcfg, generator=generator)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            metrics = {k: float(v.detach()) for k, v in m.items()}
            log(json.dumps({"stage": "pretrain", "step": len(losses),
                            "loss": round(losses[-1], 4),
                            "denoise_loss": round(metrics.get("denoise_loss", -1), 4)}))
            if len(losses) >= steps:
                break
        epoch += 1
    return losses, metrics


def finetune(pretrained, task: str, batches, lr: float, *, generator=None, log=print):
    """A copy of ``pretrained`` (the warm start) trained one update per
    batch -> (model in eval mode, losses)."""
    model = copy.deepcopy(pretrained).train()
    opt = adamw(model, lr)
    losses = []
    for i, batch in enumerate(batches):
        loss = finetune_loss(model, task, batch, generator)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        log(json.dumps({"stage": f"finetune_{task}", "step": i + 1,
                        "loss": round(losses[-1], 4)}))
    model.zero_grad(set_to_none=True)
    return model.eval(), losses


def decoder_for(model, task: str, device, **kw) -> ASRDecoder:
    """The beam of ``task``: MT reads ``encode_text``, ASR and ST
    ``encode_speech``."""
    return ASRDecoder(model, device=device, **kw,
                      encode_method="encode_text" if task == "mt" else "encode_speech")


def run(cfg=None, *, pretrain_steps: int = DEFAULT_PRETRAIN_STEPS,
        finetune_steps: int = DEFAULT_FINETUNE_STEPS, lr: float = 1e-3, seed: int = 1,
        device="cuda", log=print) -> dict:
    """The chain at ``cfg`` (default ``yitrans_tiny`` at the recipe
    dictionary's size): stage 1, then per task a warm-started fine-tune
    and a beam (3, max_len 10) on the recipe's decode input.  -> dict(
    pretrain_losses, finetune_losses {task: [...]}, hyps {task: first
    hypothesis' tokens}, model (stage 1's), metrics)."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = yitrans_tiny(vocab_size=len(make_dictionary()[0]))
    data = synthetic_data(cfg, seed, dev)
    model = init_yitrans(cfg, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(seed + 7)
    torch.manual_seed(seed + 7)
    data["rng"].integers(4, 40, (B_SP, 8))      # the JAX recipe's unused asr_prev draw
    pre, metrics = pretrain(model, data["loader"], pretrain_steps, lr, generator=gen, log=log)
    out = {"pretrain_losses": pre, "metrics": metrics, "finetune_losses": {}, "hyps": {}}
    for task in TASKS:
        batches = [finetune_batch(data, task, dev) for _ in range(finetune_steps)]
        ft, out["finetune_losses"][task] = finetune(model, task, batches, lr, generator=gen,
                                                    log=log)
        dec = decoder_for(ft, task, dev, beam_size=3, max_len=10)
        if task == "mt":
            pair = data["pair"]
            res = dec(pair.collate([pair[0], pair[1]], bucketed=False)["src_tokens"])
        else:
            wav = data["speech"][0]["wav"]
            res = dec(wav[None], [len(wav)])
        out["hyps"][task] = res.tokens[0, 0].tolist()
        log(json.dumps({"stage": f"decode_{task}", "hyp0": out["hyps"][task][:8]}))
        del ft
    out["model"] = model.eval()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pretrain-steps", type=int, default=DEFAULT_PRETRAIN_STEPS)
    ap.add_argument("--finetune-steps", type=int, default=DEFAULT_FINETUNE_STEPS)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    args = ap.parse_args(argv)
    t0 = time.time()
    out = run(pretrain_steps=args.pretrain_steps, finetune_steps=args.finetune_steps,
              lr=args.lr, seed=args.seed, device=args.device,
              log=lambda s: print(s, flush=True))
    print(f"all stages done in {time.time() - t0:.1f}s", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
