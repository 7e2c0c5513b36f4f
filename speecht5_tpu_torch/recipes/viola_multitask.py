"""VioLA multi-task codec LM: ASR, MT and TTS in one decoder-only model,
cascaded ST, and the EnCodec decode of the TTS codes.

The port of the JAX package's ``recipes/viola_multitask.py`` (arXiv
2305.16107, ``models/viola.py``):

1. trains one causal LM on interleaved ASR (unit u -> text u % V), MT
   (text t -> text t + 1) and TTS (text t -> code t % C) rows with the
   target-masked cross-entropy, plus the MT row of the first ASR row's text
   (the cascade below reads it);
2. decodes every training row's continuation greedily (TTS constrained to
   the code block) and composes ASR -> MT as cascaded ST;
3. decodes a generated TTS code stream through the port's EnCodec (one
   codebook) and writes the waveform.

The weights are random, from ``--seed``.  At the default step count it
closes with the JAX recipe's gates: the loss falls 8x, every task's
continuations are exact and the cascade gives the MT of the ASR text.

    python -m speecht5_tpu_torch.recipes.viola_multitask [--steps N] \\
        [--device cuda|cpu] [--out viola_tts.wav]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..data.audio import write_wav
from ..models.encodec import EncodecConfig, init_encodec
from ..models.viola import build_example, init_viola, viola_tiny
from ..utils.device import resolve_device
from .common import adamw

DEFAULT_STEPS = 300
LR = 5e-3
L = 14                         # a row's length


def corpus(cfg, seed: int = 0):
    """The JAX recipe's rows (12 rounds of ASR, MT, TTS drawn from ``seed``,
    then the MT row of the first ASR row's text) -> (tokens [37, L],
    target masks [37, L]), numpy."""
    rng = np.random.default_rng(seed)

    def asr():
        us = rng.integers(0, cfg.unit_vocab, 3)
        return build_example(cfg, "asr", 0, [cfg.unit0 + int(u) for u in us],
                             [cfg.text0 + int(u) % cfg.text_vocab for u in us], L)

    def mt():
        ts = rng.integers(0, cfg.text_vocab, 3)
        return build_example(cfg, "mt", 1, [cfg.text0 + int(t) for t in ts],
                             [cfg.text0 + (int(t) + 1) % cfg.text_vocab for t in ts], L)

    def tts():
        ts = rng.integers(0, cfg.text_vocab, 2)
        return build_example(cfg, "tts", 0, [cfg.text0 + int(t) for t in ts],
                             [cfg.code0 + int(t) % cfg.codebook_size for t in ts], L)

    rows = [f() for _ in range(12) for f in (asr, mt, tts)]
    asr0 = rows[0][0]
    sep = int(np.nonzero(asr0 == cfg.sep_id)[0][0])
    eos = int(np.nonzero(asr0 == cfg.eos_id)[0][0])
    text = asr0[sep + 1:eos].tolist()
    rows.append(build_example(cfg, "mt", 1, text,
                              [cfg.text0 + ((t - cfg.text0) + 1) % cfg.text_vocab
                               for t in text], L))
    return np.stack([r[0] for r in rows]).astype(np.int64), np.stack([r[1] for r in rows])


def continuation(cfg, row):
    """A row -> (its prefix through <sep> [1, n], the continuation's ids
    through eos)."""
    sep = int(np.nonzero(row == cfg.sep_id)[0][0])
    eos = int(np.nonzero(row == cfg.eos_id)[0][0])
    return row[None, :sep + 1], row[sep + 1:eos + 1].tolist()


def codec_config(cfg) -> EncodecConfig:
    """The JAX recipe's small one-codebook codec (hop 8 at 16 kHz)."""
    return EncodecConfig(num_filters=4, hidden_size=8, codebook_size=cfg.codebook_size,
                         num_quantizers=1, upsampling_ratios=(4, 2), num_lstm_layers=1,
                         sampling_rate=16000)


def run(cfg=None, *, steps: int = DEFAULT_STEPS, lr: float = LR, seed: int = 0,
        device="cuda", model=None, codec=None, log=print) -> dict:
    """``steps`` updates of ``model`` (else random weights from ``seed``),
    then the per-task greedy decodes, the cascade and the codec decode ->
    dict(losses, accuracy {task: exact-match share}, st_ok, tts_codes,
    wav [1, samples] numpy, model, codec)."""
    dev = resolve_device(device)
    cfg = cfg or viola_tiny()
    if model is None:
        model = init_viola(cfg, torch.Generator().manual_seed(seed), dev)
    if codec is None:
        codec = init_encodec(codec_config(cfg), torch.Generator().manual_seed(seed + 11), dev)
    tokens, mask = corpus(cfg, seed)
    toks, msk = torch.from_numpy(tokens).to(dev), torch.from_numpy(mask).to(dev)
    model = model.to(dev).train()
    opt = adamw(model, lr)
    losses = []
    for step in range(steps):
        loss = model.lm_loss(toks, msk)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if (step + 1) % 100 == 0:
            log(json.dumps({"step": step + 1, "lm_loss": round(losses[-1], 4)}))
    model.eval()
    gen = lambda prefix, n, **kw: [t.cpu() for t in model.generate(
        torch.from_numpy(np.asarray(prefix, np.int64)).to(dev), max_new=n, **kw)]
    acc = {}
    for name, first in (("asr", 0), ("mt", 1), ("tts", 2)):
        hits = [0, 0]
        for r in range(first, 36, 3):
            prefix, want = continuation(cfg, tokens[r])
            out, _ = gen(prefix, len(want) + 1)
            hits[0] += int(out[0, :len(want)].tolist() == want)
            hits[1] += 1
        acc[name] = hits[0] / hits[1]
    # cascaded ST: units -> text by ASR, then the text through MT
    prefix, _ = continuation(cfg, tokens[0])
    out, lengths = gen(prefix, 6)
    text = out[0, :int(lengths[0])].tolist()
    out2, _ = gen([[cfg.lang_id(1), cfg.task_id("mt"), *text, cfg.sep_id]], 5)
    st_want = [cfg.text0 + ((t - cfg.text0) + 1) % cfg.text_vocab for t in text]
    st_ok = out2[0, :len(st_want)].tolist() == st_want
    # a TTS row's codes through the codec
    prefix, want = continuation(cfg, tokens[2])
    out3, lens3 = gen(prefix, len(want) + 1)
    codes = (out3[0, :int(lens3[0])] - cfg.code0).clamp(0, cfg.codebook_size - 1)
    wav = torch.zeros((1, 0))
    if len(codes):      # an untrained model may end the stream at once
        with torch.no_grad():
            wav = codec.decode_codes(codes[None, None].to(dev))
    return {"losses": losses, "accuracy": acc, "st_ok": st_ok, "tts_codes": codes.tolist(),
            "wav": wav.float().cpu().numpy(), "model": model, "codec": codec}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device; the CPU only when asked for")
    ap.add_argument("--out", default="viola_tts.wav")
    args = ap.parse_args(argv)
    t0 = time.time()
    out = run(steps=args.steps, lr=args.lr, seed=args.seed, device=args.device,
              log=lambda s: print(s, flush=True))
    wav = out["wav"]
    ccfg = codec_config(out["model"].cfg)
    assert wav.shape == (1, len(out["tts_codes"]) * ccfg.hop_length) and np.isfinite(wav).all()
    if args.steps >= DEFAULT_STEPS:
        assert out["losses"][-1] < out["losses"][0] / 8, (out["losses"][0], out["losses"][-1])
        assert out["st_ok"] and all(v == 1.0 for v in out["accuracy"].values()), out["accuracy"]
    write_wav(args.out, wav[0] / max(1e-6, float(np.abs(wav).max(initial=0.0))),
              sr=ccfg.sampling_rate)
    print(json.dumps({"done": True, "steps": args.steps, "lm_loss_first": out["losses"][0],
                      "lm_loss_last": out["losses"][-1], "gen_exact_match": out["accuracy"],
                      "cascaded_st_ok": out["st_ok"], "wav": args.out,
                      "wav_samples": int(wav.shape[-1]), "wall_s": round(time.time() - t0, 1)}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
