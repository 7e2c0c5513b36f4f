"""VALL-E X zero-shot TTS: AR + NAR codec-LM training, synthesis and the
EnCodec decode to a waveform.

The port of the JAX package's ``recipes/vallex_tts.py`` (a paper-level
build, ``models/vallex.py``):

1. trains the AR stage (codebook 0 over the phonemes and the acoustic
   prompt) and the NAR stage (codebooks 1..K-1, the stage rotating every
   update) on a phoneme-keyed synthetic code corpus: ``code_k[t] =
   (3 * phoneme[t % LP] + k) % C``;
2. synthesizes from a 2-frame acoustic prompt: the AR stage generates
   codebook 0 to eos, the NAR passes fill the rest;
3. decodes prompt + continuation through the port's EnCodec
   (``models/encodec.py``) and writes the waveform.

The weights are random, from ``--seed``.  At the default step count it
closes with the JAX recipe's gates: both losses fall 4x and over 90% of
the synthesized codes follow the learned mapping.

    python -m speecht5_tpu_torch.recipes.vallex_tts [--steps N] [--device cuda|cpu] \\
        [--out vallex_tts.wav]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data.audio import write_wav
from ..models.encodec import EncodecConfig, init_encodec
from ..models.vallex import init_vallex, vallex_tiny
from ..utils.device import resolve_device
from .common import adamw

DEFAULT_STEPS = 150
LR = 5e-3
B, LP, LC = 4, 6, 8            # utterances, phonemes, code frames
PROMPT = 2                     # the acoustic prompt's frames at synthesis


def code_corpus(cfg, seed: int = 0):
    """(phonemes [B, LP]: each row a permutation of 3..LP+2, codes [B,
    n_codebooks, LC]), numpy, drawn from ``seed`` as the JAX recipe draws
    them."""
    rng = np.random.default_rng(seed)
    phonemes = np.stack([rng.permutation(np.arange(3, 3 + LP)) for _ in range(B)])
    codes = np.zeros((B, cfg.n_codebooks, LC), np.int64)
    for b in range(B):
        for t in range(LC):
            for k in range(cfg.n_codebooks):
                codes[b, k, t] = (phonemes[b, t % LP] * 3 + k) % cfg.codebook_size
    return phonemes, codes


def codec_config(cfg) -> EncodecConfig:
    """The JAX recipe's small codec: VALL-E X's codebooks, hop 8 at 16 kHz."""
    return EncodecConfig(num_filters=4, hidden_size=8, codebook_size=cfg.codebook_size,
                         num_quantizers=cfg.n_codebooks, upsampling_ratios=(4, 2),
                         num_lstm_layers=1, sampling_rate=16000)


def losses(model, phonemes, codes, stage: int):
    """(AR NLL of codebook 0 under the bos-shifted stream, NAR NLL of
    codebook ``stage``), means over every position."""
    cfg = model.cfg
    prev = torch.cat([torch.full_like(codes[:, 0, :1], cfg.code_bos), codes[:, 0, :-1]], 1)
    ar = F.cross_entropy(model.forward_ar(phonemes, prev).flatten(0, 1),
                         codes[:, 0].flatten())
    nar = F.cross_entropy(model.forward_nar(phonemes, codes, stage).flatten(0, 1),
                          codes[:, stage].flatten())
    return ar, nar


def run(cfg=None, *, steps: int = DEFAULT_STEPS, lr: float = LR, seed: int = 0,
        device="cuda", model=None, codec=None, log=print) -> dict:
    """``steps`` updates of ``model`` (else random weights from ``seed``),
    then synthesis from row 0's prompt and the codec decode -> dict(ar_nll,
    nar_nll (per update), codes [1, K, LC - PROMPT] and lengths of the
    synthesis, want (the corpus' continuation), wav [1, samples] numpy,
    model, codec)."""
    dev = resolve_device(device)
    cfg = cfg or vallex_tiny()
    if model is None:
        model = init_vallex(cfg, torch.Generator().manual_seed(seed), dev)
    if codec is None:
        codec = init_encodec(codec_config(cfg), torch.Generator().manual_seed(seed + 7), dev)
    phonemes, codes = code_corpus(cfg, seed)
    ph, cd = torch.from_numpy(phonemes).to(dev), torch.from_numpy(codes).to(dev)
    model = model.to(dev).train()
    opt = adamw(model, lr)
    ar_nll, nar_nll = [], []
    for step in range(steps):
        ar, nar = losses(model, ph, cd, 1 + step % (cfg.n_codebooks - 1))
        opt.zero_grad(set_to_none=True)
        (ar + nar).backward()
        opt.step()
        ar_nll.append(float(ar.detach()))
        nar_nll.append(float(nar.detach()))
        if (step + 1) % 50 == 0:
            log(json.dumps({"step": step + 1, "ar_nll": round(ar_nll[-1], 4),
                            "nar_nll": round(nar_nll[-1], 4)}))
    model.eval()
    prompt = cd[:1, :, :PROMPT]
    gen, lengths = model.synthesize(ph[:1], prompt, max_new=LC - PROMPT)
    with torch.no_grad():
        wav = codec.decode_codes(torch.cat([prompt, gen], dim=-1))
    return {"ar_nll": ar_nll, "nar_nll": nar_nll, "codes": gen.cpu().numpy(),
            "lengths": lengths.cpu().numpy(), "want": codes[:1, :, PROMPT:],
            "wav": wav.float().cpu().numpy(), "model": model, "codec": codec}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device; the CPU only when asked for")
    ap.add_argument("--out", default="vallex_tts.wav")
    args = ap.parse_args(argv)
    t0 = time.time()
    out = run(steps=args.steps, lr=args.lr, seed=args.seed, device=args.device,
              log=lambda s: print(s, flush=True))
    acc = float((out["codes"] == out["want"]).mean())
    wav = out["wav"]
    ccfg = codec_config(out["model"].cfg)
    assert wav.shape == (1, LC * ccfg.hop_length) and np.isfinite(wav).all()
    if args.steps >= DEFAULT_STEPS:
        for k in ("ar_nll", "nar_nll"):
            assert out[k][-1] < out[k][0] / 4, (k, out[k][0], out[k][-1])
        assert acc > 0.9, f"synthesis diverged from the learned mapping: {acc}"
    write_wav(args.out, wav[0] / max(1e-6, float(np.abs(wav).max())), sr=ccfg.sampling_rate)
    print(json.dumps({"done": True, "steps": args.steps, "ar_nll": out["ar_nll"][-1],
                      "nar_nll": out["nar_nll"][-1], "synthesis_code_accuracy": acc,
                      "wav": args.out, "wav_samples": int(wav.shape[-1]),
                      "wall_s": round(time.time() - t0, 1)}), flush=True)
    return out


if __name__ == "__main__":
    main()
