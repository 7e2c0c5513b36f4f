"""Speech2C pretraining: HuBERT masked prediction + the code seq2seq decoder.

The port of the JAX package's ``recipes/speech2c_pretrain.py`` (reference
Speech2C/speech2c/models/speech2c.py:111 and criterions/
speech2c_criterion.py:42-120): one update is the HuBERT masked CE over km
labels plus the decoder's CE on the deduplicated code sequence
(``models/speech2c.speech2c_pretrain_loss``), on the JAX recipe's
synthetic tone corpus (km labels keyed to tones) at ``speecht5_tiny``,
drawn from ``--seed`` as JAX draws it; the weights are random.  At the
default 120 updates both terms fall: the closing asserts (HuBERT below its
first value, the decoder CE below half its first) hold runs of at least
that many updates.

    python -m speecht5_tpu_torch.recipes.speech2c_pretrain [--steps N] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import speecht5_tiny
from ..models.speech2c import init_speech2c, speech2c_pretrain_loss
from ..utils.device import resolve_device
from .common import adamw

DEFAULT_STEPS = 120
B, T_WAV, N_KM, LC = 4, 4000, 8, 24


def synthetic_batch(cfg, seed: int) -> dict:
    """The JAX recipe's batch: km labels, tones keyed to them, the
    deduplicated code targets (+4, EOS, padded to 24) and their EOS-shifted
    prev -> numpy dict(wav, wav_lengths, km_labels, decoder_targets,
    prev_tokens)."""
    frames = cfg.conv_features.out_length(T_WAV)
    rng = np.random.default_rng(seed)
    km = rng.integers(0, N_KM, (B, frames)).astype(np.int32)
    wav = np.zeros((B, T_WAV), np.float32)
    t = np.arange(T_WAV) / 16000.0
    hop = T_WAV // frames
    for b in range(B):
        for f in range(frames):
            wav[b, f * hop : (f + 1) * hop] = 0.2 * np.sin(
                2 * np.pi * 120.0 * (1 + int(km[b, f])) * t[:hop])

    def dedup(row):
        out = [row[0]]
        for x in row[1:]:
            if x != out[-1]:
                out.append(x)
        out = (out + [cfg.eos_id])[:LC]
        return np.pad(np.asarray(out, np.int32), (0, LC - len(out)),
                      constant_values=cfg.pad_id)

    codes = np.stack([dedup((km[b] + 4).tolist()) for b in range(B)])
    prev = np.full_like(codes, cfg.pad_id)
    prev[:, 0] = cfg.eos_id
    prev[:, 1:] = codes[:, :-1]
    return {"wav": wav, "wav_lengths": np.full((B,), T_WAV, np.int32), "km_labels": km,
            "decoder_targets": codes, "prev_tokens": prev}


def run(cfg=None, *, steps: int = DEFAULT_STEPS, lr: float = 1e-3, seed: int = 0,
        device="cuda", model=None, batches=None, masks=None, log=print) -> dict:
    """``steps`` updates of ``model`` (else random weights from ``seed``)
    cycling over ``batches`` (numpy dicts as ``synthetic_batch`` gives, or
    as ``SpeechPretrainDataset(add_decoder_target=True).collate`` gives;
    else the one synthetic batch).  ``masks``: per update the HuBERT masks
    (else drawn from a generator seeded ``seed + 7``).  -> dict(first,
    last (metrics as floats), losses, model)."""
    dev = resolve_device(device)
    cfg = cfg or speecht5_tiny()
    if model is None:
        model = init_speech2c(cfg, torch.Generator().manual_seed(seed), dev)
    model = model.to(dev).train()
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items() if hasattr(v, "dtype")}
               for b in (batches or [synthetic_batch(cfg, seed)])]
    gen = torch.Generator().manual_seed(seed + 7)
    torch.manual_seed(seed + 7)
    opt = adamw(model, lr)
    first, losses, m = None, [], {}
    for step in range(steps):
        b = batches[step % len(batches)]
        out = model.forward_pretrain(b["wav"], b["wav_lengths"], b["prev_tokens"],
                                     generator=gen,
                                     masks=None if masks is None else masks[step])
        loss, m = speech2c_pretrain_loss(out, b["km_labels"], b["decoder_targets"],
                                         cfg.pad_id)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        m = {k: float(v.detach()) for k, v in m.items() if k != "loss"}
        losses.append(float(loss.detach()))
        first = first or m
        if (step + 1) % 40 == 0:
            log(json.dumps({"step": step + 1, **{k: round(v, 4) for k, v in m.items()}}))
    return {"first": first, "last": m, "losses": losses, "model": model.eval()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    args = ap.parse_args(argv)
    t0 = time.time()
    out = run(steps=args.steps, lr=args.lr, seed=args.seed, device=args.device,
              log=lambda s: print(s, flush=True))
    first, last = out["first"], out["last"]
    if args.steps >= DEFAULT_STEPS:
        assert last["hubert"] < first["hubert"], (first, last)
        assert last["dec_ce"] < first["dec_ce"] / 2, (first, last)
    print(json.dumps({"done": True, "steps": args.steps,
                      "first": {k: round(v, 3) for k, v in first.items()},
                      "last": {k: round(v, 3) for k, v in last.items()},
                      "wall_s": round(time.time() - t0, 1)}), flush=True)
    return out


if __name__ == "__main__":
    main()
