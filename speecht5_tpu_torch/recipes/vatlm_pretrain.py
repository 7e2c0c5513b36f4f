"""VATLM tri-modal pretraining: audio + video + phone masked prediction.

The port of the JAX package's ``recipes/vatlm_pretrain.py`` (reference
VATLM/vat_hubert/vathubert/models/vathubert.py:338,
criterions/vathubert_criterion.py:45, data mixing
tasks/vathubert_pretraining.py:216): every update runs the audio+video,
audio-only and phone-only streams through one model
(``train/joint.vatlm_pretrain_loss``), the video BatchNorm in training
mode.  The JAX recipe's synthetic batch (km labels keyed into the audio
features, so masked prediction is learnable), drawn from ``--seed`` as JAX
draws it; the weights are random.  At the default 100 updates every
stream's loss falls: the closing assert holds runs of at least that many.

    python -m speecht5_tpu_torch.recipes.vatlm_pretrain [--steps N] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.vatlm import init_vatlm, vatlm_tiny
from ..train.joint import VATLM_STREAMS, vatlm_pretrain_loss
from ..utils.device import resolve_device
from .common import adamw

DEFAULT_STEPS = 100
B, T = 2, 16


def synthetic_batch(cfg, seed: int, batch: int = B, frames: int = T) -> dict:
    """The JAX recipe's batch (:44-59): km labels, audio features one-hot
    on ``label % audio_feat_dim`` plus noise, video noise, random phones ->
    numpy dict(audio, video, lengths, phones, targets)."""
    rng = np.random.default_rng(seed)
    km = rng.integers(0, cfg.num_classes[0], (batch, frames)).astype(np.int32)
    audio = np.zeros((batch, frames, cfg.audio_feat_dim), np.float32)
    for b in range(batch):
        for f in range(frames):
            audio[b, f, int(km[b, f]) % cfg.audio_feat_dim] = 1.0
    audio += 0.05 * rng.standard_normal(audio.shape).astype(np.float32)
    video = (rng.standard_normal((batch, frames, cfg.video_size, cfg.video_size, 1))
             * 0.1).astype(np.float32)
    phones = rng.integers(4, 12, (batch, frames)).astype(np.int32)
    return {"audio": audio, "video": video, "lengths": np.full(batch, frames, np.int32),
            "phones": phones, "targets": km}


def on_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device).long() if v.dtype == np.int32 and k != "lengths"
            else torch.from_numpy(v).to(device) for k, v in batch.items()}


def run(cfg=None, *, steps: int = DEFAULT_STEPS, lr: float = 1e-3, seed: int = 0,
        device="cuda", model=None, batch=None, log=print) -> dict:
    """``steps`` updates of ``model`` (else random weights from ``seed``) on
    ``batch`` (numpy, else the synthetic one; a list: one batch an update,
    in turn) -> dict(losses, first, last: each stream's loss, model); the
    draws of ``vatlm_pretrain_loss`` from a generator seeded ``seed + 7``."""
    dev = resolve_device(device)
    cfg = cfg or vatlm_tiny()
    if model is None:
        model = init_vatlm(cfg, torch.Generator().manual_seed(seed), dev)
    model = model.to(dev).train()
    batches = batch if isinstance(batch, list) else [
        batch if batch is not None else synthetic_batch(cfg, seed)]
    batches = [on_device(b, dev) for b in batches]
    gen = torch.Generator().manual_seed(seed + 7)
    torch.manual_seed(seed + 7)
    opt = adamw(model, lr)
    losses, first, last = [], None, None
    for step in range(steps):
        loss, m = vatlm_pretrain_loss(model, batches[step % len(batches)], generator=gen)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        last = {k: float(v.detach()) for k, v in m.items()}
        first = first or last
        if (step + 1) % 25 == 0:
            log(json.dumps({"step": step + 1, **{k: round(v, 4) for k, v in last.items()}}))
    return {"losses": losses, "first": first, "last": last, "model": model.eval()}


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
    for name, _ in VATLM_STREAMS:
        assert out["last"][name] < out["first"][name], (name, out["first"], out["last"])
    print(json.dumps({"done": True, "steps": args.steps,
                      "first": {k: round(v, 3) for k, v in out["first"].items()},
                      "last": {k: round(v, 3) for k, v in out["last"].items()},
                      "wall_s": round(time.time() - t0, 1)}), flush=True)
    return out


if __name__ == "__main__":
    main()
