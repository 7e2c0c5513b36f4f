"""Prosody-SpeechT5 expressive TTS: style learning and prosody transfer.

The port of the JAX package's ``recipes/prosody_tts.py`` (a paper-level
reconstruction, arXiv 2211.11275: ``models/prosody.py``): a two-style
corpus renders the same text to mel = a shared pattern + a style offset
(+1.5 for even rows, -1.5 for odd ones), which only the prosody embedding
can tell apart; ``forward_t2s`` trains on it (TTS L1 + stop BCE + the
predictor's distillation).  At the default step count it closes with the
JAX recipe's gates: the loss falls 4x, the prosody embeddings cluster by
style (cross-style distance over twice the within-style spread), and the
decoder conditioned on an A-style reference renders a positive-mean mel,
on a B-style one a negative-mean mel.  As in JAX, the updates run in train
mode (BatchNorm on batch statistics) and leave the running statistics as
they were (the JAX recipe drops its ``batch_stats`` updates).

    python -m speecht5_tpu_torch.recipes.prosody_tts [--steps N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import speecht5_tiny
from ..models.prosody import ProsodyConfig, init_prosody_speecht5
from ..train.criterions import tts_loss
from ..utils.device import resolve_device
from .common import adamw

DEFAULT_STEPS = 300
LR = 2e-3
TINY_PROSODY = ProsodyConfig(dim=8, conv_channels=16, n_convs=2, predictor_hidden=32)


def style_batch(cfg, seed: int = 0, batch: int = 8, frames: int = 16) -> dict:
    """The JAX recipe's corpus (numpy): the same text for every row, mel =
    a sinusoid pattern + the row's style offset + noise(0.05) from ``seed``,
    its r-thinned prev mel, zero x-vectors."""
    r = cfg.reduction_factor
    rng = np.random.default_rng(seed)
    tokens = np.tile(np.asarray([[5, 6, 7, 8, 2]], np.int64), (batch, 1))
    t = np.arange(frames)[:, None]
    pattern = 0.5 * np.sin(0.7 * t + np.arange(cfg.n_mels)[None, :] * 0.3)
    style = np.asarray([1.5 if b % 2 == 0 else -1.5 for b in range(batch)], np.float32)
    target = (pattern[None] + style[:, None, None]
              + 0.05 * rng.standard_normal((batch, frames, cfg.n_mels))).astype(np.float32)
    thin = target[:, r - 1::r]
    prev = np.concatenate([np.zeros_like(thin[:, :1]), thin[:, :-1]], axis=1)
    return {"tokens": tokens, "prev_mel": prev, "target_mel": target,
            "dec_lengths": np.full((batch,), frames, np.int64),
            "spk": np.zeros((batch, cfg.spk_embed_dim), np.float32)}


def run(cfg=None, pcfg: ProsodyConfig = None, *, steps: int = DEFAULT_STEPS, lr: float = LR,
        seed: int = 0, device="cuda", model=None, batch=None, log=print) -> dict:
    """``steps`` updates of ``model`` (else random weights from ``seed``)
    on ``batch`` (else ``style_batch``) -> dict(losses, pred_losses,
    model in eval mode, batch on the device)."""
    dev = resolve_device(device)
    cfg = cfg or speecht5_tiny()
    pcfg = pcfg or TINY_PROSODY
    if model is None:
        model = init_prosody_speecht5(cfg, pcfg, torch.Generator().manual_seed(seed), dev)
    model = model.to(dev).train()
    b = {k: torch.as_tensor(v).to(dev) for k, v in (batch or style_batch(cfg, seed)).items()}
    r = cfg.reduction_factor
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    opt = adamw(model, lr)
    losses, pred_losses = [], []
    for step in range(steps):
        before, after, stop, _, pred = model.forward_t2s(
            b["tokens"], b["prev_mel"], b["dec_lengths"] // r, b["spk"], b["target_mel"],
            b["dec_lengths"])
        tts, _ = tts_loss(before, after, stop, b["target_mel"], b["dec_lengths"],
                          reduction_factor=r)
        loss = tts + pcfg.pred_loss_weight * pred
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        pred_losses.append(float(pred.detach()))
        if (step + 1) % 100 == 0:
            log(json.dumps({"step": step + 1, "loss": round(losses[-1], 4),
                            "pred_loss": round(pred_losses[-1], 4)}))
    model.load_state_dict(stats, strict=False)
    return {"losses": losses, "pred_losses": pred_losses, "model": model.eval(), "batch": b}


@torch.no_grad()
def gates(model, b) -> dict:
    """The JAX recipe's closing checks -> dict(style_cluster_ratio,
    transfer_mel_mean_a, transfer_mel_mean_b)."""
    r = model.cfg.reduction_factor
    emb = model.prosody_embedding(b["target_mel"], b["dec_lengths"]).float().cpu().numpy()
    a, c = emb[0::2], emb[1::2]
    d_same = (np.linalg.norm(a - a.mean(0), axis=1).mean()
              + np.linalg.norm(c - c.mean(0), axis=1).mean())
    d_cross = np.linalg.norm(a.mean(0) - c.mean(0))

    def teacher_mel(i):
        enc = model.encode_text_ref(b["tokens"][:1], b["target_mel"][i:i + 1],
                                    b["dec_lengths"][:1])
        after = model.decode_speech(enc, b["prev_mel"][:1] * 0.0, b["dec_lengths"][:1] // r,
                                    b["spk"][:1], need_attn=True)[1]
        return float(after.float().mean())

    return {"style_cluster_ratio": float(d_cross / max(d_same, 1e-9)),
            "transfer_mel_mean_a": teacher_mel(0), "transfer_mel_mean_b": teacher_mel(1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device; the CPU only when asked for")
    args = ap.parse_args(argv)
    t0 = time.time()
    out = run(steps=args.steps, lr=args.lr, seed=args.seed, device=args.device,
              log=lambda s: print(s, flush=True))
    g = gates(out["model"], out["batch"])
    if args.steps >= DEFAULT_STEPS:
        first, last = out["losses"][0], out["losses"][-1]
        assert last < first / 4, (first, last)
        assert g["style_cluster_ratio"] > 2, g
        assert g["transfer_mel_mean_a"] > 0.5 and g["transfer_mel_mean_b"] < -0.5, g
    print(json.dumps({"done": True, "steps": args.steps, "loss_first": out["losses"][0],
                      "loss_last": out["losses"][-1], "pred_loss_last": out["pred_losses"][-1],
                      **g, "wall_s": round(time.time() - t0, 1)}), flush=True)
    return out


if __name__ == "__main__":
    main()
