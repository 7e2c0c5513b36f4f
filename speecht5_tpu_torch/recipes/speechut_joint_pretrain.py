"""SpeechUT joint pretraining: ``MultiCorpusLoader`` + ``speechut_joint_loss``.

The port of the JAX package's ``recipes/speechut_joint_pretrain.py``
(reference SpeechUT/speechut/criterions/speechut_criterion.py:166-265,
data side SpeechLM/speechlm/data/multimodal_corpus_dataset.py:24): every
update consumes a heterogeneous {speech, text_paired, text_mono} sample
from three synthetic corpora, drawn from ``--seed`` as JAX draws them;
the weights are random.  It prints one JSON line per update and has no
closing assert (the JAX recipe has none).

    python -m speecht5_tpu_torch.recipes.speechut_joint_pretrain [--steps N] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..data.multicorpus import MultiCorpusLoader, TokenCorpusSpec
from ..models.speechut import init_speechut, speechut_tiny
from ..train.joint import JointLossConfig, speechut_joint_loss
from ..utils.device import resolve_device
from .common import adamw

DEFAULT_STEPS = 20
T_WAV = 4000
JOINT = JointLossConfig(u2t_ed_weight=0.1, u2t_ctc_weight=0.1, text_mum_weight=0.5)


def synthetic_loader(cfg, seed: int, device) -> MultiCorpusLoader:
    """The JAX recipe's three corpora (fixed-length items, so every step
    has the batch shapes (2, 2, 2)) under its token budgets; the collated
    batches are tensors on ``device``."""
    t_wav, b_sp, b_pair, b_mono = T_WAV, 2, 2, 2
    n_speech, n_paired, n_mono = 16, 10, 12
    paired_units, paired_text, mono_units = 10, 6, 12
    rng = np.random.default_rng(seed)
    frames = cfg.conv_features.out_length(t_wav)
    speech_ds = [{"wav": rng.standard_normal(t_wav).astype(np.float32) * 0.1,
                  "units": rng.integers(2, cfg.unit_vocab_size, frames, np.int64)}
                 for _ in range(n_speech)]
    paired_ds = [{"units": rng.integers(2, cfg.unit_vocab_size, paired_units, np.int64),
                  "targets": rng.integers(5, cfg.text_vocab_size, paired_text, np.int64)}
                 for _ in range(n_paired)]
    mono_ds = [{"units": rng.integers(2, cfg.unit_vocab_size, mono_units, np.int64)}
               for _ in range(n_mono)]
    stack = lambda items, key: torch.from_numpy(np.stack([x[key] for x in items])).to(device)

    def collate_speech(items):
        return {"wav": stack(items, "wav"),
                "wav_lengths": torch.full((len(items),), t_wav, dtype=torch.int32,
                                          device=device),
                "units": stack(items, "units")}

    def collate_paired(items):
        tgt = stack(items, "targets")
        prev = torch.cat([torch.full_like(tgt[:, :1], cfg.eos_id), tgt[:, :-1]], 1)
        return {"units": stack(items, "units"), "prev_tokens": prev, "targets": tgt}

    def collate_mono(items):
        return {"units": stack(items, "units")}

    total = n_speech + n_paired + n_mono
    return MultiCorpusLoader([
        TokenCorpusSpec("speech", speech_ds, collate_speech, np.full(n_speech, t_wav),
                        sample_ratio=n_speech / total),
        TokenCorpusSpec("text_paired", paired_ds, collate_paired,
                        np.full(n_paired, paired_units), sample_ratio=n_paired / total,
                        max_tokens_ratio=(paired_units * b_pair) / (t_wav * b_sp)),
        TokenCorpusSpec("text_mono", mono_ds, collate_mono, np.full(n_mono, mono_units),
                        sample_ratio=n_mono / total,
                        max_tokens_ratio=(mono_units * b_mono) / (t_wav * b_sp)),
    ], max_tokens=t_wav * b_sp, seed=seed)


def run(cfg=None, *, steps: int = DEFAULT_STEPS, lr: float = 5e-4, seed: int = 1,
        device="cuda", model=None, loader=None, jcfg: JointLossConfig = JOINT,
        draws=None, log=print) -> dict:
    """``steps`` joint updates of ``model`` (else random weights from
    ``seed``) over ``loader`` (else the synthetic corpora), epoch after
    epoch.  ``draws``: per update the draws of ``train/joint`` (else drawn
    from a generator seeded ``seed + 7``).  -> dict(losses, metrics (the
    last update's, floats), model)."""
    dev = resolve_device(device)
    cfg = cfg or speechut_tiny()
    if model is None:
        model = init_speechut(cfg, torch.Generator().manual_seed(seed), dev)
    model = model.to(dev).train()
    loader = loader or synthetic_loader(cfg, seed, dev)
    gen = torch.Generator().manual_seed(seed + 7)
    torch.manual_seed(seed + 7)
    opt = adamw(model, lr)
    losses, metrics, epoch = [], {}, 0
    while len(losses) < steps:
        for _, joint in loader.iter_epoch(epoch):
            loss, m = speechut_joint_loss(
                model, joint, jcfg, generator=gen,
                draws=None if draws is None else draws[len(losses)])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            metrics = {k: float(v.detach()) for k, v in m.items()}
            log(json.dumps({"step": len(losses), "loss": round(losses[-1], 4),
                            **{k: round(v, 4) for k, v in metrics.items()
                               if k.endswith("loss") or "loss_m" in k}}))
            if len(losses) >= steps:
                break
        epoch += 1
    return {"losses": losses, "metrics": metrics, "model": model.eval()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    args = ap.parse_args(argv)
    t0 = time.time()
    out = run(steps=args.steps, lr=args.lr, seed=args.seed, device=args.device,
              log=lambda s: print(s, flush=True))
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
