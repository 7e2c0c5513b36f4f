"""SpeechLM CTC ASR fine-tune: ``SpeechLMCtc`` and the CTC loss.

The port of the JAX package's ``recipes/speechlm_ctc_finetune.py``
(reference SpeechLM/speechlm/models/speechlm_ctcasr.py:22-56 and
config/finetune/speechlm_base_100h.yaml; decoding speechlm/infer.py):
the encoder stack, the CTC head and greedy (viterbi) decoding on a
synthetic corpus of 8 tone-keyed utterances (each letter id keyed to a
tone), the same corpus from the same seed.  The weights are random, drawn
from ``--seed``; a real run starts from a pretrained encoder.  At the
default 300 updates it overfits the corpus: the closing asserts (the loss
falls tenfold, UER under 0.1) hold runs of at least that many updates.

    python -m speecht5_tpu_torch.recipes.speechlm_ctc_finetune [--steps N] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.speechlm import init_speechlm, speechlm_tiny
from ..ops.ctc import ctc_loss
from ..utils.device import resolve_device
from ..utils.metrics import edit_distance
from .common import adamw

DEFAULT_STEPS = 300
BLANK, V = 0, 8          # ids 2..7 are the "letters"
B, T_WAV, L = 8, 4000, 4


def synthetic_corpus(seed: int, n: int = B, t_wav: int = T_WAV):
    """[(wav f32 [t_wav], labels int32 [L])] drawn as JAX draws them (``n``
    and ``t_wav`` as the JAX recipe's: 8 utterances of 4000 samples)."""
    rng = np.random.default_rng(seed)

    def sample():
        labels = rng.integers(2, V, (L,))
        t = np.arange(t_wav) / 16000.0
        wav = np.zeros(t_wav, np.float32)
        seg = t_wav // L
        for j, lab in enumerate(labels):
            wav[j * seg : (j + 1) * seg] = 0.3 * np.sin(2 * np.pi * 150.0 * (1 + int(lab))
                                                        * t[:seg])
        wav += 0.01 * rng.standard_normal(t_wav).astype(np.float32)
        return wav.astype(np.float32), labels.astype(np.int32)

    return [sample() for _ in range(n)]


def loss_fn(model, wav, labels, *, keep_mask=None):
    """The mean CTC NLL over the batch (JAX recipe ``loss_fn``); ``keep_mask``
    hands in the head's dropout keep mask."""
    n = wav.shape[0]
    lengths = torch.full((n,), wav.shape[1], dtype=torch.int32, device=wav.device)
    logits, valid = model(wav, lengths, keep_mask=keep_mask)
    lp = torch.log_softmax(logits, dim=-1)
    nll = ctc_loss(lp, valid.sum(-1), labels,
                   torch.full((n,), labels.shape[1], device=wav.device), blank_id=BLANK)
    return nll.mean()


def greedy_uer(model, data, device) -> float:
    """Greedy CTC decoding of ``data`` -> the unit error rate."""
    err = tot = 0
    with torch.no_grad():
        for s in range(0, len(data), B):
            chunk = data[s : s + B]
            wav = torch.from_numpy(np.stack([d[0] for d in chunk])).to(device)
            lengths = torch.full((len(chunk),), wav.shape[1], dtype=torch.int32,
                                 device=device)
            logits, valid = model(wav, lengths)
            ids = logits.argmax(-1).cpu().numpy()
            lens = valid.sum(-1).cpu().numpy()
            for b in range(ids.shape[0]):
                seq = ids[b, : lens[b]]
                if len(seq):
                    seq = seq[np.concatenate([[True], seq[1:] != seq[:-1]])]
                seq = seq[seq != BLANK]
                ref = chunk[b][1].tolist()
                err += edit_distance(seq.tolist(), ref)
                tot += len(ref)
    return err / max(tot, 1)


def run(cfg=None, *, steps: int = DEFAULT_STEPS, lr: float = 1e-3, seed: int = 0,
        device="cuda", model=None, data=None, keep_masks=None, log=print) -> dict:
    """Train ``SpeechLMCtc`` (``model``, else random weights from ``seed``)
    for ``steps`` full-batch updates on ``data`` (else the synthetic
    corpus), then decode it greedily.  ``keep_masks``: per update the
    head's dropout keep mask (else drawn).  -> dict(losses, uer, model)."""
    dev = resolve_device(device)
    cfg = cfg or speechlm_tiny()
    if model is None:
        model = init_speechlm(cfg, torch.Generator().manual_seed(seed), dev,
                              ctc_vocab_size=V)
    model = model.to(dev).train()
    data = data if data is not None else synthetic_corpus(seed)
    torch.manual_seed(seed + 7)
    opt = adamw(model, lr)
    wav = torch.from_numpy(np.stack([d[0] for d in data])).to(dev)
    labels = torch.from_numpy(np.stack([d[1] for d in data])).to(dev)
    losses = []
    for step in range(steps):
        loss = loss_fn(model, wav, labels,
                       keep_mask=None if keep_masks is None else keep_masks[step])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if (step + 1) % 50 == 0:
            log(json.dumps({"step": step + 1, "ctc_loss": round(losses[-1], 4)}))
    model.eval()
    return {"losses": losses, "uer": greedy_uer(model, data, dev), "model": model}


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
    loss0, loss = out["losses"][0], out["losses"][-1]
    if args.steps >= DEFAULT_STEPS:
        assert loss < loss0 / 10, (loss0, loss)
        assert out["uer"] < 0.1, f"toy overfit UER too high: {out['uer']}"
    print(json.dumps({"done": True, "steps": args.steps,
                      "ctc_loss_first": round(loss0, 2),
                      "ctc_loss_last": round(loss, 4),
                      "uer": round(out["uer"], 4),
                      "wall_s": round(time.time() - t0, 1)}), flush=True)
    return out


if __name__ == "__main__":
    main()
