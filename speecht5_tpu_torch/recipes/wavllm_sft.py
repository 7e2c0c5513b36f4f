"""WavLLM SFT: a reference-format TSV -> LoRA-only AdamW -> greedy decoding.

The port of the JAX package's ``recipes/wavllm_sft.py`` (:34-118; the
reference's SFT stage, speechllm_model.py:131-136: the LLaMA trunk and the
audio encoders frozen, the LoRA pairs, the adapters and the audio
projections trained):

- ``byte_tokenizer``: UTF-8 bytes into the vocabulary (4 + b mod (V - 4));
- ``load_batch``: ``data/wavllm.WavLLMDataset`` over the TSV, each item cut
  to ``max_frames`` mel frames (and their samples) and ``max_target``
  target tokens, collated;
- ``freeze_for_sft`` + ``make_optimizer``: ``requires_grad=False`` on every
  parameter ``lora_param_filter`` does not name (what ``optax.set_to_zero``
  does for them in JAX), AdamW at optax's defaults on the rest;
- ``sft_loss``: the cross-entropy of ``forward_sft`` over the real target
  tokens, the model in train mode (dropout on in the frozen encoders too,
  as JAX's ``deterministic=False``);
- ``greedy``: ``generate`` after the updates.

Without ``--tsv`` the recipe writes a synthetic corpus (``write_corpus``:
seeded tones in noise as 16 kHz WAVs, prompts, byte targets) into a
temporary directory.  The model is ``wavllm_tiny(n_mels=80)`` with random
weights and a RoPE table of ``TINY_SEQ_LEN`` rows: the chat template's
left prompt alone is 205 tokens, past the tiny preset's 128 (JAX's
recipe runs past it, its gather clamping the index).

    python -m speecht5_tpu_torch.recipes.wavllm_sft [--tsv asr.tsv --audio-root audio/] \\
        [--steps 5] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data.audio import write_wav
from ..data.wavllm import WHISPER_HOP, WHISPER_SR, WavLLMDataset
from ..models.wavllm import WavLLMModel, init_wavllm, lora_param_filter, wavllm_tiny
from ..utils.device import resolve_device
from .common import ADAMW

DEFAULT_STEPS = 5
MAX_NEW = 8            # greedy tokens after training (the root recipe's)
TINY_SEQ_LEN = 512
PROMPTS = ("Transcribe the audio clip into text.",
           "What is the speaker talking about?",
           "Translate the audio clip into German.")
WORDS = ("the", "cat", "sat", "on", "a", "mat", "and", "then", "went", "home", "to", "sleep")


def byte_tokenizer(vocab_size: int):
    def tok(text):
        return [4 + (b % (vocab_size - 4)) for b in text.encode("utf-8")]
    return tok


def write_corpus(directory: str, n: int, seconds=(1.0, 1.6), target_bytes=(8, 16),
                 seed: int = 0) -> str:
    """``n`` seeded clips of ``seconds`` (tones in noise, 16 kHz WAV), each
    with one of ``PROMPTS`` and a target of ``target_bytes`` bytes of
    words, and the reference-format TSV listing them -> the TSV's path."""
    rng = np.random.default_rng(seed)
    rows = ["id\taudio\tn_frames\tprompt\ttgt_text\twith_speech"]
    for i in range(n):
        samples = int(rng.uniform(*seconds) * WHISPER_SR)
        t = np.arange(samples) / WHISPER_SR
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
        wav = (wav + 0.02 * rng.standard_normal(samples)).astype(np.float32)
        write_wav(os.path.join(directory, f"u{i}.wav"), wav)
        want = int(rng.integers(target_bytes[0], target_bytes[1] + 1))
        text = ""
        while len(text) < want:
            text = (text + " " + WORDS[int(rng.integers(len(WORDS)))]).strip()
        rows.append(f"u{i}\tu{i}.wav\t{samples}\t{PROMPTS[i % len(PROMPTS)]}\t{text[:want]}\tTrue")
    path = os.path.join(directory, "sft.tsv")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    return path


def load_batch(tsv: str, tokenize, cfg, *, audio_root: str = "", max_frames=None,
               max_target=None) -> dict:
    """Every item of the TSV (``cfg``'s BOS / EOS / pad ids), cut to
    ``max_frames`` mel frames (their samples: ``max_frames`` x 160) and
    ``max_target`` target tokens (None: whole), collated -> numpy batch
    (the JAX recipe's :54-66)."""
    ds = WavLLMDataset(tsv, tokenize, audio_root=audio_root, bos_id=cfg.bos_id,
                       eos_id=cfg.eos_id, pad_id=cfg.pad_id)
    items = []
    for i in range(len(ds)):
        it = ds[i]
        if max_frames is not None:
            it = dict(it, wav=it["wav"][: max_frames * WHISPER_HOP], mel=it["mel"][:max_frames])
        if max_target is not None:
            it = dict(it, target_tokens=it["target_tokens"][:max_target])
        items.append(it)
    return ds.collate(items)


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device`` (tokens int64, lengths int32)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if k.endswith("_tokens"):
            t = t.long()
        out[k] = t.to(device)
    return out


def freeze_for_sft(model: WavLLMModel) -> list:
    """Train what ``lora_param_filter`` names, freeze the rest -> the
    trainable parameters."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(lora_param_filter(name))
        if p.requires_grad:
            trainable.append(p)
    return trainable


def make_optimizer(params, lr: float):
    return torch.optim.AdamW(params, lr=lr, **ADAMW)


def sft_loss(model: WavLLMModel, batch: dict):
    """The mean cross-entropy of ``forward_sft``'s logits over the real
    (non-pad) target tokens (the JAX recipe's :88-100)."""
    logits, _ = model.forward_sft(batch["mel"], batch["mel_lengths"], batch["prompt_tokens"],
                                  batch["target_tokens"], batch["wav"], batch["wav_lengths"],
                                  batch["left_tokens"])
    tgt = batch["target_tokens"]
    mask = (tgt != model.cfg.pad_id).float()
    ce = F.cross_entropy(logits.float().flatten(0, 1), tgt.flatten(), reduction="none")
    return (ce * mask.flatten()).sum() / mask.sum()


def sft_update(model: WavLLMModel, opt, batch: dict) -> float:
    """One update in train mode -> the loss."""
    model.train()
    loss = sft_loss(model, batch)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return float(loss.detach())


def greedy(model: WavLLMModel, batch: dict, max_new: int):
    model.eval()
    return model.generate(batch["mel"], batch["mel_lengths"], batch["prompt_tokens"],
                          max_new=max_new, wav=batch["wav"], wav_lengths=batch["wav_lengths"],
                          left_tokens=batch["left_tokens"])


def run(*, tsv: str = None, audio_root: str = "", steps: int = DEFAULT_STEPS, lr: float = 1e-3,
        max_frames: int = 100, max_target: int = 12, device="cuda", seed: int = 0,
        log=print) -> dict:
    """The recipe: ``wavllm_tiny(n_mels=80, max_seq_len=TINY_SEQ_LEN)`` with
    random weights from ``seed``, trained ``steps`` updates on the TSV's
    batch (a synthetic corpus of 4 clips without one), then greedy decoding
    of ``MAX_NEW`` tokens -> dict(losses, tokens, n_trainable, n_params,
    model)."""
    dev = resolve_device(device)
    model = init_wavllm(wavllm_tiny(n_mels=80, max_seq_len=TINY_SEQ_LEN),
                        torch.Generator(device=dev).manual_seed(seed), dev)
    cfg = model.cfg
    with tempfile.TemporaryDirectory() as d:
        if tsv is None:
            tsv = write_corpus(d, 4, seed=seed)
        batch = to_device(load_batch(tsv, byte_tokenizer(cfg.vocab_size), cfg,
                                     audio_root=audio_root, max_frames=max_frames,
                                     max_target=max_target), dev)
    params = freeze_for_sft(model)
    n_train = sum(p.numel() for p in params)
    n_all = sum(p.numel() for p in model.parameters())
    log(f"trainable (LoRA/adapters): {n_train} params of {n_all}")
    opt = make_optimizer(params, lr)
    losses = []
    for i in range(steps):
        losses.append(sft_update(model, opt, batch))
        log(f"step {i}: loss {losses[-1]:.4f}")
    tokens = greedy(model, batch, MAX_NEW)
    log("greedy tokens: " + json.dumps(tokens[0].tolist()))
    return {"losses": losses, "tokens": tokens, "n_trainable": n_train, "n_params": n_all,
            "model": model}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tsv", default=None, help="reference-format TSV (default: synthetic)")
    ap.add_argument("--audio-root", default="")
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max-frames", type=int, default=100)
    ap.add_argument("--max-target", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device; the CPU only when asked for")
    args = ap.parse_args(argv)
    t0 = time.time()
    out = run(tsv=args.tsv, audio_root=args.audio_root, steps=args.steps, lr=args.lr,
              max_frames=args.max_frames, max_target=args.max_target, device=args.device,
              seed=args.seed, log=lambda s: print(s, flush=True))
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
