"""The Speech2S speech-to-speech translation chain: speech -> units by the
beam -> the unit vocoder -> a WAV file.

The port of the JAX package's ``recipes/speech2s_s2st.py`` (reference
Speech2S/speech2s/stpretrain_scripts/decode_text2code_beam2.sh decodes
speech to units with a beam, eval2.sh vocodes them):

1. trains a SpeechUT (Speech2S's core) on phone-coded speech toward reduced
   unit sequences: the decoder's cross-entropy over a vocabulary that IS
   the unit vocabulary (specials 0-3, ``<ctc_blank>`` 4, units from 5);
2. beams the units with ``ASRDecoder`` (pad and blank never win);
3. vocodes the hypothesis' ids with ``CodeHiFiGAN`` (duration re-expansion
   on) and writes the waveform with ``data/audio.write_wav``.

The vocoder's unit table spans the decoder vocabulary, so the decoded ids
go to it as they are, as in JAX (ROADMAP C.2: a special id the beam does
not suppress reaches the vocoder as a unit).  The weights are random, from
``--seed``; the updates run in train mode (the tiny preset has no
dropout, JAX's recipe trains deterministically).  At the default step
count it closes with the JAX recipe's gates: the unit loss falls 10x and
every utterance's units decode exactly.

    python -m speecht5_tpu_torch.recipes.speech2s_s2st [--steps N] [--device cuda|cpu] \\
        [--out speech2s_s2st.wav]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data.audio import write_wav
from ..decode.asr import ASRDecoder
from ..models.hifigan import CodeHiFiGANConfig, HiFiGANConfig, init_codehifigan
from ..models.speechut import init_speechut, speechut_tiny
from ..utils.device import resolve_device
from .common import adamw

DEFAULT_STEPS = 300
LR = 2e-3
N_UNITS = 8
UNIT0 = 5                      # specials 0-3, <ctc_blank> 4
B, LP, SEG = 8, 4, 2000        # utterances, phones each, samples a phone


def tiny_config():
    return speechut_tiny(text_vocab_size=UNIT0 + N_UNITS)


def vocoder_config(num_units: int = UNIT0 + N_UNITS) -> CodeHiFiGANConfig:
    """The JAX recipe's small unit vocoder (hop 320 = 5 * 4 * 4 * 4, the
    duration predictor on, at most 4 frames a unit)."""
    return CodeHiFiGANConfig(
        num_units=num_units, embed_dim=32, dur_predictor=True, max_duration=4,
        generator=HiFiGANConfig(in_dim=32, upsample_initial_channel=64,
                                upsample_rates=(5, 4, 4, 4),
                                upsample_kernel_sizes=(11, 8, 8, 8),
                                resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),),
                                normalize_before=False))


def phone_corpus(eos_id: int, seed: int = 0) -> dict:
    """``B`` utterances of ``LP`` sine bursts at phone-keyed frequencies
    (numpy, from ``seed`` as the JAX recipe draws them) -> dict(wav [B, LP
    * SEG] f32, units [B, LP] (decoder ids), prev_tokens, targets)."""
    rng = np.random.default_rng(seed)
    phones = rng.integers(0, N_UNITS, (B, LP))
    wavs = np.zeros((B, LP * SEG), np.float32)
    t = np.arange(SEG) / 16000.0
    for b in range(B):
        for i, ph in enumerate(phones[b]):
            wavs[b, i * SEG:(i + 1) * SEG] = 0.3 * np.sin(2 * np.pi * (220.0 + 130.0 * ph) * t)
    units = phones + UNIT0
    targets = np.concatenate([units, np.full((B, 1), eos_id)], axis=1)
    prev = np.concatenate([np.full((B, 1), eos_id), units], axis=1)
    return {"wav": wavs, "units": units, "prev_tokens": prev, "targets": targets}


def unit_loss(model, batch):
    """The decoder's mean cross-entropy toward the units (+ eos)."""
    enc = model.encode_speech(batch["wav"], batch["wav_lengths"])
    logits = model.decode_text(enc, batch["prev_tokens"])
    return F.cross_entropy(logits.flatten(0, 1), batch["targets"].flatten())


def decode_units(model, wav, wav_lengths, *, beam: int = 2, max_len: int = LP + 2,
                 device="cuda"):
    """The beam over the unit vocabulary -> (each utterance's best
    hypothesis without its BOS and EOS (decoder ids), the beam's result,
    the decoder: its ``steps_run``)."""
    dec = ASRDecoder(model, beam_size=beam, max_len=max_len, device=device)
    res = dec(wav, wav_lengths)
    toks, lens = res.tokens[:, 0].cpu(), res.lengths[:, 0].cpu()
    return [toks[b, 1:int(lens[b]) - 1].tolist() for b in range(toks.shape[0])], res, dec


def run(cfg=None, *, steps: int = DEFAULT_STEPS, lr: float = LR, seed: int = 0,
        device="cuda", model=None, vocoder=None, log=print) -> dict:
    """Train ``model`` (else random weights from ``seed``) for ``steps``
    updates, beam every utterance, vocode the first -> dict(losses, units
    (decoded), want_units, wav [1, samples] f32 numpy, model, vocoder)."""
    dev = resolve_device(device)
    cfg = cfg or tiny_config()
    if model is None:
        model = init_speechut(cfg, torch.Generator().manual_seed(seed), dev)
    if vocoder is None:
        vocoder = init_codehifigan(vocoder_config(cfg.text_vocab_size),
                                   torch.Generator().manual_seed(seed + 2), dev)
    corpus = phone_corpus(cfg.eos_id, seed)
    batch = {k: torch.from_numpy(corpus[k]).to(dev) for k in ("wav", "prev_tokens", "targets")}
    batch["wav_lengths"] = torch.full((B,), corpus["wav"].shape[1], dtype=torch.int64)
    model = model.to(dev).train()
    opt = adamw(model, lr)
    losses = []
    for step in range(steps):
        loss = unit_loss(model, batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if (step + 1) % 50 == 0:
            log(json.dumps({"step": step + 1, "unit_nll": round(losses[-1], 4)}))
    model.eval()
    units, _, _ = decode_units(model, batch["wav"], batch["wav_lengths"], device=dev)
    with torch.no_grad():
        wav = vocoder(torch.tensor([units[0]], dtype=torch.int64, device=dev))
    return {"losses": losses, "units": units, "want_units": corpus["units"].tolist(),
            "wav": wav.float().cpu().numpy(), "model": model, "vocoder": vocoder}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device; the CPU only when asked for")
    ap.add_argument("--out", default="speech2s_s2st.wav")
    args = ap.parse_args(argv)
    t0 = time.time()
    out = run(steps=args.steps, lr=args.lr, seed=args.seed, device=args.device,
              log=lambda s: print(s, flush=True))
    wav, hop = out["wav"], 5 * 4 * 4 * 4
    acc = float(np.mean([h == w for h, w in zip(out["units"], out["want_units"])]))
    assert wav.shape == (1, len(out["units"][0]) * vocoder_config().max_duration * hop)
    assert np.isfinite(wav).all()
    if args.steps >= DEFAULT_STEPS:
        assert out["losses"][-1] < out["losses"][0] / 10, out["losses"]
        assert acc == 1.0, f"unit decode exact-match {acc}: {out['units'][:2]}"
    write_wav(args.out, wav[0] / max(1e-6, float(np.abs(wav).max())))
    print(json.dumps({"done": True, "steps": args.steps, "unit_nll_first": out["losses"][0],
                      "unit_nll_last": out["losses"][-1], "unit_decode_exact_match": acc,
                      "wav": args.out, "wav_samples": int(wav.shape[-1]),
                      "wall_s": round(time.time() - t0, 1)}), flush=True)
    return out


if __name__ == "__main__":
    main()
