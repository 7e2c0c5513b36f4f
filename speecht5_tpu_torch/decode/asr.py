"""ASR decoding: the joint CTC/attention beam search and greedy CTC.

Port of ``speecht5_tpu/decode/asr.py``:

- ``ASRDecoder`` (JAX :34-292): the encoder forward and CTC head
  (reference speecht5.py:1112-1140), KV-cached decoder steps (reference
  speecht5.py:1151-1164) and the per-step score combination of reference
  sequence_generator.py:370-432: the top ``beam * 1.5`` candidates by
  attention score get (1 - w) * attention + w * CTC-prefix delta, the
  others keep their attention score; pad and blank suppressed, unk
  penalized.  Beam, CTC prefix state and caches stay on the device for the
  whole batch; the host runs the loop (``decode/beam_search.py``).
  Shallow LM fusion (``lm=``, used by the JAX ``cli/evaluate.py``, not by
  serving) is not ported yet.
- ``CTCDecoder`` (JAX :295-380): one encoder + CTC-head forward, the argmax
  on the device, and only the ``[B, T]`` int32 frame ids and the frame
  lengths copied to the host for the greedy collapse (JAX asr.py:332-337).

The lexicon arm and ``RescoreDecoder`` arrive with their slice.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ctc_prefix
from .beam_search import NEG_INF, BeamResult, beam_search
from ..utils.masks import mask_lengths
from ..utils.device import resolve_device

CTC_SCORING_RATIO = 1.5  # ctc_beam = beam * ratio (reference CTC_SCORING_RATIO=1.5)


def _tile_rows(x, beam: int):
    """[B, ...] -> [B*beam, ...] repeating each row beam times."""
    return x.repeat_interleave(beam, dim=0)


class ASRDecoder:
    """Joint CTC/attention beam search over one port ``SpeechT5Model`` or
    an ensemble of them (a list: decoder log probs averaged in probability
    space, logsumexp - log M; CTC posteriors from the first model, as the
    reference EnsembleModel, sequence_generator.py:819-961, :928-934)."""

    def __init__(self, model, *, beam_size: int = 5, max_len: int = 256,
                 ctc_weight: float = 0.0, lm=None, lm_weight: float = 0.0,
                 length_penalty: float = 1.0, min_len: int = 1,
                 unk_penalty: float = 0.0, suppress_ids: tuple = (),
                 no_repeat_ngram_size: int = 0,
                 encode_method: str = "encode_speech",
                 cache_reorder: str = "ancestry", steps_per_iter: int = 4,
                 device="cuda"):
        """``encode_method``: the model method giving {encoder_out,
        valid_mask[, ctc_logits]} from the call's arguments, e.g.
        "encode_speech" (wav, wav_lengths).

        ``cache_reorder``: "ancestry" (default) keeps the self-attention
        caches unpermuted across beam reorders and shuffles an [N, L+1] map
        of ancestors that attention reads them through; "gather" reorders
        the caches each step (fairseq's reorder_incremental_state).

        ``steps_per_iter``: decode steps per host read of the loop
        condition; the tokens do not depend on it."""
        if lm is not None:
            raise NotImplementedError(
                "LM fusion is not ported yet (ROADMAP A.9: models/lm.py and "
                "the lm_weight term of the step)")
        self.device = resolve_device(device)
        models = model if isinstance(model, (list, tuple)) else [model]
        self.models = [m.to(self.device).eval() for m in models]
        self.cfg = self.models[0].cfg
        self.beam_size = beam_size
        self.max_len = max_len
        self.ctc_weight = ctc_weight
        self.length_penalty = length_penalty
        self.min_len = min_len
        self.unk_penalty = unk_penalty
        self.suppress_ids = tuple(suppress_ids)
        self.no_repeat_ngram_size = no_repeat_ngram_size
        self.encode_method = encode_method
        if cache_reorder not in ("ancestry", "gather"):
            raise ValueError(f"cache_reorder: {cache_reorder!r}")
        self.cache_reorder = cache_reorder
        if steps_per_iter < 1:
            raise ValueError(f"steps_per_iter: {steps_per_iter}")
        self.steps_per_iter = steps_per_iter
        self.ctc_beam = max(2, int(beam_size * CTC_SCORING_RATIO))
        # pad, blank and the asked-for ids never win
        self._suppressed = torch.zeros(self.cfg.vocab_size, dtype=torch.bool,
                                       device=self.device)
        self._suppressed[[self.cfg.pad_id, self.cfg.blank_id, *self.suppress_ids]] = True
        self.steps_run = 0      # decode steps computed, over every call

    # ------------------------------------------------------------------ steps

    def _suppress(self, lprobs):
        lprobs = lprobs.masked_fill(self._suppressed, NEG_INF)
        if self.unk_penalty:
            lprobs[:, self.cfg.unk_id] -= self.unk_penalty
        return lprobs

    def _step(self, consts, toks_t, step, state):
        """``consts``: the loop-invariant tensors (cross K/V, encoder mask,
        CTC posteriors and lengths), kept out of the beam state so the
        reorder never gathers them."""
        cfg = self.cfg
        rows = state["anc"] if self.cache_reorder == "ancestry" else None
        atts, caches = [], []
        for model, cache, cross in zip(self.models, state["cache"], consts["cross"]):
            logits, cache = model.text_decode_step(
                toks_t, {**cache, "cross": cross}, enc_valid=consts["enc_valid"],
                cache_rows=rows)
            atts.append(torch.log_softmax(logits.float(), dim=-1))
            caches.append({"index": cache["index"], "layers": cache["layers"]})
        if len(atts) == 1:
            att = atts[0]
        else:   # the mean of the probabilities, in log space
            att = torch.logsumexp(torch.stack(atts), dim=0) - np.log(len(atts))
        lprobs = att
        state = dict(state, cache=tuple(caches))

        if self.ctc_weight > 0:
            w = self.ctc_weight
            cs = state["ctc"]
            # candidates: the top attention scores, blank and eos removed
            sel = self._suppress(att)
            sel[:, cfg.eos_id] = NEG_INF
            _, order = torch.sort(sel, dim=1, descending=True, stable=True)
            cand_ids = order[:, : self.ctc_beam]
            psi, _ = ctc_prefix.score_candidates(
                cs, consts["ctc_lprobs"], consts["enc_lengths"], cand_ids,
                cfg.blank_id, state["ctc_empty"])
            delta = psi - cs.psi[:, None]
            # the candidates get (1-w) * att + w * delta; the other tokens
            # keep their raw attention score (reference
            # sequence_generator.py:385-387)
            combined = (1.0 - w) * torch.gather(att, 1, cand_ids) + w * delta
            lprobs = lprobs.scatter(1, cand_ids, combined)
            # eos: the CTC score of ending the prefix here
            eos_delta = ctc_prefix.eos_score(cs, consts["enc_lengths"]) - cs.psi
            lprobs[:, cfg.eos_id] = (1.0 - w) * att[:, cfg.eos_id] + w * eos_delta
        return self._suppress(lprobs), state

    def _select(self, consts, state, tok):
        if self.ctc_weight <= 0:
            return state
        _, cand = ctc_prefix.score_candidates(
            state["ctc"], consts["ctc_lprobs"], consts["enc_lengths"],
            tok[:, None], self.cfg.blank_id, state["ctc_empty"])
        rows = torch.arange(tok.shape[0], device=tok.device)
        return dict(state, ctc=ctc_prefix.select(cand, rows, torch.zeros_like(rows)),
                    ctc_empty=torch.zeros_like(state["ctc_empty"]))

    # ------------------------------------------------------------------ decode

    def _inputs(self, args):
        """numpy or torch arguments -> device tensors (float audio as f32,
        integer lengths as int32)."""
        out = []
        for a in args:
            t = torch.as_tensor(a)
            t = t.to(torch.float32) if t.is_floating_point() else t.to(torch.int32)
            out.append(t.to(self.device))
        return out

    @torch.inference_mode()
    def __call__(self, *enc_args) -> BeamResult:
        """Args go to ``encode_method`` (wav [B, T], wav_lengths [B] for
        "encode_speech").  Returns BeamResult (tokens [B, K, L+1], scores,
        lengths) on the device."""
        cfg = self.cfg
        enc_args = self._inputs(enc_args)
        B, K = enc_args[0].shape[0], self.beam_size
        N = B * K
        kw = {"with_ctc": True} if self.ctc_weight > 0 else {}
        encs, crosses, caches = [], [], []
        for model in self.models:
            enc = getattr(model, self.encode_method)(*enc_args, **kw)
            # cross K/V and the encoder mask stay untiled [B, ...]: the
            # grouped cross-attention reads them once per sample
            cache = model.init_text_cache(enc, N, self.max_len + 1)
            encs.append(enc)
            crosses.append(cache["cross"])
            caches.append({"index": cache["index"], "layers": cache["layers"]})
        enc = encs[0]   # CTC posteriors and masks from the first model
        consts = {"cross": tuple(crosses), "enc_valid": enc["valid_mask"]}
        state = {"cache": tuple(caches)}
        if self.ctc_weight > 0:
            ctc_lp = torch.log_softmax(enc["ctc_logits"].float(), dim=-1)
            # the posteriors stay untiled [B, T, V]: score_candidates reads
            # them grouped (the initial state needs per-row tensors once)
            consts["ctc_lprobs"] = ctc_lp
            consts["enc_lengths"] = _tile_rows(mask_lengths(enc["valid_mask"]), K)
            state["ctc"] = ctc_prefix.init_state(
                _tile_rows(ctc_lp, K), consts["enc_lengths"], cfg.blank_id,
                cfg.eos_id)
            state["ctc_empty"] = torch.ones(N, dtype=torch.bool, device=self.device)

        ancestry = self.cache_reorder == "ancestry"
        res, runs = beam_search(
            lambda toks_t, step, st: self._step(consts, toks_t, step, st), state,
            batch_size=B, beam_size=K, vocab_size=cfg.vocab_size,
            max_len=self.max_len, eos_id=cfg.eos_id,
            length_penalty=self.length_penalty, min_len=self.min_len,
            select_fn=lambda st, tok: self._select(consts, st, tok),
            no_repeat_ngram_size=self.no_repeat_ngram_size,
            gather_exempt_keys=("cache",) if ancestry else (),
            ancestry_key="anc" if ancestry else None,
            steps_per_iter=self.steps_per_iter, device=self.device)
        self.steps_run += runs
        return res


class CTCDecoder:
    """Greedy (viterbi) CTC decode over a port ``SpeechT5Model``."""

    def __init__(self, model, *, blank_id: int, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.blank_id = blank_id

    def _inputs(self, wav, lengths):
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        return wav, lengths

    @torch.inference_mode()
    def logits(self, wav, lengths):
        """f32 CTC logits [B, T, V] and int32 frame lengths [B] (device)."""
        enc = self.model.encode_speech(*self._inputs(wav, lengths), with_ctc=True)
        return enc["ctc_logits"], mask_lengths(enc["valid_mask"])

    @torch.inference_mode()
    def frame_ids(self, wav, lengths):
        """Per-frame argmax ids [B, T] int32 and frame lengths [B], as numpy:
        the argmax runs on the device, only the ids cross to the host."""
        logits, frame_lengths = self.logits(wav, lengths)
        ids = torch.argmax(logits, dim=-1).to(torch.int32)
        return ids.cpu().numpy(), frame_lengths.cpu().numpy()

    def __call__(self, wav, lengths) -> list:
        """Returns a list of B token-id lists (letters + word-sep tokens)."""
        ids, frame_lengths = self.frame_ids(wav, lengths)
        return greedy_collapse(ids, frame_lengths, self.blank_id)


def greedy_collapse(ids: np.ndarray, lengths: np.ndarray,
                    blank_id: int) -> list:
    """Collapse repeats + drop blanks over per-frame argmax ids [B, T]."""
    out = []
    for b in range(ids.shape[0]):
        seq = ids[b, : lengths[b]]
        if len(seq) == 0:
            out.append([])
            continue
        seq = seq[np.concatenate([[True], seq[1:] != seq[:-1]])]
        out.append(seq[seq != blank_id].tolist())
    return out


def greedy_ctc(ctc_logits, lengths, blank_id: int) -> list:
    """Greedy CTC decode (collapse repeats, drop blanks) of [B, T, V] logits —
    the reference's in-training WER decode (reference
    criterions/speech_to_text_loss.py:232-297)."""
    ids = torch.argmax(torch.as_tensor(ctc_logits), dim=-1)
    return greedy_collapse(ids.cpu().numpy(), np.asarray(torch.as_tensor(lengths).cpu()),
                           blank_id)
