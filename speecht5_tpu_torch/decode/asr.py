"""ASR decoding: the joint CTC/attention beam search (with neural-LM
fusion), CTC greedy and lexicon decoding, and the two-pass CTC N-best +
attention rescore.

Port of ``speecht5_tpu/decode/asr.py``:

- ``ASRDecoder`` (JAX :34-292): the encoder forward and CTC head
  (reference speecht5.py:1112-1140), KV-cached decoder steps (reference
  speecht5.py:1151-1164) and the per-step score combination of reference
  sequence_generator.py:370-432: the top ``beam * 1.5`` candidates by
  attention score get (1 - w) * attention + w * CTC-prefix delta, the
  others keep their attention score; then, with a fusion LM
  (``models/lm.TransformerLM``), + lm_weight * its log-softmax (JAX
  :178-187); pad and blank suppressed, unk penalized.  Beam, CTC prefix
  state and caches stay on the device for the whole batch; the host runs
  the loop (``decode/beam_search.py``).
- ``CTCDecoder`` (JAX :295-380): one encoder + CTC-head forward; greedy:
  the argmax on the device and only the ``[B, T]`` int32 frame ids and the
  frame lengths copied to the host for the collapse (JAX asr.py:332-337);
  with a ``decode/lexicon.LexiconDecoder``: the log-softmax on the device,
  the ``[B, T, V]`` f32 posteriors to the host, the native lexicon + word
  LM beam per utterance.
- ``RescoreDecoder`` (JAX :382-518): pass 1, one encoder + CTC forward on
  the device and the N-best on the host (the native open-vocabulary prefix
  beam, ``decode/nbest.py``, or the lexicon decoder's N-best); pass 2, one
  teacher-forced ``decode_text`` over all B * N hypotheses, padded to a
  multiple of ``len_step`` tokens; the pick maximises (1 - w) * attention
  + w * CTC.
"""

from __future__ import annotations

import math
import time

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
        condition; the tokens do not depend on it.

        ``lm``: a ``models/lm.TransformerLM`` over the model's vocabulary,
        fused with ``lm_weight`` (ignored at weight 0, as in JAX); its
        cache follows the ancestry map like the decoder's, or is gathered
        with the beam under "gather"."""
        self.device = resolve_device(device)
        models = model if isinstance(model, (list, tuple)) else [model]
        self.models = [m.to(self.device).eval() for m in models]
        self.cfg = self.models[0].cfg
        self.lm = None
        self.lm_weight = lm_weight
        if lm is not None and lm_weight != 0.0:
            if lm.cfg.vocab_size != self.cfg.vocab_size:
                raise ValueError(f"the fusion LM's vocabulary ({lm.cfg.vocab_size}) is "
                                 f"not the model's ({self.cfg.vocab_size})")
            if lm.cfg.max_positions < max_len:
                # JAX reads the positions past the table clamped to its last row
                raise ValueError(f"the fusion LM has {lm.cfg.max_positions} positions, "
                                 f"fewer than max_len {max_len}")
            self.lm = lm.to(self.device).eval()
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

        if self.lm is not None:   # shallow fusion, before the suppression
            lm_logits, lm_cache = self.lm.decode_step(toks_t, state["lm_cache"],
                                                      cache_rows=rows)
            lprobs = lprobs + self.lm_weight * torch.log_softmax(lm_logits.float(), dim=-1)
            state = dict(state, lm_cache=lm_cache)
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
        if self.lm is not None:
            state["lm_cache"] = self.lm.init_cache(N, self.max_len + 1)

        ancestry = self.cache_reorder == "ancestry"
        res, runs = beam_search(
            lambda toks_t, step, st: self._step(consts, toks_t, step, st), state,
            batch_size=B, beam_size=K, vocab_size=cfg.vocab_size,
            max_len=self.max_len, eos_id=cfg.eos_id,
            length_penalty=self.length_penalty, min_len=self.min_len,
            select_fn=lambda st, tok: self._select(consts, st, tok),
            no_repeat_ngram_size=self.no_repeat_ngram_size,
            gather_exempt_keys=("cache", "lm_cache") if ancestry else (),
            ancestry_key="anc" if ancestry else None,
            steps_per_iter=self.steps_per_iter, device=self.device)
        self.steps_run += runs
        return res


class CTCDecoder:
    """CTC decoding over a port ``SpeechT5Model``: greedy (viterbi)
    collapse, or with ``lexicon`` (a ``decode/lexicon.LexiconDecoder``) the
    native lexicon + word-LM beam over the posteriors (the reference
    SpeechLM's flashlight / KenLM decode, SpeechLM/speechlm/infer.py)."""

    def __init__(self, model, *, blank_id: int, lexicon=None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.blank_id = blank_id
        self.lexicon = lexicon

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

    @torch.inference_mode()
    def posteriors(self, wav, lengths):
        """Natural-log CTC posteriors [B, T, V] f32 and frame lengths [B],
        as numpy: the log-softmax runs on the device."""
        logits, frame_lengths = self.logits(wav, lengths)
        lp = torch.log_softmax(logits.float(), dim=-1)
        return lp.cpu().numpy(), frame_lengths.cpu().numpy()

    def __call__(self, wav, lengths) -> list:
        """Returns a list of B token-id lists (letters + word-sep tokens)."""
        if self.lexicon is None:
            ids, frame_lengths = self.frame_ids(wav, lengths)
            return greedy_collapse(ids, frame_lengths, self.blank_id)
        lp, frame_lengths = self.posteriors(wav, lengths)
        return [self.lexicon.decode(lp[b, : int(frame_lengths[b])])[0]
                for b in range(lp.shape[0])]


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


class RescoreDecoder:
    """Two-pass decode: the CTC N-best prefix beam, then one teacher-forced
    decoder forward that scores every hypothesis (the joint beam's two
    scores in two batched passes, no AR loop; JAX :382-518).

    ``lexicon``: an optional ``decode/lexicon.LexiconDecoder``; pass 1 then
    gives lexicon + word-LM constrained N-best lists.  ``max_len`` caps the
    scored hypothesis length in tokens; ``blank_skip``: frames whose blank
    probability exceeds it take only the stay transitions in pass 1 (1.0 or
    0 disables).  ``last_ms`` holds the host-clock times of the last call:
    "encode" (the encoder and CTC forward, ending with the posteriors on
    the host), "nbest" (pass 1, host) and "rescore" (pass 2, ending with
    its scores on the host)."""

    def __init__(self, model, *, blank_id: int, eos_id: int, pad_id: int,
                 nbest: int = 8, beam: int = 16, topk: int = 0,
                 ctc_weight: float = 0.3, max_len=None, blank_skip: float = 0.95,
                 lexicon=None, len_step: int = 32, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.blank_id = blank_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.nbest = nbest
        self.beam = max(beam, nbest)
        self.topk = topk
        self.ctc_weight = ctc_weight
        self.max_len = max_len
        self.blank_thresh = math.log(blank_skip) if blank_skip > 0 else 0.0
        self.lexicon = lexicon
        self.len_step = len_step
        self.last_ms = {}

    @torch.inference_mode()
    def encode(self, wav, lengths):
        """Pass 1's device part: the encoder and CTC forward -> (the encoder
        output dict on the device, natural-log posteriors [B, T, V] f32 and
        frame lengths [B] as numpy)."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        enc = self.model.encode_speech(wav, lengths, with_ctc=True)
        lp = torch.log_softmax(enc["ctc_logits"].float(), dim=-1)
        return enc, lp.cpu().numpy(), mask_lengths(enc["valid_mask"]).cpu().numpy()

    @torch.inference_mode()
    def score(self, enc, prev, tgt, tmask):
        """Pass 2: sum_i log P(tgt_i | prev_<=i, enc) over the positions of
        ``tmask``, for [B, N, L] hypotheses against ``enc`` of B rows ->
        f32 [B, N] (device)."""
        B, N, L = prev.shape
        rep = {"encoder_out": enc["encoder_out"].repeat_interleave(N, 0),
               "valid_mask": enc["valid_mask"].repeat_interleave(N, 0)}
        logits = self.model.decode_text(rep, prev.reshape(B * N, L))
        lsm = torch.log_softmax(logits.float(), dim=-1)
        tok_lp = torch.gather(lsm, -1, tgt.reshape(B * N, L, 1))[..., 0]
        return (tok_lp * tmask.reshape(B * N, L)).sum(-1).reshape(B, N)

    def nbest_lists(self, lp, lengths) -> list:
        """Pass 1 on the host: per utterance up to ``nbest`` (tokens, CTC
        log prob) pairs, best first."""
        from .nbest import ctc_nbest_batch

        if self.lexicon is not None:
            return [self.lexicon.decode_nbest(lp[b, : int(lengths[b])], nbest=self.nbest)
                    for b in range(lp.shape[0])]
        return ctc_nbest_batch(lp, lengths, blank=self.blank_id, beam=self.beam,
                               nbest=self.nbest, topk=self.topk,
                               blank_thresh=self.blank_thresh)

    def candidates(self, batch_cands) -> tuple:
        """The N-best lists -> (hypotheses [B][nbest], CTC scores [B][nbest])
        under JAX's rules: an empty list scores the empty hypothesis at 0;
        over-length hypotheses are dropped, not truncated, unless every one
        is, when the 1-best is truncated (its scores then disagree, but it
        is the only candidate); a short list is padded with copies of its
        best, which tie and lose the argmax to it."""
        hyp_rows, ctc_rows = [], []
        for cands in batch_cands:
            cands = list(cands) or [([], 0.0)]
            if self.max_len is not None:
                kept = [(t, s) for t, s in cands if len(t) <= self.max_len]
                cands = kept or [(cands[0][0][: self.max_len], cands[0][1])]
            while len(cands) < self.nbest:
                cands.append(cands[0])
            hyp_rows.append([c[0] for c in cands])
            ctc_rows.append([c[1] for c in cands])
        return hyp_rows, ctc_rows

    def teacher_forcing(self, hyp_rows) -> tuple:
        """[B][N] hypotheses -> (prev, tgt, tmask) [B, N, L] numpy: EOS then
        the tokens, the tokens then EOS, 1 over the tokens and EOS; L the
        longest + 1 rounded up to ``len_step``."""
        B = len(hyp_rows)
        maxtgt = max(len(h) for row in hyp_rows for h in row) + 1
        L = -(-maxtgt // self.len_step) * self.len_step
        prev = np.full((B, self.nbest, L), self.pad_id, np.int64)
        tgt = np.full((B, self.nbest, L), self.pad_id, np.int64)
        tmask = np.zeros((B, self.nbest, L), np.float32)
        prev[:, :, 0] = self.eos_id
        for b, row in enumerate(hyp_rows):
            for n, toks in enumerate(row):
                k = len(toks)
                prev[b, n, 1 : k + 1] = toks
                tgt[b, n, :k] = toks
                tgt[b, n, k] = self.eos_id
                tmask[b, n, : k + 1] = 1.0
        return prev, tgt, tmask

    def __call__(self, wav, lengths) -> list:
        """Returns a list of B token-id lists."""
        t0 = time.perf_counter()
        enc, lp, frame_lengths = self.encode(wav, lengths)
        t1 = time.perf_counter()
        hyp_rows, ctc_rows = self.candidates(self.nbest_lists(lp, frame_lengths))
        t2 = time.perf_counter()
        prev, tgt, tmask = (torch.from_numpy(a).to(self.device)
                            for a in self.teacher_forcing(hyp_rows))
        att = self.score(enc, prev, tgt, tmask).cpu().numpy()
        t3 = time.perf_counter()
        self.last_ms = {"encode": (t1 - t0) * 1e3, "nbest": (t2 - t1) * 1e3,
                        "rescore": (t3 - t2) * 1e3}
        total = (1.0 - self.ctc_weight) * att + self.ctc_weight * np.asarray(ctc_rows)
        best = total.argmax(axis=1)
        return [hyp_rows[b][int(best[b])] for b in range(len(hyp_rows))]
