"""HTTP serving of ASR and TTS on the PyTorch port (port of
``speecht5_tpu/cli/serve.py``):

    POST /asr   body: WAV bytes (16 kHz mono)      -> {"text": ...}
    POST /tts   body: {"text": "..."}               -> WAV bytes (16 kHz mono)
    GET  /healthz                                   -> {"ok": true, ...}

``--task s2t`` serves /asr, ``t2s`` /tts, ``both`` the two from one model.

Design notes (one card):
- requests are padded to a fixed bucket grid (4/8/16 s by default), each
  bucket warmed once at startup;
- audio longer than the largest bucket is decoded in overlapping chunks and
  the transcripts joined (never silently truncated);
- concurrent /asr requests are micro-batched when --max-batch > 1: a
  collector thread gathers same-bucket requests inside --batch-window-ms
  and decodes them as one batch;
- device access is serialized with a lock — one batch in flight.

Decoders: ``--decoder beam`` (the default), the joint CTC/attention beam
search (``decode/asr.py:ASRDecoder`` with ``--beam``, ``--max-len`` and
``--ctc-weight``; the text is the best hypothesis); ``ctc_greedy``, the
encoder-only CTC viterbi; and ``ctc_rescore`` (``decode/asr.py:
RescoreDecoder``), the throughput arm: one encoder + CTC forward, the
N-best on the host (the native open-vocabulary prefix beam of
``--ctc-beam-size`` with ``--ctc-topk``, or with ``--lexicon`` the native
lexicon decoder, word LM ``--lm-path`` at ``--lm-weight`` and
``--word-score``), then one teacher-forced decoder pass over the
``--rescore-nbest`` hypotheses, picked by (1 - w) * attention + w * CTC at
``--ctc-weight``; hypotheses over ``--max-len`` tokens are dropped.

TTS (``decode/tts.py:TTSDecoder``): the text's letters (the dictionary's
symbols, '|' between words) padded to ``--tts-bucket-tokens``, decoded to
at most ``--max-frames`` mel frames with a zero x-vector, then to a
waveform by the HiFi-GAN of ``--vocoder-ckpt`` (a model-only port
checkpoint of ``models/hifigan.HiFiGANGenerator``, e.g. a released vocoder
put through ``utils/convert.convert_hifigan_state_dict``) or, with
``--griffin-lim``, by Griffin-Lim on the card (``ops/mel.mel_to_audio``).
Concurrent /tts requests are coalesced like /asr's under --max-batch; the
TTS path is warmed at batch 1 and at --max-batch.

The model is restored from the newest ``checkpoint_<step>.pt`` in
``--ckpt``: one the port's ``cli/train.py`` wrote, or a model-only one from
``cli/convert.py`` (a converted release); a caller may instead hand in a
model it made (``Service(args, model=..., cfg=..., vocoder=...)``), as the
tests and ``chip_smoke.py`` do.  Runs on the card unless ``--device cpu``.

Usage:
    python -m speecht5_tpu_torch.cli.serve --task s2t \\
        --arch speecht5_base_asr --ckpt ckpt/ --dict dict.ltr.txt --port 8080

    python -m speecht5_tpu_torch.cli.serve --task t2s --arch speecht5_base \\
        --ckpt ckpt/ --dict dict.txt --vocoder-ckpt hifigan/ \\
        --override decoder.use_pallas_attn=True
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
import types
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..data.dictionary import letters_to_text, load_cli_dictionary
from ..utils.device import resolve_device

ASR_BUCKETS_S = (4, 8, 16)
SR = 16000
DECODERS = ("beam", "ctc_greedy", "ctc_rescore")
LM_PATH_NEEDS_LEXICON = ("--lm-path requires --lexicon (the word n-gram LM scores "
                         "lexicon words; without a lexicon it would be silently "
                         "ignored)")


class RequestTooLarge(Exception):
    """Mapped to HTTP 413 — the request exceeds a configured hard cap."""


class _CTCAdapter:
    """Make a decoder that returns token rows (CTCDecoder, RescoreDecoder)
    quack like the beam decoder's result (tokens [B, beam, L] with BOS/EOS
    framing) so the serving paths stay decoder-agnostic."""

    def __init__(self, dec):
        self.dec = dec

    def __call__(self, wav, lengths):
        rows = self.dec(wav, lengths)
        L = max(len(r) for r in rows) + 2 if rows else 2
        toks = np.zeros((len(rows), 1, max(L, 2)), np.int32)
        lens = np.zeros((len(rows), 1), np.int32)
        for b, r in enumerate(rows):
            toks[b, 0, 1 : 1 + len(r)] = r
            lens[b, 0] = len(r) + 2          # BOS + ids + EOS convention
        return types.SimpleNamespace(tokens=toks, lengths=lens)


def _parse_wav(body: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(body)) as w:
        if w.getnchannels() != 1 or w.getframerate() != SR or w.getsampwidth() != 2:
            raise ValueError(f"expected 16-bit mono PCM at {SR} Hz")
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return pcm.astype(np.float32) / 32768.0


def _wav_bytes(wav: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        pcm = np.clip(wav, -1.0, 1.0)
        w.writeframes((pcm * 32767.0).astype(np.int16).tobytes())
    return buf.getvalue()


def restore_model(args, device):
    """``getattr(config, args.arch)`` at the dictionary's vocabulary and
    ``args.dtype`` with ``args.override``, and the model state of the
    newest checkpoint in ``args.ckpt``, a train or a model-only one (JAX
    cli/serve.py:110-121).  Raises SystemExit when there is none.  Returns
    (cfg, model in eval mode on ``device``)."""
    from .. import config as C
    from ..models.speecht5 import init_model
    from ..utils.checkpoint import restore_model as restore_state

    _, cfg_kw = load_cli_dictionary(args.dict_path, None)
    cfg_kw["dtype"] = args.dtype
    cfg = C.apply_overrides(getattr(C, args.arch)(**cfg_kw), args.override)
    state, step = restore_state(args.ckpt)
    if state is None:
        raise SystemExit(f"no checkpoint in {args.ckpt}")
    model = init_model(cfg, device=device)
    model.load_state_dict(state)
    print(f"loaded checkpoint step {step}", flush=True)
    return cfg, model


def restore_vocoder(path, n_mels: int, device):
    """The HiFi-GAN generator (the released config at ``n_mels``) with the
    model state of the newest checkpoint in ``path``."""
    from ..models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from ..utils.checkpoint import restore_model as restore_state

    state, _ = restore_state(path)
    if state is None:
        raise SystemExit(f"no vocoder checkpoint in {path}")
    voc = HiFiGANGenerator(HiFiGANConfig(in_dim=n_mels))
    voc.load_state_dict(state)
    return voc.to(device).eval()


class Service:
    """Owns the decoder; one device batch in flight at a time."""

    def __init__(self, args, *, model=None, cfg=None, vocoder=None, device="cuda"):
        from ..decode.asr import ASRDecoder, CTCDecoder, RescoreDecoder
        from ..decode.tts import TTSDecoder

        self.device = resolve_device(device)
        self.lock = threading.Lock()
        self.args = args
        if args.decoder == "ctc_rescore" and args.lm_path and not args.lexicon:
            raise ValueError(LM_PATH_NEEDS_LEXICON)
        if model is None:
            cfg, model = restore_model(args, self.device)
        elif cfg is None:
            raise ValueError("a model handed in needs its cfg")
        dictionary, cfg_kw = load_cli_dictionary(args.dict_path, None)
        for key, want in cfg_kw.items():
            if getattr(cfg, key) != want:
                raise ValueError(f"cfg.{key}={getattr(cfg, key)} but the "
                                 f"dictionary gives {want}")
        if cfg.dtype != args.dtype:
            raise ValueError(f"model built for {cfg.dtype}, --dtype {args.dtype}")
        self.dictionary = dictionary
        self.cfg = cfg
        self.model = model

        self.max_batch = max(1, args.max_batch)
        self.batch_window_s = args.batch_window_ms / 1000.0
        self.asr_calls = 0      # device batches launched
        self.asr_requests = 0   # chunks decoded (>= calls under batching)
        self.tts_calls = 0
        self.tts_requests = 0
        self._queue = []
        self._queue_cv = threading.Condition()
        self._tts_queue = []
        self._tts_cv = threading.Condition()
        self.asr = self.tts = None
        if args.task in ("s2t", "both"):
            if args.decoder == "beam":
                self.asr = ASRDecoder(model, beam_size=args.beam, max_len=args.max_len,
                                      ctc_weight=args.ctc_weight, device=self.device)
            elif args.decoder == "ctc_rescore":
                self.asr = _CTCAdapter(RescoreDecoder(
                    model, blank_id=cfg.blank_id, eos_id=cfg.eos_id, pad_id=cfg.pad_id,
                    nbest=args.rescore_nbest, beam=args.ctc_beam_size,
                    topk=args.ctc_topk, ctc_weight=args.ctc_weight,
                    max_len=args.max_len, lexicon=self._lexicon(), device=self.device))
            else:
                self.asr = _CTCAdapter(CTCDecoder(model, blank_id=cfg.blank_id,
                                                  device=self.device))
            for secs in self.buckets():
                for bs in sorted({1, self.max_batch}):
                    wav = np.zeros((bs, secs * SR), np.float32)
                    steps = getattr(self.asr, "steps_run", None)   # the beam's
                    self.asr(wav, np.full((bs,), secs * SR, np.int32))
                    note = ("" if steps is None else
                            f" ({self.asr.steps_run - steps} decode steps)")
                    print(f"warmed ASR bucket {secs}s batch {bs}{note}", flush=True)
            if self.max_batch > 1:
                threading.Thread(target=self._batcher_loop, daemon=True).start()
        if args.task in ("t2s", "both"):
            if vocoder is None and args.vocoder_ckpt:
                vocoder = restore_vocoder(args.vocoder_ckpt, cfg.n_mels, self.device)
            self.tts = TTSDecoder(model, max_frames=args.max_frames, vocoder=vocoder,
                                  device=self.device)
            for bs in sorted({1, self.max_batch}):
                toks = np.full((bs, args.tts_bucket_tokens), cfg.eos_id, np.int64)
                steps = self.tts.steps_run
                self.tts.text_to_speech(toks, self._spkembs(bs))
                print(f"warmed TTS batch {bs} ({self.tts.steps_run - steps} decode "
                      "steps)", flush=True)
            if self.max_batch > 1:
                threading.Thread(target=self._tts_batcher_loop, daemon=True).start()

    def buckets(self):
        return [int(s) for s in self.args.asr_buckets.split(",")]

    def _lexicon(self):
        """ctc_rescore's pass-1 lexicon decoder (``--lexicon``, word LM
        ``--lm-path``), or None for the open-vocabulary N-best."""
        if not self.args.lexicon:
            return None
        from ..decode.lexicon import letter_lexicon_decoder

        a = self.args
        return letter_lexicon_decoder(a.lexicon, self.dictionary, blank=self.cfg.blank_id,
                                      arpa_path=a.lm_path, lm_weight=a.lm_weight,
                                      word_score=a.word_score, beam=a.ctc_beam_size)

    # ------------------------------------------------------------------ ops
    def _chunk(self, wav: np.ndarray):
        """Split audio into the bucket grid: one chunk when it fits, else
        overlapping windows of the largest bucket (hop = bucket - overlap)
        so nothing is dropped."""
        n = len(wav)
        top = self.buckets()[-1] * SR
        if self.args.max_audio_s and n > self.args.max_audio_s * SR:
            raise RequestTooLarge(
                f"audio is {n / SR:.1f}s; --max-audio-s {self.args.max_audio_s}")
        if n <= top:
            return [wav]
        overlap = int(self.args.chunk_overlap_s * SR)
        hop = max(top - overlap, 1)
        chunks = []
        for start in range(0, n, hop):
            chunks.append(wav[start : start + top])
            if start + top >= n:
                break
        return chunks

    def _decode_batch(self, wavs, lengths, n_real=None):
        """One device batch over a padded same-bucket batch; returns the
        detokenized texts for the first ``n_real`` rows."""
        n_real = len(wavs) if n_real is None else n_real
        with self.lock:
            res = self.asr(wavs, np.asarray(lengths, np.int32))
            # the best hypothesis, framed BOS ... EOS (JAX cli/serve.py:253)
            toks, lens = (np.asarray(torch.as_tensor(t)[:, 0].cpu())
                          for t in (res.tokens, res.lengths))
            self.asr_calls += 1
            self.asr_requests += n_real
        out = []
        for b in range(n_real):
            hyp_ids = toks[b, 1 : max(int(lens[b]) - 1, 1)]
            out.append(letters_to_text(self.dictionary.string(hyp_ids)))
        return out

    def _bucket_for(self, n: int) -> int:
        secs = next((s for s in self.buckets() if s * SR >= n),
                    self.buckets()[-1])
        return secs * SR

    def _decode_one(self, wav: np.ndarray) -> str:
        T = self._bucket_for(len(wav))
        padded = np.zeros((1, T), np.float32)
        padded[0, : len(wav)] = wav[:T]
        return self._decode_batch(padded, [min(len(wav), T)])[0]

    # --------------------------------------------------- micro-batching
    def _enqueue(self, wav: np.ndarray) -> dict:
        slot = {"event": threading.Event(), "wav": wav,
                "bucket": self._bucket_for(len(wav)), "text": None}
        with self._queue_cv:
            self._queue.append(slot)
            self._queue_cv.notify()
        return slot

    @staticmethod
    def _wait(slot: dict) -> str:
        slot["event"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["text"]

    def _batcher_loop(self):
        while True:
            with self._queue_cv:
                while not self._queue:
                    self._queue_cv.wait()
                first = self._queue[0]
            deadline = time.monotonic() + self.batch_window_s
            while time.monotonic() < deadline:
                with self._queue_cv:
                    same = [s for s in self._queue
                            if s["bucket"] == first["bucket"]]
                    if len(same) >= self.max_batch:
                        break
                time.sleep(self.batch_window_s / 10)
            with self._queue_cv:
                group = [s for s in self._queue
                         if s["bucket"] == first["bucket"]][: self.max_batch]
                for s in group:
                    self._queue.remove(s)
            T = first["bucket"]
            rows = 1 if len(group) == 1 else self.max_batch
            wavs = np.zeros((rows, T), np.float32)
            lengths = np.full((rows,), T, np.int64)
            for b, s in enumerate(group):
                w = s["wav"][:T]
                wavs[b, : len(w)] = w
                lengths[b] = len(w)
            try:
                texts = self._decode_batch(wavs, lengths, n_real=len(group))
                for b, s in enumerate(group):
                    s["text"] = texts[b]
            except Exception as e:  # noqa: BLE001 — deliver to the waiters
                for s in group:
                    s["error"] = e
            finally:
                for s in group:
                    s["event"].set()

    @staticmethod
    def _join_transcripts(texts, max_seam_words: int = 8) -> str:
        """Join chunk transcripts, deduplicating the window seam: the
        longest word suffix of the running transcript that exactly matches
        the next chunk's prefix is dropped from the incoming chunk."""
        words: list = []
        for t in texts:
            w = t.split()
            if not w:
                continue
            k_max = min(max_seam_words, len(words), len(w))
            drop = 0
            for k in range(k_max, 0, -1):
                if words[-k:] == w[:k]:
                    drop = k
                    break
            words.extend(w[drop:])
        return " ".join(words)

    def transcribe(self, wav: np.ndarray) -> str:
        chunks = self._chunk(wav)
        if self.max_batch <= 1:
            texts = [self._decode_one(c) for c in chunks]
        else:
            slots = [self._enqueue(c) for c in chunks]
            texts = [self._wait(s) for s in slots]
        return self._join_transcripts(texts)

    # ---------------------------------------------------------------- TTS
    def _spkembs(self, rows: int):
        """Zero x-vectors, as the JAX service sends (no speaker input)."""
        dim = self.cfg.spk_embed_dim
        return None if dim is None else np.zeros((rows, dim), np.float32)

    def _synth_batch(self, toks: np.ndarray, n_real: int) -> list:
        """One TTS decode over ``toks`` [R, L]; the first ``n_real``
        waveforms (padding rows are decoded and never read)."""
        if self.tts.vocoder is None and not self.args.griffin_lim:
            raise RuntimeError(
                "no vocoder loaded — start with --vocoder-ckpt "
                "(a converted HiFi-GAN checkpoint) or --griffin-lim")
        from ..ops.mel import mel_to_audio

        with self.lock:
            out = self.tts.text_to_speech(toks, self._spkembs(toks.shape[0]))
            if out.wav is not None:
                wavs = [out.wav[b, : int(out.wav_lengths[b])] for b in range(n_real)]
            else:   # Griffin-Lim on the card
                wavs = [mel_to_audio(out.mel[b, : int(out.lengths[b])],
                                     n_mels=self.cfg.n_mels) for b in range(n_real)]
            wavs = [w.float().cpu().numpy() for w in wavs]
            self.tts_calls += 1
            self.tts_requests += n_real
        return wavs

    def _tts_batcher_loop(self):
        """Coalesce concurrent /tts requests into one batched decode."""
        while True:
            with self._tts_cv:
                while not self._tts_queue:
                    self._tts_cv.wait()
            deadline = time.monotonic() + self.batch_window_s
            while time.monotonic() < deadline:
                with self._tts_cv:
                    if len(self._tts_queue) >= self.max_batch:
                        break
                time.sleep(self.batch_window_s / 10)
            with self._tts_cv:
                group = self._tts_queue[: self.max_batch]
                del self._tts_queue[: len(group)]
            rows = 1 if len(group) == 1 else self.max_batch
            toks = np.full((rows, self.args.tts_bucket_tokens), self.cfg.pad_id, np.int64)
            for b, s in enumerate(group):
                toks[b, : len(s["ids"])] = s["ids"]
            try:
                wavs = self._synth_batch(toks, n_real=len(group))
                for b, s in enumerate(group):
                    s["wav"] = wavs[b]
            except Exception as e:  # noqa: BLE001 — deliver to the waiters
                for s in group:
                    s["error"] = e
            finally:
                for s in group:
                    s["event"].set()

    def synthesize(self, text: str) -> np.ndarray:
        """Text -> 16 kHz waveform (JAX cli/serve.py:425-450): the letters of
        the upper-cased text, '|' for a space, then EOS."""
        ids = self.dictionary.encode_line(" ".join(list(text.upper().replace(" ", "|"))))
        L = self.args.tts_bucket_tokens
        if len(ids) > L:
            raise RequestTooLarge(f"text tokenizes to {len(ids)} ids; "
                                  f"--tts-bucket-tokens {L}")
        if self.max_batch <= 1:
            toks = np.full((1, L), self.cfg.pad_id, np.int64)
            toks[0, : len(ids)] = ids
            return self._synth_batch(toks, n_real=1)[0]
        slot = {"event": threading.Event(), "ids": ids, "wav": None}
        with self._tts_cv:
            self._tts_queue.append(slot)
            self._tts_cv.notify()
        slot["event"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["wav"]


def make_handler(svc: Service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "asr": svc.asr is not None,
                    "tts": svc.tts is not None,
                    "asr_buckets_s": svc.buckets(),
                    "decoder": svc.args.decoder,
                    "max_batch": svc.max_batch,
                    "asr_calls": svc.asr_calls,
                    "asr_requests": svc.asr_requests,
                    "tts_calls": svc.tts_calls,
                    "tts_requests": svc.tts_requests,
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            try:
                if self.path == "/asr":
                    if svc.asr is None:
                        return self._json(400, {"error": "asr not enabled"})
                    wav = _parse_wav(body)
                    return self._json(200, {"text": svc.transcribe(wav)})
                if self.path == "/tts":
                    if svc.tts is None:
                        return self._json(400, {"error": "tts not enabled"})
                    data = _wav_bytes(svc.synthesize(json.loads(body.decode())["text"]))
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                self._json(404, {"error": "not found"})
            except RequestTooLarge as e:
                self._json(413, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — surface to the client
                self._json(500, {"error": repr(e)})

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default="s2t", choices=("s2t", "t2s", "both"))
    p.add_argument("--arch", default="speecht5_base_asr")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dict", dest="dict_path", required=True)
    p.add_argument("--vocoder-ckpt", default=None,
                   help="/tts: a port checkpoint dir of HiFi-GAN weights")
    p.add_argument("--griffin-lim", action="store_true",
                   help="/tts without a vocoder checkpoint: invert the mel "
                        "with Griffin-Lim (ops/mel.mel_to_audio)")
    p.add_argument("--max-frames", type=int, default=1024,
                   help="/tts: most mel frames a request may decode")
    p.add_argument("--tts-bucket-tokens", type=int, default=128,
                   help="/tts: texts are padded to this many tokens")
    p.add_argument("--override", action="append", default=[],
                   help="config field override, dotted path = literal, repeatable "
                        "(e.g. decoder.use_pallas_attn=True)")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--decoder", default="beam", choices=DECODERS,
                   help="/asr algorithm: joint CTC/attention beam search, "
                        "encoder-only CTC viterbi, or two-pass CTC N-best + "
                        "attention rescore")
    p.add_argument("--lexicon", default=None,
                   help="ctc_rescore: constrain pass-1 hypotheses to this "
                        "lexicon ('word<TAB>tok1 tok2 ...' lines)")
    p.add_argument("--lm-path", default=None,
                   help="ctc_rescore + --lexicon: word n-gram LM (ARPA, "
                        ".arpa.gz or a binary from decode.lexicon.build_binary_lm)")
    p.add_argument("--lm-weight", type=float, default=0.0)
    p.add_argument("--word-score", type=float, default=0.0)
    p.add_argument("--rescore-nbest", type=int, default=8,
                   help="ctc_rescore: hypotheses per utterance kept for the "
                        "attention rescoring pass")
    p.add_argument("--ctc-topk", type=int, default=0,
                   help="ctc_rescore: per-frame candidate pruning of the "
                        "N-best prefix beam (0 = all)")
    p.add_argument("--ctc-beam-size", type=int, default=50,
                   help="ctc_rescore pass-1 beam width (open-vocabulary or "
                        "lexicon-constrained)")
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--max-len", type=int, default=200,
                   help="beam, ctc_rescore: most tokens a hypothesis may have")
    p.add_argument("--ctc-weight", type=float, default=0.3,
                   help="beam, ctc_rescore: weight of the CTC score")
    p.add_argument("--asr-buckets", default=",".join(
        str(s) for s in ASR_BUCKETS_S))
    p.add_argument("--max-batch", type=int, default=1,
                   help="micro-batch up to N concurrent same-bucket /asr "
                        "requests into one device batch")
    p.add_argument("--batch-window-ms", type=float, default=20.0,
                   help="how long the collector waits for co-arriving "
                        "requests before launching a partial batch")
    p.add_argument("--chunk-overlap-s", type=float, default=0.5,
                   help="overlap between decode windows when audio exceeds "
                        "the largest bucket (chunked, never truncated)")
    p.add_argument("--max-audio-s", type=float, default=120.0,
                   help="hard cap on /asr audio length -> HTTP 413 "
                        "(0 disables)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.lm_path and not args.lexicon:
        p.error(LM_PATH_NEEDS_LEXICON)
    svc = Service(args, device=args.device)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(svc))
    print(json.dumps({"serving": True, "host": args.host,
                      "port": server.server_address[1]}), flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
