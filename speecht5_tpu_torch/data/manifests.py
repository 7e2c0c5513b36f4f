"""Manifest-TSV datasets and batching of the four fine-tune tasks and of
pretraining (the port's copy of ``speecht5_tpu/data/manifests.py``
:33-684, which imports JAX through ``ops.mel`` and so cannot be imported
here).

- audio manifests: first line = root dir, then "relpath\\tnframes" rows
  (reference data/speech_to_text_dataset.py:74-140); label files are
  parallel text files, one utterance a line; t2s x-vectors are
  ``<spkemb_dir>/<utterance basename>.npy``; s2c rows add a speaker label,
  s2s rows are "src\\tn\\ttgt\\tn\\tspkemb.npy";
- TTS / VC mel targets either per utterance on the host
  (``log_mel_numpy``) or, in device mode, as the reflect-padded waveform
  that the train step turns into mels on the card
  (``train/trainer.device_mel_batch``), the SE source too;
- batching by token count with length-sorted ordering (fairseq
  batch_by_size semantics);
- batches are padded to bucketed lengths, as in the JAX package, so the
  card sees few distinct shapes;
- pretraining: ``TextPretrainDataset`` (token blocks of a raw or
  fairseq-binarized text corpus, BART noising at collation) and
  ``SpeechPretrainDataset`` (waveforms with 50 Hz km labels and the fbank
  decoder target).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.mel import log_mel_numpy
from . import binarized
from .audio import layer_norm_wav, read_audio
from .dictionary import Dictionary


def load_audio_manifest(path: str) -> Tuple[str, List[str], np.ndarray]:
    with open(path, encoding="utf-8") as f:
        root = f.readline().strip()
        names, sizes = [], []
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            names.append(parts[0])
            sizes.append(int(parts[1]))
    return root, names, np.asarray(sizes, np.int64)


def read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [l.rstrip("\n") for l in f]


def bucket_length(n: int, grid: Sequence[int]) -> int:
    """Smallest bucket >= n (last bucket if none)."""
    for g in grid:
        if n <= g:
            return g
    return grid[-1]


def batch_by_size(sizes: np.ndarray, max_tokens: int,
                  max_sentences: Optional[int] = None,
                  shuffle_seed: Optional[int] = None) -> List[np.ndarray]:
    """fairseq-style: order by length, fill batches until cost
    (= batch_max_len * batch_count) exceeds max_tokens."""
    order = np.argsort(sizes, kind="stable")
    batches, cur = [], []
    cur_max = 0
    for idx in order:
        n = int(sizes[idx])
        new_max = max(cur_max, n)
        if cur and (new_max * (len(cur) + 1) > max_tokens
                    or (max_sentences and len(cur) >= max_sentences)):
            batches.append(np.asarray(cur))
            cur, cur_max = [], 0
            new_max = n
        cur.append(int(idx))
        cur_max = new_max
    if cur:
        batches.append(np.asarray(cur))
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        rng.shuffle(batches)
    return batches


AUDIO_BUCKETS = tuple(
    int(16000 * s) for s in (0.25, 0.5, 1, 2, 4, 6, 8, 10, 13, 16, 20, 25, 30)
)
TOKEN_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 600)
FRAME_BUCKETS = (128, 256, 384, 512, 768, 1024, 1536, 2048, 3000)
MEL_N_FFT, MEL_HOP = 1024, 256  # log_mel_numpy / fused_log_mel defaults


def collate_mel_targets(items, r: int, n_mels: int, bucketed: bool,
                        device_mel: bool, wav_key: str = "tgt_wav_raw"
                        ) -> Dict[str, np.ndarray]:
    """TTS-target collation (JAX manifests.py:62-111).

    Host mode (device_mel=False): items carry a per-utterance ``mel``
    (log_mel_numpy); packs bucketed ``target_mel`` and the r-thinned,
    zero-BOS ``prev_mel`` (reference text_to_speech_dataset.py:228-283).

    Device mode: items carry the raw target waveform under ``wav_key``; each
    utterance is reflect-padded here on the host (so on-device framing with
    center=False reproduces the per-utterance transform, whatever the batch
    padding) into ``tgt_wav`` [B, (mel_len - 1) * hop + n_fft]."""
    B = len(items)
    if device_mel:
        frames = [1 + len(it[wav_key]) // MEL_HOP for it in items]
        mel_len = max(frames)
    else:
        mel_len = max(it["mel"].shape[0] for it in items)
    if bucketed:
        mel_len = bucket_length(mel_len, FRAME_BUCKETS)
    mel_len -= mel_len % r
    dec_lengths = np.zeros((B,), np.int32)

    if device_mel:
        need = (mel_len - 1) * MEL_HOP + MEL_N_FFT
        tgt = np.zeros((B, need), np.float32)
        for b, it in enumerate(items):
            x = np.pad(it[wav_key].astype(np.float32),
                       (MEL_N_FFT // 2, MEL_N_FFT // 2), mode="reflect")
            L = min(len(x), need)
            tgt[b, :L] = x[:L]
            dec_lengths[b] = min(frames[b], mel_len)
        return {"tgt_wav": tgt, "dec_lengths": dec_lengths,
                "dec_lengths_r": dec_lengths // r}

    target_mel = np.zeros((B, mel_len, n_mels), np.float32)
    prev_mel = np.zeros((B, mel_len // r, n_mels), np.float32)
    for b, it in enumerate(items):
        m = it["mel"][:mel_len]
        target_mel[b, : len(m)] = m
        dec_lengths[b] = len(m)
        thin = m[r - 1 :: r]           # every r-th frame (1-indexed r-1)
        prev_mel[b, 1 : len(thin)] = thin[:-1]  # shifted, zero BOS
    return {"target_mel": target_mel, "prev_mel": prev_mel,
            "dec_lengths": dec_lengths, "dec_lengths_r": dec_lengths // r}


@dataclass
class SpeechToTextDataset:
    """ASR/ST: waveform source, token targets (reference
    data/speech_to_text_dataset.py:74-206)."""

    manifest: str
    labels: str                 # parallel label file (one utt per line)
    dictionary: Dictionary
    normalize: bool = False
    max_sample_size: Optional[int] = None

    def __post_init__(self):
        self.root, self.names, self.sizes = load_audio_manifest(self.manifest)
        self.label_lines = read_lines(self.labels)
        if len(self.label_lines) != len(self.names):
            raise ValueError(f"{len(self.label_lines)} labels != "
                             f"{len(self.names)} utterances")

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int) -> Dict:
        wav, _ = read_audio(os.path.join(self.root, self.names[i]))
        if self.normalize:
            wav = layer_norm_wav(wav)
        if self.max_sample_size and len(wav) > self.max_sample_size:
            wav = wav[: self.max_sample_size]
        tokens = self.dictionary.encode_line(self.label_lines[i])
        return {"id": i, "wav": wav.astype(np.float32),
                "tokens": np.asarray(tokens, np.int64)}

    @staticmethod
    def collate(items: List[Dict], eos_id: int, pad_id: int,
                bucketed: bool = True) -> Dict[str, np.ndarray]:
        B = len(items)
        wav_len = max(len(it["wav"]) for it in items)
        tok_len = max(len(it["tokens"]) for it in items)
        if bucketed:
            wav_len = bucket_length(wav_len, AUDIO_BUCKETS)
            tok_len = bucket_length(tok_len, TOKEN_BUCKETS)
        wav = np.zeros((B, wav_len), np.float32)
        wav_lengths = np.zeros((B,), np.int32)
        targets = np.full((B, tok_len), pad_id, np.int64)
        prev = np.full((B, tok_len), pad_id, np.int64)
        for b, it in enumerate(items):
            w, t = it["wav"], it["tokens"]
            wav[b, : min(len(w), wav_len)] = w[:wav_len]
            wav_lengths[b] = min(len(w), wav_len)
            L = min(len(t), tok_len)  # clamp once: utt may exceed top bucket
            targets[b, :L] = t[:L]
            # EOS-shifted decoder input (fairseq collate_tokens
            # move_eos_to_beginning)
            prev[b, 0] = eos_id
            prev[b, 1:L] = t[: L - 1]
        return {"wav": wav, "wav_lengths": wav_lengths,
                "prev_tokens": prev, "targets": targets,
                "ids": np.asarray([it["id"] for it in items])}


@dataclass
class TextToSpeechDataset:
    """TTS: token source, log-mel target and x-vector (reference
    data/text_to_speech_dataset.py:142-283)."""

    manifest: str
    labels: str
    dictionary: Dictionary
    spkemb_dir: Optional[str] = None   # .npy x-vectors by utterance basename
    reduction_factor: int = 2
    n_mels: int = 80
    device_mel: bool = False   # targets as the reflect-padded waveform; the
                               # train step computes the mels on the card

    def __post_init__(self):
        self.root, self.names, self.sizes = load_audio_manifest(self.manifest)
        self.label_lines = read_lines(self.labels)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int) -> Dict:
        wav, _ = read_audio(os.path.join(self.root, self.names[i]))
        tokens = self.dictionary.encode_line(self.label_lines[i])
        item = {"id": i, "tokens": np.asarray(tokens, np.int64)}
        if self.device_mel:
            item["tgt_wav_raw"] = wav.astype(np.float32)
        else:
            item["mel"] = log_mel_numpy(wav, n_mels=self.n_mels)
        if self.spkemb_dir:
            base = os.path.splitext(os.path.basename(self.names[i]))[0]
            item["spkemb"] = np.load(
                os.path.join(self.spkemb_dir, base + ".npy")).astype(np.float32)
        return item

    def collate(self, items: List[Dict], eos_id: int, pad_id: int,
                bucketed: bool = True) -> Dict[str, np.ndarray]:
        B = len(items)
        tok_len = max(len(it["tokens"]) for it in items)
        if bucketed:
            tok_len = bucket_length(tok_len, TOKEN_BUCKETS)
        tokens = np.full((B, tok_len), pad_id, np.int64)
        spk = None
        if "spkemb" in items[0]:
            spk = np.zeros((B, len(items[0]["spkemb"])), np.float32)
        for b, it in enumerate(items):
            t = it["tokens"]
            Lt = min(len(t), tok_len)  # clamp: utt may exceed top bucket
            tokens[b, :Lt] = t[:Lt]
            if spk is not None:
                spk[b] = it["spkemb"]
        batch = {"tokens": tokens, "ids": np.asarray([it["id"] for it in items])}
        batch.update(collate_mel_targets(items, self.reduction_factor, self.n_mels,
                                         bucketed, self.device_mel))
        if spk is not None:
            batch["spkembs"] = spk
        return batch


@dataclass
class SpeechToClassDataset:
    """SID: waveform source, one class id per utterance (reference
    data/speech_to_class_dataset.py:24-200; manifest rows are
    "wav_path\\tnframes\\tclass_label").  The class map is built sorted
    from the manifest's labels unless one is given.  A waveform longer than
    ``max_sample_size`` is cropped to a window drawn from a
    ``np.random.Generator`` seeded with ``seed`` (JAX draws it from numpy's
    global RNG, :345)."""

    manifest: str
    class_map: Optional[Dict[str, int]] = None  # label -> id; built if None
    normalize: bool = False
    max_sample_size: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        self.names, self.sizes, self.labels = [], [], []
        with open(self.manifest, encoding="utf-8") as f:
            self.root = f.readline().strip()
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3:
                    continue
                self.names.append(parts[0])
                self.sizes.append(int(parts[1]))
                self.labels.append(parts[2])
        self.sizes = np.asarray(self.sizes, np.int64)
        self.rng = np.random.default_rng(self.seed)
        if self.class_map is None:
            self.class_map = {c: i for i, c in enumerate(sorted(set(self.labels)))}
        else:
            self.check_labels()

    def check_labels(self):
        """Fail loudly (with the offending labels) when the manifest holds
        speakers absent from an externally supplied class map."""
        unknown = sorted({l for l in self.labels if l not in self.class_map})
        if unknown:
            raise ValueError(
                f"{self.manifest}: {len(unknown)} labels not in the supplied "
                f"class map (e.g. {unknown[:5]}); the map must come from the "
                f"TRAINING manifest and cover every eval speaker")

    @property
    def num_classes(self) -> int:
        return len(self.class_map)

    def save_class_map(self, path: str):
        """Write the label -> id map ("label\\tid" lines, by id), so that
        eval manifests with another speaker subset reuse the training map."""
        with open(path, "w", encoding="utf-8") as f:
            for label, idx in sorted(self.class_map.items(), key=lambda kv: kv[1]):
                f.write(f"{label}\t{idx}\n")

    @staticmethod
    def load_class_map(path: str) -> Dict[str, int]:
        out = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                label, idx = line.rstrip("\n").split("\t")
                out[label] = int(idx)
        return out

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int) -> Dict:
        wav, _ = read_audio(os.path.join(self.root, self.names[i]))
        if self.normalize:
            wav = layer_norm_wav(wav)
        if self.max_sample_size and len(wav) > self.max_sample_size:
            start = int(self.rng.integers(0, len(wav) - self.max_sample_size + 1))
            wav = wav[start : start + self.max_sample_size]
        return {"id": i, "wav": wav.astype(np.float32),
                "label": self.class_map[self.labels[i]]}

    def collate(self, items: List[Dict], bucketed: bool = True) -> Dict[str, np.ndarray]:
        B = len(items)
        wav_len = max(len(it["wav"]) for it in items)
        if bucketed:
            wav_len = bucket_length(wav_len, AUDIO_BUCKETS)
        wav = np.zeros((B, wav_len), np.float32)
        wav_lengths = np.zeros((B,), np.int32)
        targets = np.zeros((B,), np.int64)
        for b, it in enumerate(items):
            w = it["wav"][:wav_len]
            wav[b, : len(w)] = w
            wav_lengths[b] = len(w)
            targets[b] = it["label"]
        return {"wav": wav, "wav_lengths": wav_lengths, "targets": targets,
                "ids": np.asarray([it["id"] for it in items])}


@dataclass
class SpeechToSpeechDataset:
    """VC / SE: source waveform -> target log-mel + target-speaker x-vector
    (reference data/speech_to_speech_dataset.py:118-228; manifest rows are
    "src_wav\\tsrc_nframes\\ttgt_wav\\ttgt_nframes\\ttgt_spkemb", paths
    under the root).  ``se_mode``: also the r-thinned source fbank as the
    decoder input (reference se_decoder_input='source'): ``src_mel`` from
    the host, or in device mode the source reflect-padded onto the target's
    mel grid (``src_wav``, ``src_frames``) for ``device_mel_batch``."""

    manifest: str
    normalize: bool = False
    reduction_factor: int = 2
    n_mels: int = 80
    se_mode: bool = False
    device_mel: bool = False  # see TextToSpeechDataset.device_mel

    def __post_init__(self):
        self.src_names, self.sizes = [], []
        self.tgt_names, self.spkembs = [], []
        with open(self.manifest, encoding="utf-8") as f:
            self.root = f.readline().strip()
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 5:
                    continue
                self.src_names.append(parts[0])
                self.sizes.append(int(parts[1]))
                self.tgt_names.append(parts[2])
                self.spkembs.append(parts[4])
        self.sizes = np.asarray(self.sizes, np.int64)

    def __len__(self):
        return len(self.src_names)

    def __getitem__(self, i: int) -> Dict:
        wav, _ = read_audio(os.path.join(self.root, self.src_names[i]))
        if self.normalize:
            wav = layer_norm_wav(wav)
        tgt_wav, _ = read_audio(os.path.join(self.root, self.tgt_names[i]))
        spkemb = np.load(os.path.join(self.root, self.spkembs[i])).astype(np.float32)
        item = {"id": i, "wav": wav.astype(np.float32), "spkemb": spkemb}
        if self.device_mel:
            item["tgt_wav_raw"] = tgt_wav.astype(np.float32)
        else:
            item["mel"] = log_mel_numpy(tgt_wav, n_mels=self.n_mels)
        if self.se_mode and not self.device_mel:
            item["src_mel"] = log_mel_numpy(wav, n_mels=self.n_mels)
        return item

    def collate(self, items: List[Dict], bucketed: bool = True) -> Dict[str, np.ndarray]:
        B = len(items)
        r = self.reduction_factor
        wav_len = max(len(it["wav"]) for it in items)
        if bucketed:
            wav_len = bucket_length(wav_len, AUDIO_BUCKETS)
        wav = np.zeros((B, wav_len), np.float32)
        wav_lengths = np.zeros((B,), np.int32)
        spk = np.zeros((B, len(items[0]["spkemb"])), np.float32)
        for b, it in enumerate(items):
            w = it["wav"][:wav_len]
            wav[b, : len(w)] = w
            wav_lengths[b] = len(w)
            spk[b] = it["spkemb"]
        batch = {"wav": wav, "wav_lengths": wav_lengths, "spkembs": spk,
                 "ids": np.asarray([it["id"] for it in items])}
        mel_batch = collate_mel_targets(items, r, self.n_mels, bucketed, self.device_mel)
        batch.update(mel_batch)
        if self.se_mode and self.device_mel:
            # the source reflect-padded on the host, sized to the target's
            # mel grid; the train step frames and thins it on the card and
            # zeroes the rows past the source's own frame count
            need = mel_batch["tgt_wav"].shape[1]
            mel_len = (need - MEL_N_FFT) // MEL_HOP + 1
            src_wav = np.zeros((B, need), np.float32)
            src_frames = np.zeros((B,), np.int32)
            for b, it in enumerate(items):
                x = np.pad(it["wav"].astype(np.float32),
                           (MEL_N_FFT // 2, MEL_N_FFT // 2), mode="reflect")
                L = min(len(x), need)
                src_wav[b, :L] = x[:L]
                src_frames[b] = min(1 + len(it["wav"]) // MEL_HOP, mel_len)
            batch["src_wav"] = src_wav
            batch["src_frames"] = src_frames
        elif self.se_mode:
            mel_len = mel_batch["target_mel"].shape[1]
            src_mel = np.zeros((B, mel_len // r, self.n_mels), np.float32)
            for b, it in enumerate(items):
                sthin = it["src_mel"][:mel_len][r - 1 :: r]
                L = min(len(sthin), mel_len // r)
                src_mel[b, :L] = sthin[:L]
            batch["src_mel"] = src_mel
        return batch


@dataclass
class TextPretrainDataset:
    """BART text pretraining over a text corpus (JAX manifests.py:469-579;
    reference tasks/speecht5.py:439-480): each line encoded by the
    dictionary (no EOS; ``encode_line``, or ``encode`` for a
    ``SentencePieceModel``), or read already numericalized from a
    fairseq-binarized ``<prefix>.bin/.idx`` (``text_file`` the prefix or
    either file, ``data/binarized.py``), packed into blocks of
    ``tokens_per_sample`` - 2 (``break_mode`` none: one continuous stream;
    complete: whole lines; eos: one line each), framed by BOS / EOS, and
    noised per item at collation (``text_noising.noise_tokens``, seeded by
    the item and the epoch)."""

    text_file: str
    dictionary: object                  # Dictionary or SentencePieceModel
    tokens_per_sample: int = 512
    break_mode: str = "none"            # none | complete | eos
    bos_id: int = 0
    eos_id: int = 2
    pad_id: int = 1
    mask_id: Optional[int] = None       # <mask> id; required for noising
    noising: Optional[object] = None    # NoisingConfig; None = the default
    seed: int = 1

    def __post_init__(self):
        from . import text_noising as TN

        if self.noising is None:
            self.noising = TN.NoisingConfig()
        sents = []
        prefix = self.text_file
        if prefix.endswith((".bin", ".idx")):
            prefix = prefix[:-4]
        if binarized.exists(prefix):
            ds = binarized.MMapIndexedDataset(prefix)
            sents = [ds[i] for i in range(len(ds)) if len(ds[i])]
        else:
            for line in read_lines(self.text_file):
                if not line.strip():
                    continue
                if hasattr(self.dictionary, "encode_line"):
                    ids = self.dictionary.encode_line(line, append_eos=False)
                else:
                    ids = self.dictionary.encode(line)
                if len(ids):
                    sents.append(np.asarray(ids, np.int64))
        block = self.tokens_per_sample - 2  # room for bos/eos
        self.blocks = []
        if self.break_mode == "eos":
            self.blocks = [s[:block] for s in sents]
        elif self.break_mode == "complete":
            cur, n = [], 0
            for s in sents:
                if n + len(s) > block and cur:
                    self.blocks.append(np.concatenate(cur))
                    cur, n = [], 0
                cur.append(s[:block])
                n += len(s)
            if cur:
                self.blocks.append(np.concatenate(cur))
        else:
            stream = np.concatenate(sents) if sents else np.zeros(0, np.int64)
            self.blocks = [stream[i : i + block] for i in range(0, len(stream), block)]
        self.sizes = np.asarray([len(b) + 2 for b in self.blocks], np.int64)

    def __len__(self):
        return len(self.blocks)

    def __getitem__(self, i: int) -> Dict:
        toks = np.concatenate([[self.bos_id], self.blocks[i], [self.eos_id]])
        return {"id": i, "tokens": toks.astype(np.int64)}

    def collate(self, items: List[Dict], bucketed: bool = True,
                epoch: int = 0) -> Dict[str, np.ndarray]:
        """-> {"tokens": the noised source, "targets": the clean tokens,
        "prev_tokens": the targets shifted right behind EOS, "ids"}, padded
        to token buckets."""
        from .text_noising import noise_tokens

        if self.mask_id is None:
            raise ValueError("mask_id is required for BART noising")
        B = len(items)
        vocab = len(self.dictionary)
        pairs = [noise_tokens(it["tokens"], self.noising, self.mask_id, vocab,
                              seed=self.seed + 1000003 * epoch + int(it["id"]))
                 for it in items]
        src_len = max(len(s) for s, _ in pairs)
        tgt_len = max(len(t) for _, t in pairs)
        if bucketed:
            src_len = bucket_length(src_len, TOKEN_BUCKETS)
            tgt_len = bucket_length(tgt_len, TOKEN_BUCKETS)
        tokens = np.full((B, src_len), self.pad_id, np.int64)
        targets = np.full((B, tgt_len), self.pad_id, np.int64)
        prev = np.full((B, tgt_len), self.pad_id, np.int64)
        for b, (src, tgt) in enumerate(pairs):
            Ls, Lt = min(len(src), src_len), min(len(tgt), tgt_len)
            tokens[b, :Ls] = src[:Ls]
            targets[b, :Lt] = tgt[:Lt]
            prev[b, 0] = self.eos_id
            prev[b, 1:Lt] = tgt[: Lt - 1]
        return {"tokens": tokens, "targets": targets, "prev_tokens": prev,
                "ids": np.asarray([it["id"] for it in items])}


@dataclass
class SpeechPretrainDataset:
    """HuBERT-style speech pretraining (JAX manifests.py:582-684; reference
    data/speech_dataset.py:186-476): waveform, frame-level km labels (one
    utterance a line, space-separated ints, at ``label_rate`` Hz) and the
    fbank decoder target, on the host or, with ``device_mel``, as the
    reflect-padded waveform for ``train/trainer.device_mel_batch``.  A
    waveform longer than ``max_sample_size`` is cropped, its labels with
    it, at a start drawn from a ``np.random.Generator`` seeded with
    ``seed`` (JAX draws it from numpy's global RNG, :624).

    With ``add_decoder_target`` the batch also carries Speech2C's token
    decoder targets (JAX :664-683; reference Speech2C/speech2c/data/
    speech2c_dataset.py:65-110): the km labels cut to the frames, collapsed
    by unique-consecutive (pretraining) or kept frame-level
    (``fine_tuning``), offset by ``unit_offset`` into the token vocabulary
    (a fairseq Dictionary's 4 specials first), EOS appended, padded to a
    token bucket, with the EOS-shifted ``prev_tokens``."""

    manifest: str
    km_labels: str
    label_rate: float = 50.0
    sample_rate: int = 16000
    max_sample_size: int = 250000
    n_mels: int = 80
    reduction_factor: int = 2
    normalize: bool = False
    device_mel: bool = False
    seed: int = 0
    add_decoder_target: bool = False
    fine_tuning: bool = False
    pad_id: int = 1
    eos_id: int = 2
    unit_offset: int = 4

    def __post_init__(self):
        self.root, self.names, self.sizes = load_audio_manifest(self.manifest)
        self.label_lines = read_lines(self.km_labels)
        self.rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int) -> Dict:
        wav, _ = read_audio(os.path.join(self.root, self.names[i]))
        if self.normalize:
            wav = layer_norm_wav(wav)
        labels = np.asarray(self.label_lines[i].split(), np.int64)
        if len(wav) > self.max_sample_size:
            start = int(self.rng.integers(0, len(wav) - self.max_sample_size + 1))
            wav = wav[start : start + self.max_sample_size]
            ls = int(start * self.label_rate / self.sample_rate)
            le = ls + int(self.max_sample_size * self.label_rate / self.sample_rate)
            labels = labels[ls:le]
        item = {"id": i, "wav": wav.astype(np.float32), "labels": labels}
        if self.device_mel:
            item["tgt_wav_raw"] = item["wav"]
        else:
            item["mel"] = log_mel_numpy(wav, n_mels=self.n_mels)
        return item

    def collate(self, items: List[Dict], frame_fn, bucketed: bool = True
                ) -> Dict[str, np.ndarray]:
        """frame_fn: waveform samples -> encoder frames (the conv length
        arithmetic).  -> {"wav", "wav_lengths", "km_labels" [B, frames]
        (the labels cut to the frames, 0 past them), the mel targets, "ids"
        [, "decoder_targets", "prev_tokens", "decoder_target_lengths"]}."""
        B = len(items)
        wav_len = max(len(it["wav"]) for it in items)
        if bucketed:
            wav_len = bucket_length(wav_len, AUDIO_BUCKETS)
        frames = int(frame_fn(wav_len))
        wav = np.zeros((B, wav_len), np.float32)
        wav_lengths = np.zeros((B,), np.int32)
        km = np.zeros((B, frames), np.int64)
        for b, it in enumerate(items):
            w = it["wav"][:wav_len]
            wav[b, : len(w)] = w
            wav_lengths[b] = len(w)
            lab = it["labels"][:frames]
            km[b, : len(lab)] = lab
        batch = {"wav": wav, "wav_lengths": wav_lengths, "km_labels": km,
                 "ids": np.asarray([it["id"] for it in items])}
        batch.update(collate_mel_targets(items, self.reduction_factor, self.n_mels,
                                         bucketed, self.device_mel))
        if self.add_decoder_target:
            batch.update(self._decoder_targets(items, frames, bucketed))
        return batch

    def _decoder_targets(self, items, frames: int, bucketed: bool):
        seqs = []
        for it in items:
            lab = it["labels"][:frames]
            if not self.fine_tuning and len(lab):
                lab = lab[np.concatenate(([True], lab[1:] != lab[:-1]))]
            seqs.append(np.concatenate([lab + self.unit_offset, [self.eos_id]]))
        B, L = len(seqs), max(len(q) for q in seqs)
        if bucketed:
            L = bucket_length(L, TOKEN_BUCKETS)
        dec_tgt = np.full((B, L), self.pad_id, np.int64)
        prev = np.full((B, L), self.pad_id, np.int64)
        prev[:, 0] = self.eos_id
        for b, q in enumerate(seqs):
            n = min(len(q), L)
            dec_tgt[b, :n] = q[:n]
            prev[b, 1:n] = q[: n - 1]
        return {"decoder_targets": dec_tgt, "prev_tokens": prev,
                "decoder_target_lengths": np.asarray([min(len(q), L) for q in seqs],
                                                     np.int32)}
