"""VATLM audio-visual dataset: AV manifests -> fused-frontend batches.

A copy of ``speecht5_tpu/data/vatlm.py`` (numpy only; the port may not
import it), so items and collates are bit-equal to JAX's.

Reference: VATLM/vat_hubert/vathubert/data/vathubert_dataset.py —
- manifest TSV: root line, then ``id \\t video_path \\t audio_path \\t
  n_samples [\\t ...]`` with the size in items[-2] (load_audio_visual:42-82);
- audio features are 26-dim log-fbank at 10 ms hop, stacked ``stack_order``
  (4) consecutive frames to 104-dim @ 25 Hz so they align 1:1 with 25 fps
  video (stacker:262-276); the trailing remainder is zero-padded;
- audio is trimmed / zero-padded to the video length (load_feature:291-296);
- optional per-frame layer norm of the stacked features after alignment
  (reference __getitem__: ``F.layer_norm(audio_feats, shape[1:])``);
- video features are [T, H, W, 1] lip-ROI crops decoded from files
  (``.npy`` AV-HuBERT ROI tensors or uncompressed ``.y4m`` video — see
  data/video.py; the reference uses OpenCV mp4 decode, load_video:299-300)
  and passed through the reference's image transforms: train =
  Normalize(0,255) + RandomCrop(88) + HorizontalFlip(0.5) +
  Normalize(mean, std), eval = CenterCrop (vathubert_dataset.py:220-231);
- K km-label streams with byte-offset random access; this build assumes
  label rate == fused frame rate (25 Hz), the configuration every shipped
  VATLM recipe uses;
- collation pads (pad_audio) or crops (random_crop) to a common length and
  crops frame labels to match (collater:377-497).

Audio fbank here is our all-matmul log-mel (`ops/mel.py`) with kaldi-style
geometry (25 ms window / 10 ms hop, 26 bins) — protocol-compatible shapes,
not bit-parity with python_speech_features.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .audio import read_audio
from ..ops.mel import log_mel_numpy


def stack_frames(feats: np.ndarray, stack_order: int) -> np.ndarray:
    """[T, F] -> [ceil(T/s), F*s], zero-padding the remainder (reference
    stacker, vathubert_dataset.py:262-276)."""
    if stack_order <= 1:
        return feats
    T, F = feats.shape
    rem = -T % stack_order
    if rem:
        feats = np.concatenate(
            [feats, np.zeros((rem, F), feats.dtype)], axis=0)
    return feats.reshape(-1, stack_order * F)


def audio_fbank(wav: np.ndarray, n_mels: int = 26, sr: int = 16000,
                stack_order: int = 4) -> np.ndarray:
    """waveform -> stacked log-fbank [T/stack, n_mels*stack] (10 ms hop)."""
    fb = log_mel_numpy(wav.astype(np.float32), sr=sr, n_fft=400, hop=160,
                       n_mels=n_mels, fmin=20.0, fmax=sr / 2)
    return stack_frames(fb.astype(np.float32), stack_order)


def load_av_manifest(path: str) -> Tuple[str, List[Dict], np.ndarray]:
    """root, rows ({id, video, audio}), sizes (items[-2], raw samples)."""
    rows, sizes = [], []
    with open(path, encoding="utf-8") as f:
        root = f.readline().strip()
        for line in f:
            items = line.rstrip("\n").split("\t")
            if len(items) < 4:
                continue
            rows.append({"id": items[0], "video": items[1],
                         "audio": items[2]})
            sizes.append(int(items[-2]))
    return root, rows, np.asarray(sizes, np.int64)


@dataclass
class VATLMDataset:
    """Audio-visual pretraining/fine-tune utterances.

    ``modalities`` selects which streams each item carries ('audio',
    'video'); a missing modality yields None and the model substitutes
    zeros (VATLMModel.fuse_features)."""

    manifest_path: str
    label_paths: Sequence[str] = ()
    modalities: Sequence[str] = ("audio", "video")
    n_mels: int = 26
    stack_order: int = 4
    normalize: bool = True
    sr: int = 16000
    #: image-space pipeline (reference vathubert_dataset.py:220-231;
    #: defaults from tasks/vathubert_pretraining.py:169-175).  image_aug=True
    #: applies the train transform (RandomCrop + HorizontalFlip), else the
    #: eval CenterCrop.  Raw [T, H, W(, 1)] inputs in [0, 255] are expected;
    #: already-normalized preprocessed tensors can set image_transform=False.
    image_transform: bool = True
    image_aug: bool = False
    image_crop_size: int = 88
    image_mean: float = 0.421
    image_std: float = 0.165
    seed: int = 1
    root: str = field(init=False)

    def __post_init__(self):
        self.root, self.rows, self.sizes = load_av_manifest(
            self.manifest_path)
        self.epoch = 0
        self.labels = [
            [line.rstrip("\n") for line in open(p, encoding="utf-8")]
            for p in self.label_paths
        ]
        for p, lab in zip(self.label_paths, self.labels):
            if len(lab) != len(self.rows):
                raise ValueError(
                    f"{p}: {len(lab)} labels != {len(self.rows)} utterances")

    def __len__(self):
        return len(self.rows)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __getitem__(self, i: int) -> Dict:
        from .video import load_video, train_transform, eval_transform

        row = self.rows[i]
        video = audio = None
        if "video" in self.modalities:
            video = load_video(os.path.join(self.root, row["video"]))
            if video.ndim == 4:
                video = video[..., 0]
            if self.image_transform:
                if self.image_aug:
                    rng = np.random.default_rng(
                        np.random.SeedSequence([self.seed, self.epoch, i])
                    )
                    video = train_transform(
                        video, rng, self.image_crop_size,
                        self.image_mean, self.image_std,
                    )
                else:
                    video = eval_transform(
                        video, self.image_crop_size,
                        self.image_mean, self.image_std,
                    )
            video = video[..., None].astype(np.float32)
        if "audio" in self.modalities:
            wav, sr = read_audio(os.path.join(self.root, row["audio"]))
            if sr != self.sr:
                raise ValueError(f"{row['id']}: expected {self.sr} Hz")
            audio = audio_fbank(wav, self.n_mels, sr, self.stack_order)
            if video is not None:
                # align to video length (reference load_feature:291-296)
                diff = len(audio) - len(video)
                if diff < 0:
                    audio = np.concatenate(
                        [audio,
                         np.zeros((-diff, audio.shape[1]), audio.dtype)])
                elif diff > 0:
                    audio = audio[: len(video)]
            if self.normalize:
                # per-frame layer norm over the stacked feature dim, after
                # AV alignment (reference __getitem__: F.layer_norm(
                # audio_feats, audio_feats.shape[1:]))
                mu = audio.mean(-1, keepdims=True)
                sd = audio.std(-1, keepdims=True)
                audio = (audio - mu) / (sd + 1e-5)
        item = {"id": row["id"], "audio": audio, "video": video}
        for k, lab in enumerate(self.labels):
            item[f"labels_{k}"] = np.asarray(
                [int(t) for t in lab[i].split()], np.int32)
        return item

    def num_frames(self, item: Dict) -> int:
        src = item["audio"] if item["audio"] is not None else item["video"]
        return len(src)

    def collate(self, items: List[Dict],
                max_frames: Optional[int] = None,
                random_crop: bool = False,
                rng: Optional[np.random.Generator] = None) -> Dict:
        """Pad to the batch max (or crop to ``max_frames``), crop frame
        labels alike. Returns VATLMModel.forward_pretrain kwargs: audio
        [B, T, F] | None, video [B, T, H, W, C] | None, lengths [B],
        targets (list of [B, T] padded with -1)."""
        B = len(items)
        lens = np.asarray([self.num_frames(it) for it in items], np.int32)
        T = int(lens.max())
        if max_frames is not None and T > max_frames:
            T = max_frames
        starts = np.zeros(B, np.int32)
        if random_crop and rng is not None:
            for b in range(B):
                if lens[b] > T:
                    starts[b] = rng.integers(0, lens[b] - T + 1)
        lens = np.minimum(lens, T)

        batch: Dict = {"lengths": lens, "audio": None, "video": None}
        if items[0]["audio"] is not None:
            F = items[0]["audio"].shape[1]
            audio = np.zeros((B, T, F), np.float32)
            for b, it in enumerate(items):
                seg = it["audio"][starts[b]: starts[b] + lens[b]]
                audio[b, : len(seg)] = seg
            batch["audio"] = audio
        if items[0]["video"] is not None:
            H, W, C = items[0]["video"].shape[1:]
            video = np.zeros((B, T, H, W, C), np.float32)
            for b, it in enumerate(items):
                seg = it["video"][starts[b]: starts[b] + lens[b]]
                video[b, : len(seg)] = seg
            batch["video"] = video
        targets = []
        for k in range(len(self.labels)):
            tgt = np.full((B, T), -1, np.int32)
            for b, it in enumerate(items):
                seg = it[f"labels_{k}"][starts[b]: starts[b] + lens[b]]
                tgt[b, : len(seg)] = seg
            targets.append(tgt)
        if targets:
            batch["targets"] = targets
        return batch
