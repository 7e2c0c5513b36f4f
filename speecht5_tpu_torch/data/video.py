"""Video ingest + image-space transforms for the VATLM visual frontend.

A copy of ``speecht5_tpu/data/video.py`` (numpy only; the port may not
import it).

Behavioral spec from reference VATLM/vat_hubert/vathubert/utils.py:33-140 and
vathubert_dataset.py:220-231:
- train transform: Normalize(0, 255) -> RandomCrop(crop, crop) ->
  HorizontalFlip(0.5) -> Normalize(image_mean, image_std);
- eval transform:  Normalize(0, 255) -> CenterCrop -> Normalize(mean, std);
- defaults crop 88, mean 0.421, std 0.165
  (reference tasks/vathubert_pretraining.py:169-175);
- video decode to grayscale [T, H, W] (reference load_video uses OpenCV
  BGR2GRAY per frame, utils.py:13-30).

Departures from the reference: transforms are pure numpy functions of an
explicit np.random.Generator (the reference uses the global `random`
module — unseeded, unreproducible); the whole clip is flipped/cropped with
one slice instead of per-frame loops.  File ingest supports the AV-HuBERT
preprocessed ``.npy`` ROI format and uncompressed YUV4MPEG2 (``.y4m``) — a
plain-header raw-frame format every ffmpeg can emit — so no codec
dependency is needed in the training loop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IMAGE_CROP_SIZE = 88
IMAGE_MEAN = 0.421
IMAGE_STD = 0.165


def center_crop(frames: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[T, H, W] -> [T, th, tw] (reference CenterCrop, utils.py:77-96)."""
    t, h, w = frames.shape
    th, tw = size
    if h < th or w < tw:
        raise ValueError(f"frames {h}x{w} smaller than crop {th}x{tw}")
    dh = int(round(h - th) / 2.0)
    dw = int(round(w - tw) / 2.0)
    return frames[:, dh : dh + th, dw : dw + tw]


def random_crop(frames: np.ndarray, size: Tuple[int, int],
                rng: np.random.Generator) -> np.ndarray:
    """One crop offset shared by ALL frames of the clip (reference
    RandomCrop, utils.py:99-120)."""
    t, h, w = frames.shape
    th, tw = size
    if h < th or w < tw:
        raise ValueError(f"frames {h}x{w} smaller than crop {th}x{tw}")
    dh = int(rng.integers(0, h - th + 1))
    dw = int(rng.integers(0, w - tw + 1))
    return frames[:, dh : dh + th, dw : dw + tw]


def horizontal_flip(frames: np.ndarray, flip_ratio: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Flip the whole clip left-right with probability flip_ratio
    (reference HorizontalFlip, utils.py:122-140)."""
    if rng.random() < flip_ratio:
        return frames[:, :, ::-1]
    return frames


def train_transform(
    frames: np.ndarray,
    rng: np.random.Generator,
    crop_size: int = IMAGE_CROP_SIZE,
    mean: float = IMAGE_MEAN,
    std: float = IMAGE_STD,
) -> np.ndarray:
    """Normalize(0,255) -> RandomCrop -> HorizontalFlip(0.5) ->
    Normalize(mean, std) (reference vathubert_dataset.py:221-226)."""
    x = frames.astype(np.float32) / 255.0
    x = random_crop(x, (crop_size, crop_size), rng)
    x = horizontal_flip(x, 0.5, rng)
    return ((x - mean) / std).astype(np.float32)


def eval_transform(
    frames: np.ndarray,
    crop_size: int = IMAGE_CROP_SIZE,
    mean: float = IMAGE_MEAN,
    std: float = IMAGE_STD,
) -> np.ndarray:
    """Normalize(0,255) -> CenterCrop -> Normalize(mean, std)
    (reference vathubert_dataset.py:227-231)."""
    x = frames.astype(np.float32) / 255.0
    x = center_crop(x, (crop_size, crop_size))
    return ((x - mean) / std).astype(np.float32)


# ---------------------------------------------------------------------------
# YUV4MPEG2 ingest (uncompressed; luma plane = grayscale)
# ---------------------------------------------------------------------------

_Y4M_MAGIC = b"YUV4MPEG2"
_CHROMA_SUBSAMPLE = {  # chroma plane size divisors (w, h) per colourspace
    "420": (2, 2), "420jpeg": (2, 2), "420mpeg2": (2, 2), "420paldv": (2, 2),
    "422": (2, 1), "444": (1, 1), "mono": None,
}


def read_y4m(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Read a YUV4MPEG2 file -> grayscale uint8 [T, H, W] (the Y plane —
    equivalent to the reference's per-frame BGR2GRAY up to BT.601 rounding).

    Supports C420*, C422, C444 and Cmono, 8-bit.
    """
    with open(path, "rb") as f:
        header = bytearray()
        while True:
            c = f.read(1)
            if not c:
                raise ValueError(f"{path}: truncated y4m header")
            if c == b"\n":
                break
            header += c
        parts = bytes(header).split(b" ")
        if parts[0] != _Y4M_MAGIC:
            raise ValueError(f"{path}: not a YUV4MPEG2 file")
        w = h = None
        chroma = "420jpeg"
        for p in parts[1:]:
            if not p:
                continue
            tag, val = chr(p[0]), p[1:].decode("ascii", "replace")
            if tag == "W":
                w = int(val)
            elif tag == "H":
                h = int(val)
            elif tag == "C":
                chroma = val
        if not w or not h:
            raise ValueError(f"{path}: missing W/H in y4m header")
        if chroma not in _CHROMA_SUBSAMPLE:
            raise ValueError(f"{path}: unsupported chroma '{chroma}'")
        sub = _CHROMA_SUBSAMPLE[chroma]
        y_size = w * h
        c_size = 0 if sub is None else 2 * ((w // sub[0]) * (h // sub[1]))

        frames = []
        while max_frames is None or len(frames) < max_frames:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError(f"{path}: bad frame marker {line[:16]!r}")
            y = f.read(y_size)
            if len(y) < y_size:
                raise ValueError(f"{path}: truncated frame {len(frames)}")
            frames.append(
                np.frombuffer(y, np.uint8).reshape(h, w)
            )
            if c_size:
                f.seek(c_size, 1)  # skip chroma planes
        return np.stack(frames) if frames else np.zeros((0, h, w), np.uint8)


def write_y4m(path: str, frames: np.ndarray, chroma: str = "mono") -> None:
    """Write grayscale uint8 [T, H, W] as y4m (test fixtures / round-trips).
    ``chroma='420jpeg'`` writes neutral (128) chroma planes."""
    t, h, w = frames.shape
    assert frames.dtype == np.uint8
    sub = _CHROMA_SUBSAMPLE[chroma]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C{chroma}\n"
                .encode("ascii"))
        for fr in frames:
            f.write(b"FRAME\n")
            f.write(fr.tobytes())
            if sub is not None:
                n = (w // sub[0]) * (h // sub[1])
                f.write(bytes([128]) * (2 * n))


def load_video(path: str) -> np.ndarray:
    """File -> grayscale [T, H, W] float32 in [0, 255] (pre-transform scale).
    ``.npy``: AV-HuBERT preprocessed ROI tensors ([T, H, W] or [T, H, W, 1]);
    ``.y4m``: uncompressed video."""
    if path.endswith(".y4m"):
        return read_y4m(path).astype(np.float32)
    v = np.load(path)
    if v.ndim == 4:
        v = v[..., 0]
    return v.astype(np.float32)
