"""fairseq binarized dataset interop: mmap ``.bin``/``.idx`` reader + writer
(the port's copy of ``speecht5_tpu/data/binarized.py``, the same formats
byte for byte).

The reference's text-side datasets ride on fairseq ``MMapIndexedDataset``
(``data/text_dataset.py`` via ``TokenBlockDataset``; the shipped LibriLM
fixtures are distributed in this form — ``SpeechLM/dataset/LibriLM/
phone_unit/bin-idx/`` carries the dictionaries and config for them).  This
module implements the two on-disk formats from their public spec so
fairseq-binarized corpora load directly into our text/unit pipelines, and so
``prep`` can binarize corpora for fast mmap access:

- **mmap** (default, magic ``MMIDIDX``): ``.idx`` = header + int32 sizes +
  int64 byte-pointers; ``.bin`` = raw concatenated token arrays.
- **legacy cached** (magic ``TNTIDX``): ``.idx`` = header + int64
  dim/data-offset tables; ``.bin`` = raw elements.

Token ids are whatever dictionary indexed the corpus at binarization time
(fairseq appends ``eos`` per sentence), so readers hand back numericalized
sentences ready for token-block packing.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, List, Optional, Sequence

import numpy as np

_MMAP_MAGIC = b"MMIDIDX\x00\x00"
_LEGACY_MAGIC = b"TNTIDX\x00\x00"

# fairseq indexed_dataset dtype code table
_CODE_TO_DTYPE = {
    1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
    5: np.int64, 6: np.float32, 7: np.float64, 8: np.uint16,
}
_DTYPE_TO_CODE = {np.dtype(v): k for k, v in _CODE_TO_DTYPE.items()}


def best_fitting_dtype(vocab_size: Optional[int]) -> np.dtype:
    """fairseq's rule: uint16 when the vocab fits, else int32."""
    if vocab_size is not None and vocab_size < 65500:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def index_file(prefix: str) -> str:
    return prefix + ".idx"


def data_file(prefix: str) -> str:
    return prefix + ".bin"


def exists(prefix: str) -> bool:
    return os.path.exists(index_file(prefix)) and os.path.exists(
        data_file(prefix)
    )


class MMapIndexedDataset:
    """Random-access reader over a fairseq-binarized corpus.

    Detects the format from the ``.idx`` magic.  Items are returned as int64
    numpy arrays (fairseq consumers cast the same way).
    """

    def __init__(self, prefix: str):
        idx_path, bin_path = index_file(prefix), data_file(prefix)
        with open(idx_path, "rb") as f:
            magic = f.read(9)
            if magic == _MMAP_MAGIC:
                self._init_mmap(f, bin_path)
            elif magic[:8] == _LEGACY_MAGIC:
                # legacy magic is 8 bytes; re-read from the right offset
                f.seek(8)
                self._init_legacy(f, bin_path)
            else:
                raise ValueError(
                    f"{idx_path}: unrecognized index magic {magic[:8]!r}"
                )

    def _init_mmap(self, f, bin_path):
        (version,) = struct.unpack("<Q", f.read(8))
        if version != 1:
            raise ValueError(f"unsupported mmap index version {version}")
        (code,) = struct.unpack("<B", f.read(1))
        self.dtype = np.dtype(_CODE_TO_DTYPE[code])
        (count,) = struct.unpack("<Q", f.read(8))
        offset = f.tell()
        buf = np.memmap(f.name, mode="r", order="C")
        self.sizes = np.frombuffer(buf, np.int32, count, offset)
        self.pointers = np.frombuffer(
            buf, np.int64, count, offset + self.sizes.nbytes
        )
        self._bin = np.memmap(bin_path, self.dtype, mode="r", order="C")
        self._legacy = None

    def _init_legacy(self, f, bin_path):
        version, = struct.unpack("<Q", f.read(8))
        if version != 1:
            raise ValueError(f"unsupported legacy index version {version}")
        code, self.element_size = struct.unpack("<QQ", f.read(16))
        self.dtype = np.dtype(_CODE_TO_DTYPE[code])
        n, s = struct.unpack("<QQ", f.read(16))
        self.dim_offsets = np.frombuffer(f.read(8 * (n + 1)), np.int64)
        self.data_offsets = np.frombuffer(f.read(8 * (n + 1)), np.int64)
        dim_sizes = np.frombuffer(f.read(8 * s), np.int64)
        # flatten per-item dims to lengths (text corpora are 1-D per item)
        self.sizes = np.asarray(
            [
                int(np.prod(dim_sizes[self.dim_offsets[i]:
                                      self.dim_offsets[i + 1]]))
                for i in range(n)
            ],
            np.int64,
        )
        self.pointers = self.data_offsets[:-1] * self.dtype.itemsize
        self._bin = np.memmap(bin_path, self.dtype, mode="r", order="C")
        self._legacy = True

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        if i < 0:
            i += len(self)
        start = self.pointers[i] // self.dtype.itemsize
        return np.asarray(
            self._bin[start : start + self.sizes[i]], np.int64
        )


class MMapIndexedDatasetWriter:
    """Streaming writer for the mmap format (binarization side)."""

    def __init__(self, prefix: str, dtype=np.int32):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        self._bin = open(data_file(prefix), "wb")
        self.sizes: List[int] = []
        self.pointers: List[int] = []
        self._offset = 0

    def add_item(self, tokens: Sequence[int]):
        arr = np.asarray(tokens, dtype=self.dtype)
        self.pointers.append(self._offset)
        self.sizes.append(arr.size)
        self._bin.write(arr.tobytes(order="C"))
        self._offset += arr.nbytes

    def finalize(self):
        self._bin.close()
        with open(index_file(self.prefix), "wb") as f:
            f.write(_MMAP_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", _DTYPE_TO_CODE[self.dtype]))
            f.write(struct.pack("<Q", len(self.sizes)))
            f.write(np.asarray(self.sizes, np.int32).tobytes(order="C"))
            f.write(np.asarray(self.pointers, np.int64).tobytes(order="C"))


def write_binarized(
    prefix: str,
    sequences: Iterable[Sequence[int]],
    vocab_size: Optional[int] = None,
) -> MMapIndexedDataset:
    """Binarize token id sequences to ``prefix.{bin,idx}``; returns a reader."""
    w = MMapIndexedDatasetWriter(prefix, best_fitting_dtype(vocab_size))
    for seq in sequences:
        w.add_item(seq)
    w.finalize()
    return MMapIndexedDataset(prefix)


def write_legacy(prefix: str, sequences: Iterable[Sequence[int]],
                 dtype=np.int32) -> MMapIndexedDataset:
    """Write the legacy ``TNTIDX`` cached format (for interop tests)."""
    dtype = np.dtype(dtype)
    sizes: List[int] = []
    dim_offsets = [0]
    data_offsets = [0]
    with open(data_file(prefix), "wb") as f:
        for seq in sequences:
            arr = np.asarray(seq, dtype=dtype)
            f.write(arr.tobytes(order="C"))
            sizes.append(arr.size)
            dim_offsets.append(dim_offsets[-1] + 1)
            data_offsets.append(data_offsets[-1] + arr.size)
    with open(index_file(prefix), "wb") as f:
        f.write(_LEGACY_MAGIC)
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<QQ", _DTYPE_TO_CODE[dtype], dtype.itemsize))
        f.write(struct.pack("<QQ", len(sizes), len(sizes)))
        f.write(np.asarray(dim_offsets, np.int64).tobytes(order="C"))
        f.write(np.asarray(data_offsets, np.int64).tobytes(order="C"))
        f.write(np.asarray(sizes, np.int64).tobytes(order="C"))
    return MMapIndexedDataset(prefix)
