"""SentencePiece model loader + encoder (dependency-free; the port's copy of
``speecht5_tpu/data/sentencepiece.py``).

The reference tokenizes ST/MT text with the SentencePiece C++ library
(reference SpeechT5/speecht5/tasks/speecht5.py:629; shipped models at
SpeechUT/dataset/MuSTC/*/spm_unigram10000.model and
SpeechLM/dataset/CommonVoice/.../spm_char_st_en_de.model).  The library is not
in this image, so this module reads the serialized ``ModelProto`` directly
(hand-rolled protobuf wire-format reader — the schema is public and tiny) and
implements the encoding algorithms:

- unigram: Viterbi segmentation maximizing the sum of piece log-probs,
- bpe: iterative best-scoring merge,
- char/word: trivial.

Normalization implements the common path (NFKC + whitespace -> ▁ with a dummy
prefix); exotic custom normalizer rules inside the model are not interpreted.
IDs match the C++ library for text covered by these rules (ASCII/latin ST/MT
sets here).
"""

from __future__ import annotations

import struct
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

WS = "▁"  # ▁

# SentencePiece piece types
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    val, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _skip(buf: bytes, i: int, wire: int) -> int:
    if wire == 0:
        _, i = _read_varint(buf, i)
    elif wire == 1:
        i += 8
    elif wire == 2:
        n, i = _read_varint(buf, i)
        i += n
    elif wire == 5:
        i += 4
    else:
        raise ValueError(f"bad wire type {wire}")
    return i


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value_or_span) over a message."""
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
            yield field, wire, val
        elif wire == 5:
            yield field, wire, buf[i : i + 4]
            i += 4
        elif wire == 1:
            yield field, wire, buf[i : i + 8]
            i += 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            yield field, wire, buf[i : i + n]
            i += n
        else:
            i = _skip(buf, i, wire)


@dataclass
class Piece:
    piece: str
    score: float
    type: int


class SentencePieceModel:
    """Reader/encoder for a serialized sentencepiece ModelProto."""

    def __init__(self, pieces: List[Piece], model_type: int = UNIGRAM,
                 add_dummy_prefix: bool = True):
        self.pieces = pieces
        self.model_type = model_type
        self.add_dummy_prefix = add_dummy_prefix
        self.piece_to_id: Dict[str, int] = {
            p.piece: i for i, p in enumerate(pieces)
        }
        self.unk_id = next(
            (i for i, p in enumerate(pieces) if p.type == UNKNOWN), 0
        )
        self._max_piece_len = max(
            (len(p.piece) for p in pieces
             if p.type in (NORMAL, USER_DEFINED)), default=1
        )

    # ------------------------------------------------------------------ load
    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            buf = f.read()
        pieces: List[Piece] = []
        model_type = UNIGRAM
        add_dummy_prefix = True
        for field, wire, val in _fields(buf):
            if field == 1 and wire == 2:  # SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for f2, w2, v2 in _fields(val):
                    if f2 == 1 and w2 == 2:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3 and w2 == 0:
                        ptype = v2
                pieces.append(Piece(piece, score, ptype))
            elif field == 2 and wire == 2:  # TrainerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3 and w2 == 0:  # model_type
                        model_type = v2
            elif field == 4 and wire == 2:  # NormalizerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 6 and w2 == 0:  # add_dummy_prefix
                        add_dummy_prefix = bool(v2)
        return cls(pieces, model_type, add_dummy_prefix)

    def __len__(self):
        return len(self.pieces)

    # ------------------------------------------------------------- normalize
    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())  # collapse whitespace
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", WS)

    # ---------------------------------------------------------------- encode
    def encode(self, text: str, out: str = "id"):
        s = self.normalize(text)
        if not s:
            return []
        if self.model_type == CHAR:
            pieces = list(s)
        elif self.model_type == BPE:
            pieces = self._encode_bpe(s)
        elif self.model_type == WORD:
            pieces = s.split(WS)
        else:
            pieces = self._encode_unigram(s)
        if out == "piece":
            return pieces
        return [self.piece_to_id.get(p, self.unk_id) for p in pieces]

    def decode(self, ids_or_pieces) -> str:
        pieces = [
            self.pieces[i].piece if isinstance(i, int) else i
            for i in ids_or_pieces
        ]
        text = "".join(
            p for p in pieces
            if self.piece_to_id.get(p) is None
            or self.pieces[self.piece_to_id[p]].type
            in (NORMAL, USER_DEFINED, BYTE)
            or p not in ("<s>", "</s>", "<pad>", "<unk>")
        )
        return text.replace(WS, " ").strip()

    def _encode_unigram(self, s: str) -> List[str]:
        """Viterbi: best segmentation under sum of piece scores; unseen single
        chars fall back to <unk> with a large penalty (C++ unk_penalty)."""
        n = len(s)
        UNK_SCORE = -20.0
        best = [(-1e30, -1)] * (n + 1)  # (score, prev_index)
        best[0] = (0.0, -1)
        starts: List[List[Tuple[int, float]]] = [[] for _ in range(n + 1)]
        for i in range(n):
            for j in range(i + 1, min(i + self._max_piece_len, n) + 1):
                pid = self.piece_to_id.get(s[i:j])
                if pid is not None and self.pieces[pid].type in (
                    NORMAL, USER_DEFINED
                ):
                    starts[i].append((j, self.pieces[pid].score))
            if not any(j == i + 1 for j, _ in starts[i]):
                starts[i].append((i + 1, UNK_SCORE))  # unk single char
        for i in range(n):
            if best[i][0] <= -1e30:
                continue
            for j, sc in starts[i]:
                cand = best[i][0] + sc
                if cand > best[j][0]:
                    best[j] = (cand, i)
        # backtrack
        out = []
        j = n
        while j > 0:
            i = best[j][1]
            out.append(s[i:j])
            j = i
        return out[::-1]

    def _encode_bpe(self, s: str) -> List[str]:
        symbols = list(s)
        while True:
            best_score, best_i = -1e30, -1
            for i in range(len(symbols) - 1):
                pid = self.piece_to_id.get(symbols[i] + symbols[i + 1])
                if pid is not None and self.pieces[pid].score > best_score:
                    best_score, best_i = self.pieces[pid].score, i
            if best_i < 0:
                break
            symbols[best_i : best_i + 2] = [
                symbols[best_i] + symbols[best_i + 1]
            ]
        return symbols
