"""Self-contained SentencePiece *unigram* model reader + encoder (port of
simple_multimodal_tpu/data/spm.py, stdlib only).

Reads a local ``.spm``/``spm.model`` file directly (the protobuf wire
format of sentencepiece's ModelProto is small and stable) and segments text
with the standard unigram Viterbi algorithm, with no network and no
sentencepiece wheel. Given the real DeBERTa ``spm.model`` (through
``spm_model_path``), token ids match HF's DebertaV2Tokenizer, which uses
raw sentencepiece ids with [PAD]=0 [CLS]=1 [SEP]=2 [UNK]=3.

Scope: unigram models without byte-fallback (DeBERTa/ALBERT/XLNet family).
Normalization implements the nmt_nfkc defaults that matter for these models:
NFKC, whitespace collapsing, dummy-prefix, space→▁.
"""
import struct
import unicodedata
from typing import Dict, List, Optional, Tuple

# SentencePiece piece types (sentencepiece.proto enum)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_SPACE = "▁"  # ▁
_UNK_PENALTY = 10.0  # sentencepiece kUnkPenalty


# ------------------------------------------------------------ wire format

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"Unsupported protobuf wire type {wire_type}")
    return pos


def _parse_sentence_piece(buf: bytes) -> Tuple[str, float, int]:
    """Parse one SentencePiece message: piece(1, str), score(2, float),
    type(3, enum; default NORMAL)."""
    piece, score, ptype = "", 0.0, NORMAL
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:
            n, pos = _read_varint(buf, pos)
            piece = buf[pos:pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wt == 5:
            score = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif field == 3 and wt == 0:
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wt)
    return piece, score, ptype


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """Extract the repeated ``pieces`` field (field 1) of a ModelProto."""
    pieces = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:
            n, pos = _read_varint(data, pos)
            pieces.append(_parse_sentence_piece(data[pos:pos + n]))
            pos += n
        else:
            pos = _skip_field(data, pos, wt)
    return pieces


def serialize_model_proto(pieces: List[Tuple[str, float, int]]) -> bytes:
    """Inverse of parse_model_proto — used to build test fixtures."""
    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    body = b""
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        msg = bytes([0x0A]) + varint(len(pb)) + pb
        msg += bytes([0x15]) + struct.pack("<f", score)
        msg += bytes([0x18]) + varint(ptype)
        body += bytes([0x0A]) + varint(len(msg)) + msg
    return body


# ---------------------------------------------------------------- encoder

class SentencePieceUnigram:
    """Unigram-LM segmentation over a parsed sentencepiece vocabulary.

    Matches sentencepiece's Viterbi decoder: best-scoring segmentation of
    the normalized text into vocabulary pieces; characters not covered by
    the vocabulary become <unk> at ``min_score − 10`` per char, with
    consecutive unknowns merged into one token (sentencepiece semantics).
    """

    def __init__(self, model_bytes: bytes):
        self.pieces = parse_model_proto(model_bytes)
        if not self.pieces:
            raise ValueError("No pieces found: not a sentencepiece model?")
        self.piece_to_id: Dict[str, int] = {}
        self._matchable: Dict[str, Tuple[int, float]] = {}
        self.unk_id = 0
        min_score = 0.0
        for i, (piece, score, ptype) in enumerate(self.pieces):
            self.piece_to_id.setdefault(piece, i)
            if ptype in (NORMAL, USER_DEFINED):
                self._matchable[piece] = (i, score)
                min_score = min(min_score, score)
            elif ptype == UNKNOWN:
                self.unk_id = i
        self.unk_score = min_score - _UNK_PENALTY
        self.max_piece_len = max((len(p) for p in self._matchable), default=1)

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceUnigram":
        with open(path, "rb") as f:
            return cls(f.read())

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    @staticmethod
    def normalize(text: str) -> str:
        text = unicodedata.normalize("NFKC", str(text))
        text = " ".join(text.split())  # collapse + strip whitespace
        if not text:
            return ""
        return _SPACE + text.replace(" ", _SPACE)  # dummy prefix + escape

    def encode(self, text: str) -> List[int]:
        s = self.normalize(text)
        n = len(s)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        best[0] = 0.0
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(i + self.max_piece_len, n)
            for j in range(i + 1, hi + 1):
                hit = self._matchable.get(s[i:j])
                if hit is not None:
                    pid, score = hit
                    cand = best[i] + score
                    if cand > best[j]:
                        best[j] = cand
                        back[j] = (i, pid)
            # single-char unknown fallback keeps the lattice connected
            cand = best[i] + self.unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, self.unk_id)

        ids: List[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            ids.append(pid)
            j = i
        ids.reverse()
        # merge consecutive unknowns (sentencepiece emits one <unk> per run)
        merged: List[int] = []
        for pid in ids:
            if pid == self.unk_id and merged and merged[-1] == self.unk_id:
                continue
            merged.append(pid)
        return merged
