"""Pure-Python SentencePiece unigram tokenizer (no `sentencepiece` wheel).

Counterpart of `clip_diffusion_tpu.text.spm`, kept as a copy of its own:
the sentence-T5 and MarianMT tokenizers load their SentencePiece models
through it when the assets exist.  It holds no tensors.

* a minimal protobuf wire-format reader and writer for the SentencePiece
  `ModelProto` (pieces, scores, types and the trainer-spec special-token
  ids): enough to load real `spiece.model` / `source.spm` assets and to
  write real-format fixtures for tests;
* the unigram-LM Viterbi segmenter with sentencepiece's default runtime
  semantics: NFKC normalization, extra-whitespace removal, dummy prefix and
  `▁` whitespace escaping, the min_score - 10 unknown penalty, fused runs
  of unknown characters, and byte fallback when the model has byte pieces.

The `precompiled_charsmap` normalizer (a compiled Darts trie in
NormalizerSpec) is not executed: plain NFKC covers it for ordinary prompt
text; rare compatibility characters may normalize differently.
"""

from __future__ import annotations

import io
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

# SentencePiece.Type enum (sentencepiece_model.proto)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6

_UNK_PENALTY = 10.0  # kUnkPenalty in sentencepiece's unigram model
WS = "▁"  # ▁ escaped whitespace


# --------------------------------------------------------------------------
# protobuf wire format (minimal: varint + 32-bit + length-delimited)
# --------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: memoryview, pos: int, wire_type: int) -> int:
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
        raise ValueError(f"unsupported protobuf wire type {wire_type}")
    return pos


def _iter_fields(data: bytes):
    buf = memoryview(data)
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire_type = tag >> 3, tag & 7
        if wire_type == 0:
            val, pos = _read_varint(buf, pos)
        elif wire_type == 5:
            val = bytes(buf[pos : pos + 4])
            pos += 4
        elif wire_type == 1:
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wire_type == 2:
            n, pos = _read_varint(buf, pos)
            val = bytes(buf[pos : pos + n])
            pos += n
        else:
            pos = _skip_field(buf, pos, wire_type)
            continue
        yield field, wire_type, val


def _parse_piece(data: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, NORMAL
    for field, wt, val in _iter_fields(data):
        if field == 1 and wt == 2:
            piece = val.decode("utf-8")
        elif field == 2 and wt == 5:
            score = struct.unpack("<f", val)[0]
        elif field == 3 and wt == 0:
            ptype = val
    return piece, score, ptype


def _parse_trainer_spec(data: bytes) -> Dict[str, int]:
    # unk_id=40 bos_id=41 eos_id=42 pad_id=43 (sentencepiece_model.proto)
    ids = {}
    names = {40: "unk_id", 41: "bos_id", 42: "eos_id", 43: "pad_id"}
    for field, wt, val in _iter_fields(data):
        if field in names and wt == 0:
            # ids are int32; -1 arrives as a 64-bit twos-complement varint
            ids[names[field]] = val - (1 << 64) if val >= (1 << 63) else val
    return ids


def parse_model(data: bytes) -> Tuple[List[Tuple[str, float, int]], Dict]:
    """ModelProto bytes -> (pieces [(text, score, type)], meta ids)."""
    pieces: List[Tuple[str, float, int]] = []
    meta: Dict = {}
    for field, wt, val in _iter_fields(data):
        if field == 1 and wt == 2:  # repeated SentencePiece pieces
            pieces.append(_parse_piece(val))
        elif field == 2 and wt == 2:  # TrainerSpec
            meta.update(_parse_trainer_spec(val))
    return pieces, meta


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def write_model(
    pieces: Sequence[Tuple[str, float, int]],
    unk_id: int = 0,
    bos_id: int = -1,
    eos_id: int = -1,
    pad_id: int = -1,
) -> bytes:
    """Serialize a REAL-format SentencePiece ModelProto (fixture writer —
    output loads in the official `sentencepiece` wheel too)."""
    out = io.BytesIO()
    for piece, score, ptype in pieces:
        body = io.BytesIO()
        raw = piece.encode("utf-8")
        body.write(_tag(1, 2) + _varint(len(raw)) + raw)
        body.write(_tag(2, 5) + struct.pack("<f", score))
        body.write(_tag(3, 0) + _varint(ptype))
        msg = body.getvalue()
        out.write(_tag(1, 2) + _varint(len(msg)) + msg)
    spec = io.BytesIO()
    for field, value in ((40, unk_id), (41, bos_id), (42, eos_id),
                         (43, pad_id)):
        enc = value if value >= 0 else value + (1 << 64)
        spec.write(_tag(field, 0) + _varint(enc))
    msg = spec.getvalue()
    out.write(_tag(2, 2) + _varint(len(msg)) + msg)
    return out.getvalue()


# --------------------------------------------------------------------------
# unigram Viterbi segmenter
# --------------------------------------------------------------------------

class SPMUnigram:
    """SentencePiece unigram model with the official runtime defaults."""

    def __init__(self, pieces: Sequence[Tuple[str, float, int]],
                 meta: Optional[Dict] = None):
        self.pieces = list(pieces)
        meta = meta or {}
        self.vocab: Dict[str, int] = {}
        self.scores: List[float] = []
        self.types: List[int] = []
        self.byte_ids: Dict[int, int] = {}
        unk_from_type = None
        for i, (piece, score, ptype) in enumerate(self.pieces):
            self.vocab[piece] = i
            self.scores.append(score)
            self.types.append(ptype)
            if ptype == UNKNOWN and unk_from_type is None:
                unk_from_type = i
            if ptype == BYTE:
                self.byte_ids[int(piece[1:-1], 16)] = i  # "<0xAB>"
        self.unk_id = meta.get("unk_id", unk_from_type or 0)
        self.bos_id = meta.get("bos_id", -1)
        self.eos_id = meta.get("eos_id", -1)
        self.pad_id = meta.get("pad_id", -1)
        self.byte_fallback = bool(self.byte_ids)
        scorable = [
            s for s, t in zip(self.scores, self.types)
            if t not in (UNKNOWN, CONTROL)
        ]
        self._min_score = min(scorable) if scorable else 0.0
        self._max_piece_len = max(
            (len(p) for p, _, t in self.pieces if t in (NORMAL, USER_DEFINED)),
            default=1,
        )

    @classmethod
    def load(cls, path: str) -> "SPMUnigram":
        with open(path, "rb") as f:
            return cls(*parse_model(f.read()))

    # -- normalization (nmt_nfkc defaults + dummy prefix + escaping) -------
    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        # nmt_nfkc: ALL whitespace -> space (incl. tab/newline/CR, which
        # are category Cc — check isspace first or they'd be dropped and
        # words across line breaks would fuse); remaining control chars
        # (Cc/Cf) -> drop
        chars = []
        for ch in text:
            if ch.isspace():
                chars.append(" ")
            elif unicodedata.category(ch) in ("Cc", "Cf"):
                continue
            else:
                chars.append(ch)
        text = "".join(chars)
        text = " ".join(text.split())  # remove_extra_whitespaces
        if not text:
            return ""
        return WS + text.replace(" ", WS)  # add_dummy_prefix + escape

    # -- Viterbi -----------------------------------------------------------
    def _viterbi(self, s: str) -> List[int]:
        """Best segmentation of the normalized string -> piece ids
        (unk runs fused; byte fallback when the model carries byte
        pieces)."""
        n = len(s)
        # best[i]: (score, prev_index, piece_id or -1 for unk-char)
        NEG = float("-inf")
        best = [(NEG, -1, -1)] * (n + 1)
        best[0] = (0.0, -1, -1)
        unk_score = self._min_score - _UNK_PENALTY
        for i in range(n):
            score_i = best[i][0]
            if score_i == NEG:
                continue
            # known pieces starting at i
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                pid = self.vocab.get(s[i:j])
                if pid is None or self.types[pid] in (UNKNOWN, CONTROL,
                                                      UNUSED, BYTE):
                    continue
                cand = score_i + self.scores[pid]
                if cand > best[j][0]:
                    best[j] = (cand, i, pid)
            # single-char unknown edge
            j = i + 1
            cand = score_i + unk_score
            if cand > best[j][0]:
                best[j] = (cand, i, -1)
        # backtrack
        segments: List[Tuple[int, int, int]] = []  # (start, end, pid)
        pos = n
        while pos > 0:
            _, prev, pid = best[pos]
            segments.append((prev, pos, pid))
            pos = prev
        segments.reverse()
        # fuse consecutive unknowns (sentencepiece merges adjacent unk
        # surface into one <unk> token), or expand to byte pieces
        ids: List[int] = []
        i = 0
        while i < len(segments):
            start, end, pid = segments[i]
            if pid >= 0:
                ids.append(pid)
                i += 1
                continue
            j = i
            while j < len(segments) and segments[j][2] < 0:
                j += 1
            surface = s[start : segments[j - 1][1]]
            if self.byte_fallback:
                ids.extend(
                    self.byte_ids[b] for b in surface.encode("utf-8")
                )
            else:
                ids.append(self.unk_id)
            i = j
        return ids

    def encode_as_ids(self, text: str) -> List[int]:
        s = self.normalize(text)
        return self._viterbi(s) if s else []

    def encode_as_pieces(self, text: str) -> List[str]:
        return [self.pieces[i][0] for i in self.encode_as_ids(text)]

    # official-wheel-compatible method aliases (drop-in for
    # sentencepiece.SentencePieceProcessor at the two call sites)
    def EncodeAsIds(self, text: str) -> List[int]:  # noqa: N802
        return self.encode_as_ids(text)

    def EncodeAsPieces(self, text: str) -> List[str]:  # noqa: N802
        return self.encode_as_pieces(text)

    def decode_ids(self, ids: Sequence[int]) -> str:
        out = []
        byte_run = bytearray()

        def flush():
            if byte_run:
                out.append(byte_run.decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            if i in (self.bos_id, self.eos_id, self.pad_id):
                continue
            piece, _, ptype = self.pieces[i]
            if ptype == BYTE:
                byte_run.append(int(piece[1:-1], 16))
                continue
            flush()
            if ptype == UNKNOWN:
                out.append(" ⁇ ")  # sentencepiece unk surface
            elif ptype != CONTROL:
                out.append(piece)
        flush()
        return "".join(out).replace(WS, " ").strip()


def load_unigram(path: str) -> SPMUnigram:
    return SPMUnigram.load(path)
