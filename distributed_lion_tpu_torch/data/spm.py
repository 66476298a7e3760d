"""SentencePiece ``tokenizer.model`` reader and BPE encoder: port of ``distributed_lion_tpu/data/spm.py`` (framework-free, copied).

The reference tokenizes its SFT and DPO workloads with Llama's
SentencePiece tokenizer (``sft_llama2.py:157-158``, ``dpo_llama2.py:129-131``).
Without the ``sentencepiece`` package and without a network, this module
reads the serialized ``ModelProto`` itself (a protobuf wire-format walker:
the format is stable and public) and implements SentencePiece's *BPE*
encoding:

- whitespace is escaped to ``▁`` (U+2581) and a dummy prefix ``▁`` is
  prepended when the model's ``NormalizerSpec.add_dummy_prefix`` says so
  (Llama-2's does);
- adjacent symbols are merged greedily by *piece score* (highest first,
  leftmost on ties) while the concatenation is in the vocabulary, with a
  linked list and a lazy heap, so a whole document encodes in O(n log n)
  (SentencePiece does not pre-tokenize);
- characters that never reach a vocabulary piece fall back to the
  ``<0xXX>`` byte pieces when the model has them (Llama-2's
  ``byte_fallback``), else to ``unk_id``;
- CONTROL and UNKNOWN pieces (``<s>``, ``</s>``, ``<unk>``) are never
  produced from raw text; USER_DEFINED pieces are matched greedily before
  BPE, as SentencePiece treats them.

Llama-2's 32,000-piece model has exactly this shape. Ids are token for
token the JAX package's (``tests/test_torch_tokenizers.py``).
"""

from __future__ import annotations

import heapq
import os
import struct
from typing import Iterable, List, Optional, Tuple

_SPACE = "▁"  # '▁'

# SentencePiece.Type enum (sentencepiece_model.proto)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


# --------------------------------------------------------- protobuf wire walk

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) — value is int for varint,
    bytes for length-delimited, raw 4/8 bytes for fixed."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        else:  # groups (3/4) don't occur in sentencepiece_model.proto
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, v


def _parse_piece(buf: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, _NORMAL
    for field, wt, v in _fields(buf):
        if field == 1 and wt == 2:
            piece = v.decode("utf-8")
        elif field == 2 and wt == 5:
            score = struct.unpack("<f", v)[0]
        elif field == 3 and wt == 0:
            ptype = v
    return piece, score, ptype


def parse_model_proto(data: bytes) -> dict:
    """Serialized ``ModelProto`` → {pieces: [(piece, score, type)],
    model_type, add_dummy_prefix, unk/bos/eos/pad ids}."""
    pieces: List[Tuple[str, float, int]] = []
    out = {
        "model_type": 1,  # UNIGRAM default
        "add_dummy_prefix": True,
        "unk_id": 0, "bos_id": 1, "eos_id": 2, "pad_id": -1,
    }
    for field, wt, v in _fields(data):
        if field == 1 and wt == 2:  # repeated SentencePiece pieces
            pieces.append(_parse_piece(v))
        elif field == 2 and wt == 2:  # TrainerSpec
            for f2, wt2, v2 in _fields(v):
                if wt2 != 0:
                    continue
                # int32 negatives arrive 64-bit sign-extended; any of the
                # special-token ids may be -1 (= disabled) in a valid model
                v2s = v2 - (1 << 64) if v2 >= 1 << 63 else v2
                if f2 == 3:
                    out["model_type"] = v2s  # 1=unigram 2=bpe
                elif f2 == 40:
                    out["unk_id"] = v2s
                elif f2 == 41:
                    out["bos_id"] = v2s
                elif f2 == 42:
                    out["eos_id"] = v2s
                elif f2 == 43:
                    out["pad_id"] = v2s
        elif field == 3 and wt == 2:  # NormalizerSpec
            for f3, wt3, v3 in _fields(v):
                if f3 == 3 and wt3 == 0:
                    out["add_dummy_prefix"] = bool(v3)
    out["pieces"] = pieces
    return out


# ------------------------------------------------------------------ tokenizer

class SentencePieceTokenizer:
    """SentencePiece BPE over a serialized ``tokenizer.model``.

    API-compatible with data.tokenizer.ByteTokenizer (vocab_size,
    bos/eos/pad ids, encode/decode). Only BPE-type models are supported —
    Llama/Mistral ship BPE; a unigram model raises loudly rather than
    tokenizing wrong.
    """

    def __init__(self, proto: dict):
        if proto["model_type"] != 2:
            raise ValueError(
                "only SentencePiece BPE models are supported (this model is "
                f"type {proto['model_type']}; Llama's tokenizer.model is BPE)"
            )
        self.pieces = proto["pieces"]
        self.id_to_piece = [p for p, _, _ in self.pieces]
        self.piece_type = [t for _, _, t in self.pieces]
        # mergeable lookup: raw-text-reachable pieces only
        self._scores = {
            p: (s, i) for i, (p, s, t) in enumerate(self.pieces)
            if t in (_NORMAL, _USER_DEFINED)
        }
        self._byte_id = {}
        for i, (p, _, t) in enumerate(self.pieces):
            if t == _BYTE:  # '<0xXX>'
                self._byte_id[int(p[3:5], 16)] = i
        self._user_defined = sorted(
            (p for p, _, t in self.pieces if t == _USER_DEFINED),
            key=len, reverse=True,
        )
        self.add_dummy_prefix = proto["add_dummy_prefix"]
        self.unk_id = proto["unk_id"]
        self.bos_id = proto["bos_id"]
        self.eos_id = proto["eos_id"]
        self.pad_id = (proto["pad_id"] if proto["pad_id"] >= 0
                       else max(proto["eos_id"], 0))

    @classmethod
    def load(cls, path: str) -> "SentencePieceTokenizer":
        """``path``: a ``tokenizer.model`` file or a directory holding one."""
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.model")
        with open(path, "rb") as f:
            return cls(parse_model_proto(f.read()))

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # ------------------------------------------------------------------ encode
    def _merge(self, chars: List[str]) -> List[str]:
        """Greedy highest-score adjacent merge (leftmost on ties) — the
        SentencePiece BPE procedure, via linked list + lazy heap."""
        n = len(chars)
        if n < 2:
            return chars
        sym = list(chars)
        left = list(range(-1, n - 1))
        right = list(range(1, n + 1))
        alive = [True] * n
        rev = [0] * n
        heap: list = []

        def push(a: int, b: int) -> None:
            cand = sym[a] + sym[b]
            sc = self._scores.get(cand)
            if sc is not None:
                heapq.heappush(heap, (-sc[0], a, rev[a], rev[b], b))

        for i in range(n - 1):
            push(i, i + 1)
        while heap:
            _, a, ra, rb, b = heapq.heappop(heap)
            if not (alive[a] and alive[b]) or rev[a] != ra or rev[b] != rb:
                continue
            sym[a] += sym[b]
            rev[a] += 1
            alive[b] = False
            right[a] = right[b]
            if right[b] < n:
                left[right[b]] = a
            if left[a] >= 0:
                push(left[a], a)
            if right[a] < n:
                push(a, right[a])
        return [sym[i] for i in range(n) if alive[i]]

    def _piece_ids(self, piece: str, out: List[int]) -> None:
        sc = self._scores.get(piece)
        if sc is not None:
            out.append(sc[1])
        elif self._byte_id:
            for byte in piece.encode("utf-8"):
                out.append(self._byte_id.get(byte, self.unk_id))
        else:
            out.append(self.unk_id)

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        norm = text.replace(" ", _SPACE)
        if self.add_dummy_prefix and norm and not norm.startswith(_SPACE):
            norm = _SPACE + norm
        # a negative id means the model disables that special token
        ids: List[int] = [self.bos_id] if add_bos and self.bos_id >= 0 else []
        for chunk, literal in self._split_user_defined(norm):
            if literal:
                ids.append(self._scores[chunk][1])
            else:
                for piece in self._merge(list(chunk)):
                    self._piece_ids(piece, ids)
        if add_eos and self.eos_id >= 0:
            ids.append(self.eos_id)
        return ids

    def _split_user_defined(self, text: str):
        """Yield (chunk, is_literal): USER_DEFINED pieces match greedily
        before BPE, the rest is merged normally."""
        if not self._user_defined:
            yield text, False
            return
        i = 0
        start = 0
        while i < len(text):
            for ud in self._user_defined:
                if text.startswith(ud, i):
                    if start < i:
                        yield text[start:i], False
                    yield ud, True
                    i += len(ud)
                    start = i
                    break
            else:
                i += 1
        if start < len(text):
            yield text[start:], False

    # ------------------------------------------------------------------ decode
    def decode(self, ids: Iterable[int]) -> str:
        out: List[object] = []  # str pieces and int bytes, in order
        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.pieces):
                continue
            t = self.piece_type[i]
            if t in (_CONTROL, _UNKNOWN):
                continue
            p = self.id_to_piece[i]
            if t == _BYTE:
                out.append(int(p[3:5], 16))
            else:
                out.append(p)

        # fuse byte runs, decode utf-8, join pieces
        text_parts: List[str] = []
        run: List[int] = []
        for item in out:
            if isinstance(item, int):
                run.append(item)
            else:
                if run:
                    text_parts.append(bytes(run).decode("utf-8", "replace"))
                    run = []
                text_parts.append(item)
        if run:
            text_parts.append(bytes(run).decode("utf-8", "replace"))
        text = "".join(text_parts).replace(_SPACE, " ")
        if self.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text


def write_model_proto(pieces: List[Tuple[str, float, int]],
                      model_type: int = 2, add_dummy_prefix: bool = True,
                      unk_id: int = 0, bos_id: int = 1, eos_id: int = 2,
                      pad_id: int = -1) -> bytes:
    """Serialize a minimal ``ModelProto`` (the inverse of
    :func:`parse_model_proto`). Used by tests to build tiny models and by
    anyone who wants to ship a locally-trained SP-BPE vocabulary."""
    def varint(v: int) -> bytes:
        if v < 0:
            v += 1 << 64
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    def field(num: int, wt: int, payload: bytes) -> bytes:
        return varint(num << 3 | wt) + payload

    buf = bytearray()
    for piece, score, ptype in pieces:
        body = field(1, 2, varint(len(piece.encode())) + piece.encode())
        body += field(2, 5, struct.pack("<f", score))
        body += field(3, 0, varint(ptype))
        buf += field(1, 2, varint(len(body)) + body)
    trainer = (field(3, 0, varint(model_type)) + field(40, 0, varint(unk_id))
               + field(41, 0, varint(bos_id)) + field(42, 0, varint(eos_id))
               + field(43, 0, varint(pad_id)))
    buf += field(2, 2, varint(len(trainer)) + trainer)
    norm = field(3, 0, varint(1 if add_dummy_prefix else 0))
    buf += field(3, 2, varint(len(norm)) + norm)
    return bytes(buf)
