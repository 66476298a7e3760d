"""GPT-2 byte-level BPE: port of ``distributed_lion_tpu/data/bpe.py`` (framework-free, copied).

The published GPT-2 algorithm over HF-format ``vocab.json`` + ``merges.txt``
files: the byte ↔ unicode table, the pre-tokenization pattern and the
ranked merges. ``encode`` pre-tokenizes with the ``regex`` module and
merges in C++ (``native/bpe_core.cc``, built at first use) when a
compiler is present, else in Python; both give the same ids, pinned
against each other and against the JAX package. ``DLION_NATIVE_BPE=0``
keeps a tokenizer on the Python path. Learning a vocabulary
(``train_bpe``) is tooling that is not ported (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Iterable, List, Optional

import numpy as np

try:  # \p{L}/\p{N} need the `regex` module
    import regex as _re
except ImportError:  # pragma: no cover
    _re = None

# GPT-2's pre-tokenization pattern, verbatim
_PAT = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
        r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")

END_OF_TEXT = "<|endoftext|>"


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict:
    """GPT-2's reversible byte → printable-unicode map: the 188 visible
    bytes map to themselves, the others shift up by 256."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


@lru_cache(maxsize=1)
def unicode_to_bytes() -> dict:
    return {v: k for k, v in bytes_to_unicode().items()}


def _get_pairs(word: tuple) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class _NativeCore:
    """ctypes bridge to the C++ merge core: the vocabulary lowered to raw
    byte strings indexed by id and the merges to (left id, right id) pairs
    in rank order, once; then one C call per document over its
    pre-tokenized bytes."""

    def __init__(self, vocab: dict, ranks: dict):
        import ctypes

        from distributed_lion_tpu_torch import native

        self._lib = native.load_bpe()
        n = 1 + max(vocab.values(), default=-1)
        if n > 4 * max(len(vocab), 1):
            raise ValueError("native BPE: vocab id space too sparse")
        by_id: List[Optional[str]] = [None] * n
        for t, i in vocab.items():
            if not (0 <= i < n) or by_id[i] is not None:
                raise ValueError("native BPE needs unique, non-negative vocab ids")
            by_id[i] = t
        u2b = unicode_to_bytes()

        def raw(tok: Optional[str]) -> bytes:
            if tok is None:  # a hole in the id space: unreachable
                return b""
            try:
                return bytes(u2b[c] for c in tok)
            except KeyError:  # specials outside the byte alphabet
                return tok.encode("utf-8")

        blobs = [raw(t) for t in by_id]
        off = np.zeros(n + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=off[1:])
        ordered = sorted(ranks.items(), key=lambda kv: kv[1])
        pairs = np.asarray([[vocab[a], vocab[b]] for (a, b), _ in ordered],
                           np.int32).reshape(-1)
        self._blob = np.frombuffer(b"".join(blobs), np.uint8).copy()
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        self._c = (c_u8p, c_i64p, c_i32p)
        handle = self._lib.bpe_new(
            self._blob.ctypes.data_as(c_u8p), off.ctypes.data_as(c_i64p), n,
            pairs.ctypes.data_as(c_i32p) if pairs.size else
            np.zeros(1, np.int32).ctypes.data_as(c_i32p), len(ordered))
        if not handle:
            raise RuntimeError(f"bpe_new failed: {self._lib.bpe_last_error().decode()}")
        self._h = handle

    def encode_pretoks(self, pretoks: List[bytes]) -> np.ndarray:
        """Pre-token byte strings → int32 ids, in one C call."""
        c_u8p, c_i64p, c_i32p = self._c
        blob = b"".join(pretoks)
        buf = np.frombuffer(blob, np.uint8)
        off = np.zeros(len(pretoks) + 1, np.int64)
        np.cumsum([len(p) for p in pretoks], out=off[1:])
        cap = len(blob) + 8  # merges only shrink the per-byte id sequence
        out = np.empty(cap, np.int32)
        k = self._lib.bpe_encode(
            self._h, buf.ctypes.data_as(c_u8p) if buf.size else
            np.zeros(1, np.uint8).ctypes.data_as(c_u8p),
            off.ctypes.data_as(c_i64p), len(pretoks), out.ctypes.data_as(c_i32p), cap)
        if k < 0:
            raise RuntimeError(f"bpe_encode needs {-k} slots, had {cap}")
        return out[:k]

    def __del__(self):  # pragma: no cover
        try:
            self._lib.bpe_free(self._h)
        except Exception:
            pass


class BPETokenizer:
    """Byte-level BPE over a ``vocab.json`` (token → id) and ranked
    ``merges.txt``; the :class:`data.tokenizer.ByteTokenizer` interface."""

    def __init__(self, vocab: dict, merges: List[tuple], specials: Optional[List[str]] = None):
        if _re is None:
            raise RuntimeError("the `regex` module is required for GPT-2 BPE")
        self.vocab = dict(vocab)
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        specials = [END_OF_TEXT] if specials is None else specials
        for s in specials:
            if s not in self.vocab:
                self.vocab[s] = len(self.vocab)
        self._special_ids = {self.vocab[s] for s in specials if s in self.vocab}
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self._pat = _re.compile(_PAT)
        self._cache: dict = {}
        self._native: object = None  # _NativeCore, False (unavailable), or None (untried)
        self.eos_id = self.vocab.get(END_OF_TEXT, len(self.vocab) - 1)
        self.bos_id = self.eos_id  # GPT-2: <|endoftext|> is both
        self.pad_id = self.eos_id

    def _native_core(self) -> Optional[_NativeCore]:
        """The C++ merge core, built at first use; any failure (no compiler,
        ids too sparse) keeps this tokenizer on the Python path."""
        if self._native is None:
            if os.environ.get("DLION_NATIVE_BPE", "1") == "0":
                self._native = False
            else:
                try:
                    self._native = _NativeCore(self.vocab, self.ranks)
                except Exception:
                    self._native = False
        return self._native or None

    @property
    def native(self) -> bool:
        """True when ``encode`` merges in C++."""
        return self._native_core() is not None

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = _get_pairs(word)
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        result = list(word)
        if len(self._cache) < 65536:
            self._cache[token] = result
        return result

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        core = self._native_core()
        if core is not None:
            pretoks = [t.encode("utf-8") for t in self._pat.findall(text)]
            body = core.encode_pretoks(pretoks).tolist() if pretoks else []
            return ([self.bos_id] if add_bos else []) + body + ([self.eos_id] if add_eos else [])
        b2u = bytes_to_unicode()
        ids: List[int] = [self.bos_id] if add_bos else []
        for tok in self._pat.findall(text):
            mapped = "".join(b2u[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[piece] for piece in self._bpe(mapped))
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        u2b = unicode_to_bytes()
        text = "".join(self.inv_vocab[int(i)] for i in ids
                       if int(i) in self.inv_vocab and int(i) not in self._special_ids)
        return bytes(u2b[c] for c in text if c in u2b).decode("utf-8", errors="replace")

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        """Load ``vocab.json`` + ``merges.txt`` from a directory."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False, allow_nan=False)
        ordered = sorted(self.ranks.items(), key=lambda kv: kv[1])
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in ordered:
                f.write(f"{a} {b}\n")
