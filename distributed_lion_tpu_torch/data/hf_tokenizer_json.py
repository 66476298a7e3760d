"""Reader for HF fast-tokenizer ``tokenizer.json`` files (BPE models): port of ``distributed_lion_tpu/data/hf_tokenizer_json.py``.

Llama-3-, Mistral- and GPT-2-class checkpoints ship their tokenizer as one
``tokenizer.json`` (the HF ``tokenizers`` serialization) instead of
SentencePiece's ``tokenizer.model``. The reference reaches these through
``AutoTokenizer`` (``sft_llama2.py:157-158``); this module reads the file
itself, so a local checkpoint tokenizes with its own vocabulary (128,256
for Llama-3) without ``transformers``.

The supported shape, the one Llama-3, GPT-2 and Qwen-class models use:

- ``model.type == "BPE"`` with ``vocab`` (token → id) and ranked ``merges``;
- the byte-level alphabet (GPT-2's byte → unicode table, from ``data/bpe.py``);
- pre-tokenization: the regex of a ``Split`` pre-tokenizer (a tiktoken-style
  pattern, compiled with the ``regex`` module) and/or ``ByteLevel``; a
  ``Sequence`` of those is walked recursively;
- ``added_tokens`` (specials such as ``<|begin_of_text|>``) matched greedily
  before pre-tokenization, never split.

The merges run in ``data/bpe.py``'s machinery (its C++ core where it
builds). Anything outside this shape (WordPiece or Unigram models,
Metaspace pre-tokenizers, normalizers that rewrite text) raises instead of
tokenizing wrong. Ids are token for token the JAX package's and the
``tokenizers`` library's (``tests/test_torch_tokenizers.py``).
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional

from distributed_lion_tpu_torch.data.bpe import (
    BPETokenizer,
    bytes_to_unicode,
    unicode_to_bytes,
)

try:
    import regex as _re
except ImportError:  # pragma: no cover
    _re = None

# GPT-2's pattern, the ByteLevel pre-tokenizer's built-in default
# (used when use_regex=true and no Split supplies one)
_BYTELEVEL_PAT = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
                  r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")


def _collect_pretokenizers(pt: Optional[dict], out: List[dict]) -> None:
    if pt is None:
        return
    t = pt.get("type")
    if t == "Sequence":
        for sub in pt.get("pretokenizers", []):
            _collect_pretokenizers(sub, out)
    else:
        out.append(pt)


class TokenizerJSON:
    """Byte-level BPE driven by a ``tokenizer.json`` file.

    API-compatible with data.tokenizer.ByteTokenizer (vocab_size,
    bos/eos/pad ids, encode/decode).
    """

    def __init__(self, spec: dict):
        if _re is None:
            raise RuntimeError("the `regex` module is required")
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise ValueError(
                f"unsupported tokenizer.json model type {model.get('type')!r} "
                "(only BPE is implemented)"
            )
        if spec.get("normalizer") is not None:
            raise ValueError(
                "tokenizer.json has a normalizer; this reader supports the "
                "byte-level-BPE shape (Llama-3/GPT-2) which has none"
            )
        self.vocab: dict = dict(model["vocab"])
        pairs = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                 for m in (model.get("merges") or [])]
        self.ranks = {p: i for i, p in enumerate(pairs)}

        pres: List[dict] = []
        _collect_pretokenizers(spec.get("pre_tokenizer"), pres)
        pattern = None
        add_prefix_space = False
        byte_level = False
        for pt in pres:
            t = pt["type"]
            if t == "Split":
                pat = pt.get("pattern", {})
                pattern = pat.get("Regex") if isinstance(pat, dict) else None
                if pattern is None:
                    raise ValueError("Split pre-tokenizer without a Regex "
                                     "pattern is not supported")
                if pt.get("invert"):
                    raise ValueError("inverted Split is not supported")
            elif t == "ByteLevel":
                byte_level = True
                add_prefix_space = bool(pt.get("add_prefix_space", False))
                if pt.get("use_regex", True) and pattern is None:
                    pattern = _BYTELEVEL_PAT
            else:
                raise ValueError(f"unsupported pre-tokenizer {t!r}")
        if not byte_level:
            raise ValueError("only byte-level BPE tokenizer.json files are "
                             "supported (no ByteLevel pre-tokenizer found)")
        self._pat = _re.compile(pattern) if pattern else None
        self._add_prefix_space = add_prefix_space

        self.added: dict = {}  # content -> id
        self.special_ids: set = set()
        for at in spec.get("added_tokens", []):
            self.added[at["content"]] = int(at["id"])
            if at.get("special"):
                self.special_ids.add(int(at["id"]))
            self.vocab.setdefault(at["content"], int(at["id"]))
        # one alternation, longest first (same-position ties go to the
        # earlier alternative, so longest-match greediness is preserved) —
        # NOT a per-character startswith scan over |added| tokens
        self._added_re = _re.compile(
            "|".join(_re.escape(t)
                     for t in sorted(self.added, key=len, reverse=True))
        ) if self.added else None
        self._added_ids = set(self.added.values())

        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self._b2u = bytes_to_unicode()
        self._u2b = unicode_to_bytes()
        # the merge loop (and its C++ native core) live in BPETokenizer;
        # specials=[] because added tokens are handled here, before BPE
        self._core = BPETokenizer(self.vocab, pairs, specials=[])

        def find(*names):
            for n in names:
                if n in self.added:
                    return self.added[n]
            return None

        self.bos_id = find("<|begin_of_text|>", "<s>", "<|endoftext|>")
        self.eos_id = find("<|end_of_text|>", "<|eot_id|>", "</s>",
                           "<|endoftext|>")
        if self.eos_id is None:
            self.eos_id = self.bos_id if self.bos_id is not None else 0
        if self.bos_id is None:
            self.bos_id = self.eos_id
        pad = find("<pad>", "<|finetune_right_pad_id|>")
        self.pad_id = pad if pad is not None else self.eos_id

    @classmethod
    def load(cls, path: str) -> "TokenizerJSON":
        """``path``: a ``tokenizer.json`` file or a directory holding one."""
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    @property
    def vocab_size(self) -> int:
        return max(len(self.vocab), 1 + max(self.vocab.values(), default=0))

    # ------------------------------------------------------------------ codec
    def _encode_chunk(self, text: str, ids: List[int]) -> None:
        """Pre-tokenize with OUR pattern, merge via the shared BPETokenizer
        machinery (C++ native core when buildable, its cached Python merge
        loop otherwise)."""
        if not text:
            return
        pretoks = self._pat.findall(text) if self._pat else [text]
        core = self._core._native_core()
        if core is not None:
            ids.extend(
                core.encode_pretoks([t.encode("utf-8") for t in pretoks])
                .tolist())
            return
        for tok in pretoks:
            mapped = "".join(self._b2u[b] for b in tok.encode("utf-8"))
            for piece in self._core._bpe(mapped):
                ids.append(self.vocab[piece])

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        if self._add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        ids: List[int] = [self.bos_id] if add_bos else []
        # added tokens match greedily before pre-tokenization
        start = 0
        if self._added_re is not None:
            for m in self._added_re.finditer(text):
                self._encode_chunk(text[start:m.start()], ids)
                ids.append(self.added[m.group()])
                start = m.end()
        self._encode_chunk(text[start:], ids)
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        # NB: no prefix-space stripping — the `tokenizers` ByteLevel decoder
        # maps chars back to bytes verbatim, so decode(encode(' x')) keeps
        # the genuine leading space and round-trips
        parts: List[str] = []
        for i in ids:
            i = int(i)
            if i in self.special_ids or i not in self.inv_vocab:
                continue
            tok = self.inv_vocab[i]
            if i in self._added_ids:
                parts.append(tok)
            else:
                parts.append(bytes(self._u2b[c] for c in tok if c in self._u2b)
                             .decode("utf-8", "replace"))
        return "".join(parts)


def bpe_tokenizer_json(tok: BPETokenizer) -> dict:
    """The ``tokenizer.json`` spec of a GPT-2 byte-level BPE (``data/bpe.py``):
    its vocabulary and ranked merges under a ``ByteLevel`` pre-tokenizer and
    decoder, its specials as ``added_tokens``. The ``tokenizers`` library and
    :class:`TokenizerJSON` both load it, and encode text without specials to
    ``tok``'s ids."""
    specials = sorted(tok._special_ids)
    merges = [f"{a} {b}" for (a, b), _ in sorted(tok.ranks.items(), key=lambda kv: kv[1])]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": tok.inv_vocab[i], "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": False,
                          "special": True} for i in specials],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                          "trim_offsets": True, "use_regex": True},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": {t: i for t, i in tok.vocab.items() if i not in tok._special_ids},
                  "merges": merges},
    }
