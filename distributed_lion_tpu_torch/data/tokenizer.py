"""Tokenizers: port of ``distributed_lion_tpu/data/tokenizer.py``, the byte-level part.

:class:`ByteTokenizer` is the dependency-free tokenizer: 256 byte ids, then
BOS, EOS and PAD (a vocabulary of 259). :func:`load_tokenizer` returns it
for no name. The JAX package's other tokenizers (GPT-2 BPE ``bpe:``,
SentencePiece ``sp:`` / ``tokenizer.model``, ``tokenizer.json``, a local HF
cache) are not ported: a name raises (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional

UNPORTED_TOKENIZER = ("only the byte tokenizer is ported; bpe:, sp:, tokenizer.model, "
                      "tokenizer.json and HF-cache tokenizers are not (ROADMAP Queue 1 item 9)")


@dataclass(frozen=True)
class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255 are bytes, then specials."""

    bos_id: int = 256
    eos_id: int = 257
    pad_id: int = 258

    @property
    def vocab_size(self) -> int:
        return 259

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


def load_tokenizer(name_or_path: Optional[str]):
    """:class:`ByteTokenizer` for no name; any name raises."""
    if name_or_path:
        raise NotImplementedError(f"tokenizer {name_or_path!r}: {UNPORTED_TOKENIZER}")
    return ByteTokenizer()
