"""Tokenizers: port of ``distributed_lion_tpu/data/tokenizer.py``.

:func:`load_tokenizer` resolves a name as the JAX package does:

- no name → :class:`ByteTokenizer`, the dependency-free tokenizer: 256
  byte ids, then BOS, EOS and PAD (a vocabulary of 259);
- ``bpe:<dir>``, or a directory holding ``vocab.json`` and ``merges.txt``
  → the GPT-2 byte-level BPE (``data/bpe.py``);
- ``sp:<path>``, a ``*.model`` file or a directory holding
  ``tokenizer.model`` (SentencePiece), a ``tokenizer.json`` (an HF fast
  tokenizer), and what the JAX package hands to ``transformers`` (a
  directory holding ``tokenizer_config.json``, a name in the local HF hub
  cache) are not ported and raise, naming ROADMAP Queue 1 item 9: a
  silently different vocabulary would be worse than a refusal;
- any other name falls back to :class:`ByteTokenizer` with the JAX
  package's loud warning.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Iterable, List, Optional

UNPORTED_TOKENIZER = ("the byte and GPT-2 BPE (bpe:) tokenizers are ported; SentencePiece "
                      "(sp:, *.model, tokenizer.model), tokenizer.json and HF-cache "
                      "tokenizers are not (ROADMAP Queue 1 item 9)")


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
    """The tokenizer of ``name_or_path`` (see the module doc)."""
    if not name_or_path:
        return ByteTokenizer()
    from distributed_lion_tpu_torch.data.bpe import BPETokenizer

    def has(name: str) -> bool:
        return os.path.isdir(name_or_path) and os.path.exists(os.path.join(name_or_path, name))

    if name_or_path.startswith("bpe:"):
        return BPETokenizer.load(name_or_path[len("bpe:"):])
    if has("vocab.json") and has("merges.txt"):
        return BPETokenizer.load(name_or_path)
    if (name_or_path.startswith("sp:")
            or (name_or_path.endswith(".model") and os.path.isfile(name_or_path))
            or has("tokenizer.model")
            or (name_or_path.endswith("tokenizer.json") and os.path.isfile(name_or_path))
            or has("tokenizer.json")):
        raise NotImplementedError(f"tokenizer {name_or_path!r}: {UNPORTED_TOKENIZER}")
    if has("tokenizer_config.json") or _in_hf_cache(name_or_path):
        raise NotImplementedError(f"tokenizer {name_or_path!r} through transformers: "
                                  f"{UNPORTED_TOKENIZER}")
    print(f"[tokenizer] WARNING: could not resolve {name_or_path!r} to a real tokenizer "
          "(no vocab.json+merges.txt, tokenizer.model, tokenizer.json, or local HF cache) "
          "— falling back to the 259-id ByteTokenizer. A Llama/GPT-2 run with this vocab "
          "is almost certainly not what you want.", file=sys.stderr, flush=True)
    return ByteTokenizer()


def _in_hf_cache(name: str) -> bool:
    """Whether the local HF hub cache holds a model directory for ``name``
    (the JAX package would load its tokenizer from there)."""
    home = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                  "huggingface"), "hub")
    return os.path.isdir(os.path.join(home, "models--" + name.replace("/", "--")))
