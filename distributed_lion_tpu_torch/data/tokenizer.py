"""Tokenizers: port of ``distributed_lion_tpu/data/tokenizer.py``.

:func:`load_tokenizer` resolves a name in the JAX package's order:

- no name → :class:`ByteTokenizer`, the dependency-free tokenizer: 256
  byte ids, then BOS, EOS and PAD (a vocabulary of 259);
- ``bpe:<dir>`` → the GPT-2 byte-level BPE (``data/bpe.py``);
- ``sp:<path>`` → the SentencePiece BPE reader (``data/spm.py``);
- a directory holding ``vocab.json`` and ``merges.txt`` → GPT-2 BPE;
- a ``*.model`` file, or a directory holding ``tokenizer.model`` →
  SentencePiece (a local Llama-2 or Mistral checkpoint's 32,000 pieces);
- a ``tokenizer.json`` file, or a directory holding one → the HF
  fast-tokenizer BPE reader (``data/hf_tokenizer_json.py``: Llama-3's
  128,256 ids, GPT-2's 50,257);
- what the JAX package hands to ``transformers.AutoTokenizer`` (a
  directory holding only ``tokenizer_config.json``, a name in the local HF
  hub cache) raises, naming ROADMAP Queue 1 item 9: those tokenizers load
  only through ``transformers``, which the port does not use (the GPU
  machine has none), and a silently different vocabulary would be worse
  than a refusal;
- any other name falls back to :class:`ByteTokenizer` with the JAX
  package's loud warning.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List, Optional

from distributed_lion_tpu_torch.train.journal import emit

TRANSFORMERS_ONLY = ("this tokenizer loads only through transformers.AutoTokenizer, which the "
                     "port does not use; give a tokenizer.model, a tokenizer.json or a "
                     "vocab.json + merges.txt directory (ROADMAP Queue 1 item 9)")


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
    from distributed_lion_tpu_torch.data.hf_tokenizer_json import TokenizerJSON
    from distributed_lion_tpu_torch.data.spm import SentencePieceTokenizer

    def has(name: str) -> bool:
        return os.path.isdir(name_or_path) and os.path.exists(os.path.join(name_or_path, name))

    if name_or_path.startswith("bpe:"):
        return BPETokenizer.load(name_or_path[len("bpe:"):])
    if name_or_path.startswith("sp:"):
        return SentencePieceTokenizer.load(name_or_path[len("sp:"):])
    if has("vocab.json") and has("merges.txt"):
        return BPETokenizer.load(name_or_path)
    if ((name_or_path.endswith(".model") and os.path.isfile(name_or_path))
            or has("tokenizer.model")):
        return SentencePieceTokenizer.load(name_or_path)
    if ((name_or_path.endswith("tokenizer.json") and os.path.isfile(name_or_path))
            or has("tokenizer.json")):
        return TokenizerJSON.load(name_or_path)
    if has("tokenizer_config.json") or _in_hf_cache(name_or_path):
        raise NotImplementedError(f"tokenizer {name_or_path!r}: {TRANSFORMERS_ONLY}")
    emit(f"[tokenizer] WARNING: could not resolve {name_or_path!r} to a real tokenizer "
         "(no vocab.json+merges.txt, tokenizer.model, tokenizer.json, or local HF cache) "
         "— falling back to the 259-id ByteTokenizer. A Llama/GPT-2 run with this vocab "
         "is almost certainly not what you want.", stderr=True)
    return ByteTokenizer()


def _in_hf_cache(name: str) -> bool:
    """Whether the local HF hub cache holds a model directory for ``name``
    (the JAX package would load its tokenizer from there)."""
    home = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                  "huggingface"), "hub")
    return os.path.isdir(os.path.join(home, "models--" + name.replace("/", "--")))
