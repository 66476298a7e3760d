"""Token sources and the batch iterator: port of ``distributed_lion_tpu/data/sources.py``.

Framework-free numpy, copied so the port needs nothing of the JAX package:

- :func:`synthetic_lm_dataset` — a learnable synthetic language;
- :func:`tokens_from_text_files` — local text through a tokenizer
  (``data/tokenizer.load_tokenizer``: bytes, or GPT-2 BPE) into
  ``group_texts`` blocks, each file one document ending in EOS;
- :class:`TokenDataset` — pre-tokenized ``.bin`` (uint16/uint32 memmap)
  and ``.npy`` block datasets;
- :class:`BatchIterator` — epoch-shuffled, drop-last global batches, with
  :meth:`BatchIterator.skip` for a resume.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from distributed_lion_tpu_torch.data.packing import group_texts
from distributed_lion_tpu_torch.data.tokenizer import load_tokenizer


def synthetic_lm_dataset(n_blocks: int, block_size: int, vocab_size: int,
                         seed: int = 0) -> np.ndarray:
    """Sequences with short-range structure (next ≈ prev + small noise mod V)
    so a real LM's loss falls measurably below uniform."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab_size, size=(n_blocks, 1))
    steps = rng.integers(-2, 3, size=(n_blocks, block_size - 1))
    toks = np.concatenate([start, steps], axis=1).cumsum(axis=1) % vocab_size
    return toks.astype(np.int32)


def tokens_from_text_files(paths: Sequence[str | pathlib.Path], block_size: int,
                           tokenizer_name: str | None = None) -> np.ndarray:
    """int32 ``[n_blocks, block_size]`` blocks of the files' text."""
    tok = load_tokenizer(tokenizer_name)
    docs = []
    for p in paths:
        text = pathlib.Path(p).read_text(encoding="utf-8", errors="replace")
        docs.append(tok.encode(text, add_eos=True))
    return group_texts(docs, block_size)


@dataclass
class TokenDataset:
    """Memory-mapped pre-tokenized dataset cut into fixed blocks."""

    blocks: np.ndarray  # [n, block_size] (or memmap view)

    @staticmethod
    def from_bin(path, block_size: int, dtype=np.uint16) -> "TokenDataset":
        flat = np.memmap(path, dtype=dtype, mode="r")
        n = len(flat) // block_size
        return TokenDataset(flat[: n * block_size].reshape(n, block_size))

    @staticmethod
    def from_npy(path) -> "TokenDataset":
        return TokenDataset(np.load(path, mmap_mode="r"))

    def __len__(self) -> int:
        return len(self.blocks)


class BatchIterator:
    """[global_batch, block] int32 batches, reshuffled each epoch, drop-last.
    ``epochs=None`` cycles forever. :meth:`skip` fast-forwards by index
    arithmetic alone (a permutation draw per skipped epoch, no data read),
    so ``skip(k)`` then ``next()`` yields the (k+1)-th ``next()`` of a fresh
    iterator."""

    def __init__(self, blocks: np.ndarray, global_batch: int, *,
                 seed: int = 0, epochs: int | None = None,
                 shuffle: bool = True):
        self._blocks = blocks
        self._gb = int(global_batch)
        n = len(blocks)
        if n < self._gb:
            raise ValueError(f"dataset has {n} blocks < global batch {global_batch}")
        self._n = n
        self._rng = np.random.default_rng(seed)
        self._epochs = epochs
        self._shuffle = shuffle
        self._epoch = 0
        self._order: np.ndarray | None = None
        self._i = 0

    def __iter__(self) -> "BatchIterator":
        return self

    def _ensure_order(self) -> None:
        if self._order is None:
            self._order = (self._rng.permutation(self._n) if self._shuffle
                           else np.arange(self._n))
            self._i = 0

    def _advance_epoch(self) -> None:
        self._epoch += 1
        self._order = None

    def __next__(self) -> np.ndarray:
        while True:
            if self._epochs is not None and self._epoch >= self._epochs:
                raise StopIteration
            self._ensure_order()
            if self._i + self._gb <= self._n:
                idx = self._order[self._i : self._i + self._gb]
                self._i += self._gb
                return np.ascontiguousarray(self._blocks[idx]).astype(np.int32)
            self._advance_epoch()

    def skip(self, k: int) -> None:
        """Fast-forward ``k`` batches without touching the data."""
        while k > 0:
            if self._epochs is not None and self._epoch >= self._epochs:
                return
            self._ensure_order()
            avail = (self._n - self._i) // self._gb
            take = min(k, avail)
            self._i += take * self._gb
            k -= take
            if (self._n - self._i) < self._gb:
                self._advance_epoch()


def batch_iterator(blocks: np.ndarray, global_batch: int, *, seed: int = 0,
                   epochs: int | None = None,
                   shuffle: bool = True) -> Iterator[np.ndarray]:
    """See :class:`BatchIterator`."""
    return BatchIterator(blocks, global_batch, seed=seed, epochs=epochs,
                         shuffle=shuffle)
