"""Token sources and the batch iterator: port of ``distributed_lion_tpu/data/sources.py``.

Framework-free numpy, copied so the port needs nothing of the JAX package:

- :func:`synthetic_lm_dataset` — a learnable synthetic language;
- :class:`TokenDataset` — pre-tokenized ``.bin`` (uint16/uint32 memmap)
  block datasets;
- :class:`BatchIterator` — epoch-shuffled, drop-last global batches.

Local text through the tokenizer stack (``text:<glob>``) is not ported yet
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


def synthetic_lm_dataset(n_blocks: int, block_size: int, vocab_size: int,
                         seed: int = 0) -> np.ndarray:
    """Sequences with short-range structure (next ≈ prev + small noise mod V)
    so a real LM's loss falls measurably below uniform."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab_size, size=(n_blocks, 1))
    steps = rng.integers(-2, 3, size=(n_blocks, block_size - 1))
    toks = np.concatenate([start, steps], axis=1).cumsum(axis=1) % vocab_size
    return toks.astype(np.int32)


@dataclass
class TokenDataset:
    """Memory-mapped pre-tokenized dataset cut into fixed blocks."""

    blocks: np.ndarray  # [n, block_size] (or memmap view)

    @staticmethod
    def from_bin(path, block_size: int, dtype=np.uint16) -> "TokenDataset":
        flat = np.memmap(path, dtype=dtype, mode="r")
        n = len(flat) // block_size
        return TokenDataset(flat[: n * block_size].reshape(n, block_size))

    def __len__(self) -> int:
        return len(self.blocks)


class BatchIterator:
    """[global_batch, block] int32 batches, reshuffled each epoch, drop-last.
    ``epochs=None`` cycles forever. Resume's ``skip`` waits for the
    checkpoint port (ROADMAP Queue 1 item 7)."""

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


def batch_iterator(blocks: np.ndarray, global_batch: int, *, seed: int = 0,
                   epochs: int | None = None,
                   shuffle: bool = True) -> Iterator[np.ndarray]:
    """See :class:`BatchIterator`."""
    return BatchIterator(blocks, global_batch, seed=seed, epochs=epochs,
                         shuffle=shuffle)
