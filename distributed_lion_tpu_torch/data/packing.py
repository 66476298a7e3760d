"""Fixed-block packing: port of ``distributed_lion_tpu/data/packing.py`` (framework-free, copied).

Concatenate tokenized documents, drop the remainder below a multiple of
``block_size`` and cut contiguous blocks (labels are the inputs; the shift
happens in the loss).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Sequence

import numpy as np


def group_texts(examples: Sequence[Sequence[int]], block_size: int) -> np.ndarray:
    """Concatenate token lists and split into fixed blocks, dropping the
    remainder; int32 ``[n_blocks, block_size]``."""
    concat: List[int] = []
    for ex in examples:
        concat.extend(ex)
    total = (len(concat) // block_size) * block_size
    if total == 0:
        return np.zeros((0, block_size), np.int32)
    return np.asarray(concat[:total], np.int32).reshape(-1, block_size)


def pack_token_stream(token_iter: Iterable[Sequence[int]], block_size: int,
                      buffer_blocks: int = 1024) -> Iterator[np.ndarray]:
    """Streaming variant: ``[block_size]`` blocks from an unbounded document
    iterator with bounded memory."""
    buf: List[int] = []
    for ex in token_iter:
        buf.extend(ex)
        while len(buf) >= block_size * buffer_blocks:
            chunk = np.asarray(buf[: block_size * buffer_blocks], np.int32)
            del buf[: block_size * buffer_blocks]
            yield from chunk.reshape(-1, block_size)
    while len(buf) >= block_size:
        chunk = np.asarray(buf[:block_size], np.int32)
        del buf[:block_size]
        yield chunk
