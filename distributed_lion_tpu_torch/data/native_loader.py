"""ctypes front end of the C++ prefetching token loader: port of ``distributed_lion_tpu/data/native_loader.py``.

The batch contract of :class:`data.sources.BatchIterator` ([global_batch,
block] int32, a reshuffle each epoch, drop-last), with the gather and the
shuffle in a C++ background thread over mmap'd shards
(``native/dataloader.cc``), so the host's input work overlaps the step.
Every shard is validated first, with retries and backoff for transient
I/O; a shard that stays bad is skipped loudly (a warning on stderr) and
counted in :meth:`NativeTokenLoader.health_metrics`; the skip and each
retry are also ``shard_skipped`` and ``shard_retry`` events of the active
run journal (``train/journal.py``). Skipping a shard
shifts every later block index, so ``cli/run_clm`` refuses to resume over
a fleet that changed.
"""

from __future__ import annotations

import ctypes
import pathlib
import time
from typing import Iterator, Sequence

import numpy as np

from distributed_lion_tpu_torch import native
from distributed_lion_tpu_torch.train import journal

_DTYPES = {np.dtype(np.uint16): 2, np.dtype(np.uint32): 4}

# the shard-open retry schedule: SHARD_RETRIES retries, backoff doubling
# from SHARD_BACKOFF_S, before a shard is declared corrupt and skipped
SHARD_RETRIES = 3
SHARD_BACKOFF_S = 0.05


class CorruptShardError(OSError):
    """A shard failed validation after the retry budget."""


def _validate_shard(path: pathlib.Path, dtype_bytes: int) -> None:
    """Readable, non-empty and a whole number of tokens; raises otherwise."""
    size = path.stat().st_size
    if size == 0:
        raise CorruptShardError(f"{path}: empty shard")
    if size % dtype_bytes:
        raise CorruptShardError(
            f"{path}: {size} bytes is not a multiple of the {dtype_bytes}-byte token width "
            "(torn write or wrong --bin_dtype)")
    with open(path, "rb") as f:
        f.read(dtype_bytes)


def _with_retries(fn, on_retry=None):
    """``fn()`` under the retry schedule; a structural error
    (:class:`CorruptShardError`, ``IndexError``) is raised at once."""
    delay = SHARD_BACKOFF_S
    for attempt in range(SHARD_RETRIES + 1):
        try:
            return fn()
        except (CorruptShardError, IndexError):
            raise
        except Exception:
            if attempt == SHARD_RETRIES:
                raise
            if on_retry is not None:
                on_retry()
            time.sleep(delay)
            delay *= 2


class NativeTokenLoader:
    """Mmap'd ``.bin`` token shards cut into fixed blocks, each shard's tail
    below one block dropped, served by a C++ prefetch thread. Raises only
    when every shard is bad."""

    def __init__(self, paths: Sequence[str | pathlib.Path], block_size: int, dtype=np.uint16):
        self._lib = native.load()
        self.block_size = int(block_size)
        dtype_bytes = _DTYPES.get(np.dtype(dtype))
        if dtype_bytes is None:
            raise ValueError(f"dtype must be uint16 or uint32, got {dtype}")
        self.skipped_shards: list[str] = []
        self.read_retries = 0
        good: list[str] = []
        last_err: Exception | None = None
        for p in paths:
            path = pathlib.Path(p)
            try:
                _with_retries(lambda: _validate_shard(path, dtype_bytes),
                              on_retry=self._count_retry)
                good.append(str(path))
            except Exception as e:
                last_err = e
                self.skipped_shards.append(str(path))
                journal.emit(f"[native_loader] WARNING: skipping corrupt/unreadable shard {path} "
                             f"after {SHARD_RETRIES + 1} attempts: {e}", stderr=True)
                journal.event("shard_skipped", shard=str(path), error=f"{type(e).__name__}: {e}")
        if not good:
            raise CorruptShardError(f"all {len(self.skipped_shards)} shard(s) failed "
                                    f"validation; last error: {last_err}")
        # the served fleet, in order: block indices are a function of it
        self.shards = good
        enc = [s.encode() for s in good]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        self._h = self._lib.dl_open(arr, len(enc), dtype_bytes, self.block_size)
        if not self._h:
            raise OSError(self._lib.dl_last_error().decode())

    def __len__(self) -> int:
        return int(self._lib.dl_num_blocks(self._h))

    def health_metrics(self) -> dict:
        """Loader-health counters for the trainer's metrics rows."""
        return {"skipped_shards": len(self.skipped_shards),
                "shard_read_retries": self.read_retries}

    def _count_retry(self) -> None:
        self.read_retries += 1
        journal.event("shard_retry", retries=self.read_retries)

    def read_block(self, idx: int) -> np.ndarray:
        out = np.empty(self.block_size, np.int32)
        ok = self._lib.dl_read_block(self._h, idx,
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if not ok:
            raise IndexError(self._lib.dl_last_error().decode())
        return out

    def read_blocks(self, start: int, stop: int) -> np.ndarray:
        return np.stack([self.read_block(i) for i in range(start, stop)])

    def batches(self, global_batch: int, *, seed: int = 0, shuffle: bool = True,
                prefetch_depth: int = 4, epochs: int | None = None,
                block_range: tuple[int, int] | None = None) -> "_NativeBatches":
        """A deferred-start batch iterator: the C++ thread starts at the
        first ``next()``, so a ``skip(n)`` before it is handed to the
        sampler (skipped epochs draw no shuffle, skipped batches read no
        data). ``block_range=(lo, hi)`` samples only those blocks."""
        lo, hi = block_range if block_range is not None else (0, 0)
        if hi <= 0:
            hi = len(self)
        if lo < 0 or lo >= hi or hi > len(self):
            raise RuntimeError(f"invalid sample range [{lo}, {hi})")
        if global_batch <= 0 or global_batch > hi - lo:
            raise RuntimeError(f"global_batch {global_batch} must be in [1, {hi - lo}]")
        return _NativeBatches(self, global_batch, seed=seed, shuffle=shuffle,
                              prefetch_depth=prefetch_depth, epochs=epochs,
                              block_range=block_range)

    def _start(self, global_batch: int, *, seed, shuffle, prefetch_depth, epochs, block_range,
               skip_batches: int) -> Iterator[np.ndarray]:
        lo, hi = block_range if block_range is not None else (0, 0)
        ok = self._lib.dl_start(self._h, global_batch, seed, int(shuffle), prefetch_depth,
                                0 if epochs is None else int(epochs), lo, hi, int(skip_batches))
        if not ok:
            raise RuntimeError(self._lib.dl_last_error().decode())

        def gen():
            out = np.empty((global_batch, self.block_size), np.int32)
            ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            while self._h and self._lib.dl_next(self._h, ptr):
                yield out.copy()

        return gen()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _NativeBatches:
    """Deferred-start iterator over a :class:`NativeTokenLoader`: records
    ``skip(n)`` calls until the first ``next()``, then starts the C++
    thread with the summed offset."""

    def __init__(self, loader: NativeTokenLoader, global_batch: int, **kwargs):
        self._loader = loader
        self._gb = global_batch
        self._kwargs = kwargs
        self._skip = 0
        self._gen = None

    def skip(self, n: int) -> None:
        if self._gen is not None:
            raise RuntimeError("cannot skip after iteration started")
        self._skip += int(n)

    def health_metrics(self) -> dict:
        return self._loader.health_metrics()

    def __iter__(self) -> "_NativeBatches":
        return self

    def __next__(self) -> np.ndarray:
        if self._gen is None:
            self._gen = self._loader._start(self._gb, skip_batches=self._skip, **self._kwargs)
        return next(self._gen)


def native_available() -> bool:
    return native.available()
