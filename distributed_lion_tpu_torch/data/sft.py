"""SFT data: port of ``distributed_lion_tpu/data/sft.py`` (framework-free, copied).

- :func:`prepare_sample_text`: the reference's "Question:/Answer:" template;
- :func:`chars_token_ratio`: chars per token over the first samples;
- :func:`constant_length_batches`: TRL ConstantLengthDataset packing
  (format, tokenize, EOS-join, cut fixed blocks, loop forever);
- :func:`padded_examples` and :func:`padded_batch_iterator`: one example a
  row, padded and loss-masked, optionally grouped by length;
- :func:`load_pairs_jsonl` and :func:`synthetic_qa_pairs`: the records.
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterable, Iterator, List, Sequence

import numpy as np

from distributed_lion_tpu_torch.data.packing import pack_token_stream


def prepare_sample_text(example: dict) -> str:
    """The reference's template (sft_llama2.py:93-96)."""
    return f"Question: {example['question']}\n\nAnswer: {example['response_j']}"


def chars_token_ratio(samples: Sequence[dict], tokenizer, nb_examples: int = 400) -> float:
    """Total chars over total tokens of the first ``nb_examples`` samples."""
    total_chars, total_tokens = 0, 0
    for example in list(samples)[:nb_examples]:
        text = prepare_sample_text(example)
        total_chars += len(text)
        total_tokens += len(tokenizer.encode(text))
    return total_chars / max(total_tokens, 1)


def load_pairs_jsonl(path: str | pathlib.Path, *, size_valid_set: int = 0) -> tuple:
    """``{"question", "response_j", ...}`` records; the first
    ``size_valid_set`` are the validation split. Returns ``(train, valid)``."""
    records: List[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records[size_valid_set:], records[:size_valid_set]


def synthetic_qa_pairs(n: int, seed: int = 0) -> List[dict]:
    """A learnable synthetic Q/A corpus for tests and offline runs."""
    rng = np.random.default_rng(seed)
    ops = [("plus", lambda a, b: a + b), ("times", lambda a, b: a * b)]
    out = []
    for _ in range(n):
        a, b = int(rng.integers(0, 50)), int(rng.integers(0, 50))
        name, fn = ops[int(rng.integers(0, len(ops)))]
        out.append({
            "question": f"What is {a} {name} {b}?",
            "response_j": f"The answer is {fn(a, b)}.",
            "response_k": f"The answer is {fn(a, b) + int(rng.integers(1, 7))}.",
        })
    return out


def padded_examples(samples: Sequence[dict], tokenizer, seq_length: int, *,
                    format_fn=prepare_sample_text, group_by_length: bool = False) -> tuple:
    """One example a row, EOS-terminated, truncated and padded to
    ``seq_length``: ``(tokens [n, seq] int32, mask [n, seq] float32)``, the
    mask over real tokens only. ``group_by_length`` sorts rows by length."""
    eos = getattr(tokenizer, "eos_id", 0)
    pad = getattr(tokenizer, "pad_id", eos)
    rows = [(tokenizer.encode(format_fn(s)) + [eos])[:seq_length] for s in samples]
    if not rows:
        raise ValueError("no SFT samples")
    if group_by_length:
        rows.sort(key=len)
    tokens = np.full((len(rows), seq_length), pad, np.int32)
    mask = np.zeros((len(rows), seq_length), np.float32)
    for i, ids in enumerate(rows):
        tokens[i, : len(ids)] = ids
        mask[i, : len(ids)] = 1.0
    return tokens, mask


def padded_batch_iterator(tokens: np.ndarray, mask: np.ndarray, global_batch: int, *,
                          seed: int = 0, shuffle: bool = True,
                          length_grouped: bool = False) -> Iterator[dict]:
    """``{"tokens", "mask"}`` batches forever, reshuffled each epoch: the
    examples permuted (HF RandomSampler), or with ``length_grouped`` whole
    batches of the length-sorted rows permuted, the drop-last window slid
    by a random offset each epoch (HF LengthGroupedSampler)."""
    n = len(tokens)
    if n < global_batch:
        raise ValueError(f"{n} examples < global batch {global_batch}")
    rng = np.random.default_rng(seed)
    n_batches = n // global_batch
    while True:
        if length_grouped:
            resid = n - n_batches * global_batch
            off = int(rng.integers(0, resid + 1)) if (shuffle and resid) else 0
            starts = (rng.permutation(n_batches) if shuffle
                      else np.arange(n_batches)) * global_batch + off
            idx_batches = [np.arange(s, s + global_batch) for s in starts]
        else:
            order = rng.permutation(n) if shuffle else np.arange(n)
            idx_batches = [order[i * global_batch: (i + 1) * global_batch]
                           for i in range(n_batches)]
        for idx in idx_batches:
            yield {"tokens": np.ascontiguousarray(tokens[idx]),
                   "mask": np.ascontiguousarray(mask[idx])}


def constant_length_batches(samples: Iterable[dict], tokenizer, seq_length: int = 1024, *,
                            infinite: bool = True, format_fn=prepare_sample_text,
                            chars_per_token: float = 3.6,
                            num_sequences_buffer: int = 1024) -> Iterator[np.ndarray]:
    """``[seq_length]`` int32 rows, TRL ConstantLengthDataset style; with
    ``infinite`` the samples repeat forever, else every sample is drained.
    ``chars_per_token`` is accepted for the reference's signature and
    unused: tokenizing lazily needs no char budget."""
    del chars_per_token
    samples = list(samples)
    if not samples:
        raise ValueError("no SFT samples")
    eos = getattr(tokenizer, "eos_id", 0)

    def token_iter():
        while True:
            for s in samples:
                yield tokenizer.encode(format_fn(s)) + [eos]
            if not infinite:
                return

    yield from pack_token_stream(token_iter(), seq_length, buffer_blocks=num_sequences_buffer)
