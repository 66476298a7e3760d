"""DPO data: port of ``distributed_lion_tpu/data/dpo.py`` (framework-free, copied).

The intended semantics of the reference's ``dpo_llama2.py``, which does not
parse as shipped:

- the prompt template "Question: ...\\n\\nAnswer: " with ``response_j``
  chosen and ``response_k`` rejected (:func:`return_prompt_and_responses`);
- length filtering: a pair is dropped when its prompt is longer than
  ``max_prompt_length`` or prompt + response (+ EOS) of either side is
  longer than ``max_length`` (defaults 1024 and 512);
- ``sanity_check`` keeps the first 1000 records.

:func:`prepare_dpo_batch` returns fixed-shape ``[N, max_length]`` int32
token rows and bool masks over the completion tokens (prompt and padding
excluded from the DPO logprobs); :func:`dpo_batch_iterator` shuffles and
cycles them in global batches, the same order as the JAX package's from
the same seed.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


def return_prompt_and_responses(sample: dict) -> dict:
    """The reference's template (dpo_llama2.py:91-103)."""
    return {
        "prompt": f"Question: {sample['question']}\n\nAnswer: ",
        "chosen": sample["response_j"],
        "rejected": sample["response_k"],
    }


def prepare_dpo_batch(records: Sequence[dict], tokenizer, *, max_length: int = 1024,
                      max_prompt_length: int = 512, sanity_check: bool = False) -> dict:
    """Tokenize, length-filter and pad: ``{"chosen", "rejected"}`` int32 and
    ``{"chosen_mask", "rejected_mask"}`` bool, each ``[N, max_length]``."""
    if sanity_check:
        records = list(records)[:1000]
    pad = getattr(tokenizer, "pad_id", 0)
    eos = getattr(tokenizer, "eos_id", 0)
    rows: dict = {"chosen": [], "rejected": [], "chosen_mask": [], "rejected_mask": []}
    for rec in records:
        trip = return_prompt_and_responses(rec)
        p_ids = tokenizer.encode(trip["prompt"])
        if len(p_ids) > max_prompt_length:
            continue
        encoded = {}
        for side in ("chosen", "rejected"):
            r_ids = tokenizer.encode(trip[side]) + [eos]
            if len(p_ids) + len(r_ids) > max_length:
                break
            ids = p_ids + r_ids
            mask = [False] * len(p_ids) + [True] * len(r_ids)
            encoded[side] = (ids + [pad] * (max_length - len(ids)),
                             mask + [False] * (max_length - len(mask)))
        else:
            for side, (ids, mask) in encoded.items():
                rows[side].append(ids)
                rows[f"{side}_mask"].append(mask)
    if not rows["chosen"]:
        raise ValueError("no DPO samples survived length filtering")
    return {"chosen": np.asarray(rows["chosen"], np.int32),
            "rejected": np.asarray(rows["rejected"], np.int32),
            "chosen_mask": np.asarray(rows["chosen_mask"], bool),
            "rejected_mask": np.asarray(rows["rejected_mask"], bool)}


def dpo_batch_iterator(batch_data: dict, global_batch: int, *, seed: int = 0) -> Iterator[dict]:
    """Shuffle-and-cycle over the fixed-shape arrays: one permutation per
    epoch from ``default_rng(seed)``, whole global batches only."""
    n = len(batch_data["chosen"])
    if n < global_batch:
        raise ValueError(f"{n} DPO pairs < global batch {global_batch}")
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - global_batch + 1, global_batch):
            idx = order[i:i + global_batch]
            yield {k: np.ascontiguousarray(v[idx]) for k, v in batch_data.items()}
