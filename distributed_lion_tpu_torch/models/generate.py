"""Autoregressive generation from a dense KV cache: port of
``distributed_lion_tpu/models/generate.py``.

:func:`generate` prefills the prompt into a static cache
(``init_cache_fn``) and decodes ``max_new_tokens`` tokens one at a time
(``decode_fn``, ``models.gpt2.gpt2_decode`` or ``models.llama.llama_decode``
over their config), every step issued without a host read: the sampled
token, the EOS mask and the next position stay on the device, and the
positions are host integers. Sampling (:func:`sample_logits`) is greedy at
``temperature == 0``, else temperature, top-k and top-p (nucleus) through
:func:`filter_logits`, drawn by the Gumbel-max rule from an explicit
``torch.Generator`` (the JAX package draws ``jax.random.categorical``, the
same rule from another stream: draws compare by their statistics only).
One descending sort serves both filters, and the best token always
survives, so a degenerate ``top_k`` or ``top_p`` falls back to greedy. Once
a row emits ``eos_id`` it emits ``pad_id``. ``prompt_lens`` gives a
left-padded batch's per-row lengths: the pad widths go to the model as the
decode ``offset``, so each row decodes as its solo run.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def filter_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None) -> torch.Tensor:
    """``[B, V]`` logits over ``temperature``, the entries top-k and top-p
    filter out at ``-inf`` (JAX ``filter_logits``): top-p keeps the smallest
    descending prefix of the top-k-filtered distribution whose exclusive
    cumulative mass stays below ``top_p``; the best token is always kept."""
    logits = logits / temperature
    if top_k is None and top_p is None:
        return logits
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    v = logits.shape[-1]
    keep = torch.ones_like(sorted_logits, dtype=torch.bool)
    if top_k is not None:
        keep &= torch.arange(v, device=logits.device)[None, :] < top_k
    if top_p is not None:
        probs = torch.softmax(sorted_logits.masked_fill(~keep, -torch.inf), dim=-1)
        keep &= torch.cumsum(probs, dim=-1) - probs < top_p
    keep[:, 0] = True
    keep = torch.zeros_like(keep).scatter(1, order, keep)
    return logits.masked_fill(~keep, -torch.inf)


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """``[B, V]`` logits → ``[B]`` token ids: the argmax at ``temperature ==
    0``, else a draw from the filtered distribution (Gumbel-max over
    uniforms from ``generator``, clamped above 0 so no kept token gets an
    infinite penalty)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    filtered = filter_logits(logits.to(torch.float32), temperature, top_k, top_p)
    u = torch.rand(filtered.shape, generator=generator, device=filtered.device)
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))
    return torch.argmax(filtered + gumbel, dim=-1)


@torch.no_grad()
def generate(decode_fn: Callable, init_cache_fn: Callable, params, prompt: torch.Tensor,
             max_new_tokens: int, *, generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, eos_id: Optional[int] = None, pad_id: int = 0,
             max_len: Optional[int] = None,
             prompt_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``max_new_tokens`` tokens after ``prompt`` ``[B, T]`` (JAX
    ``generate``): ``decode_fn(params, tokens, cache, pos[, offset]) ->
    (logits, cache)``, ``init_cache_fn(batch, max_len) -> cache``. Returns
    ``[B, max_new_tokens]`` ids. ``prompt_lens`` ``[B]``: the rows are
    left-padded to T, real tokens right-aligned, and each row attends and
    positions as its solo run (greedy rows equal solo runs; sampled rows
    share one stream over the batch)."""
    B, T = prompt.shape
    cache = init_cache_fn(B, max_len or T + max_new_tokens)
    offset = None if prompt_lens is None else (T - prompt_lens).to(torch.int64)

    def dec(tokens, cache, pos):
        if offset is None:
            return decode_fn(params, tokens, cache, pos)
        return decode_fn(params, tokens, cache, pos, offset)

    logits, cache = dec(prompt, cache, 0)   # the prefill
    tok = sample_logits(logits[:, -1], generator, temperature, top_k, top_p)
    finished = None if eos_id is None else tok == eos_id
    out = [tok]
    for i in range(max_new_tokens - 1):
        logits, cache = dec(tok[:, None], cache, T + i)
        tok = sample_logits(logits[:, -1], generator, temperature, top_k, top_p)
        if finished is not None:
            tok = torch.where(finished, pad_id, tok)
            finished = finished | (tok == eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)
