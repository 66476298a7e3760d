"""Attention with one dispatch point: port of ``distributed_lion_tpu/ops/attention.py``.

Only the materialized-scores implementation is ported: ``xla`` (float32
scores, a −1e30 causal mask, float32 softmax). Its score product has a
float32 result (``ops.products.matmul_f32``) and its value product stays
``torch.matmul``, as the JAX package leaves both to XLA. ``flash`` and
``splash``, which the JAX package takes from jax's Pallas TPU kernels, wait
for the port's own flash kernel (ROADMAP Queue 2); ``auto`` resolves to
``xla`` until that kernel exists and is measured on the card.

Tensors are ``[B, H, T, head_dim]``, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from distributed_lion_tpu_torch.ops.products import matmul_f32


def attention_xla(q, k, v, *, causal: bool = True):
    """Materialized-scores attention (attention.py:43-67)."""
    T = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = matmul_f32(q, k.transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, impl: str = "auto"):
    if impl in ("auto", "xla"):
        return attention_xla(q, k, v, causal=causal)
    if impl in ("flash", "splash"):
        raise NotImplementedError(
            f"attention impl {impl!r} needs the port's causal flash "
            "attention kernel, not written yet (ROADMAP Queue 2)")
    raise ValueError(f"unknown attention impl {impl!r} (auto | xla)")
