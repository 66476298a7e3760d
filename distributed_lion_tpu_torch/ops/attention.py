"""Attention with one dispatch point: port of ``distributed_lion_tpu/ops/attention.py``.

- ``xla``: materialized scores (float32 scores from a float32-result
  product, ``ops.products.matmul_f32``; a −1e30 causal mask; float32
  softmax), as the JAX package leaves it to XLA.
- ``flash``: the port's causal flash attention (``ops/flash_attention.py``,
  hand-written CUDA kernels for the forward, dK/dV and dQ); on CPU tensors
  its plain PyTorch versions.
- ``splash``: the same causal function, routed to the same kernels. The
  JAX package's splash kernel pads head_dim to the TPU's 128 lanes; the
  card does not need that, and the package is causal-only, so there is no
  sparse mask to port.
- ``auto``: :func:`resolve_impl`, the JAX table (attention.py:301-379) with
  "on TPU" read as "on CUDA": flash for T ≥ 2048, and at T = 1024 with
  head_dim 64 (GPT-2); xla everywhere else, so Llama's head_dim 128 takes
  flash from T = 2048 and xla at T = 1024, as in the JAX table. Two
  conditions are the card's own: the kernels take bfloat16 only, so float32
  inputs take xla, and they are built for head_dim 64 and 128 only, so other
  head dims take xla. Off
  CUDA, auto is always xla, as the JAX package is off the TPU. The TPU tile
  knobs (``flash@BQxBKV``) and the autotune cache are not ported.

Tensors are ``[B, H, T, head_dim]``, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from distributed_lion_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    UNPORTED_DTYPE,
    flash_attention,
)
from distributed_lion_tpu_torch.ops.products import matmul_f32

IMPLS = ("auto", "xla", "flash", "splash")


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


def attention_flash(q, k, v, *, causal: bool = True):
    """Causal flash attention (attention.py:70); ``splash``
    (attention.py:104) computes the same function and runs this one."""
    if not causal:
        raise ValueError("the port's flash attention is causal only, as the "
                         "package's decoders are")
    return flash_attention(q, k, v)


def resolve_impl(impl: str, device_type: str, T: int, head_dim: int,
                 dtype: torch.dtype) -> str:
    """The implementation ``attention`` runs: a pure function of the device
    type, sequence length, head_dim and dtype. An explicit ``flash`` or
    ``splash`` at a dtype other than bfloat16 on CUDA raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} ({' | '.join(IMPLS)})")
    if impl == "auto":
        on_cuda = device_type == "cuda"
        kernel_ok = dtype == torch.bfloat16 and head_dim in KERNEL_HEAD_DIMS
        if on_cuda and kernel_ok and (T >= 2048 or (T == 1024 and head_dim == 64)):
            return "flash"
        return "xla"
    if impl in ("flash", "splash") and device_type == "cuda" and dtype != torch.bfloat16:
        raise NotImplementedError(f"attention impl {impl!r} at {dtype}: {UNPORTED_DTYPE}")
    return impl


def attention(q, k, v, *, causal: bool = True, impl: str = "auto"):
    impl = resolve_impl(impl, q.device.type, q.shape[2], q.shape[-1], q.dtype)
    if impl == "xla":
        return attention_xla(q, k, v, causal=causal)
    return attention_flash(q, k, v, causal=causal)
