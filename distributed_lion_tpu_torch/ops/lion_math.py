"""Pure per-leaf Lion math shared by the local and distributed optimizers.

Port of ``distributed_lion_tpu/ops/lion_math.py``. Every function keeps the
JAX dtype rules so the two packages round identically: a Python float
multiplies a tensor the way a JAX weak-typed literal does, i.e. it is
first rounded to the tensor's dtype (:func:`_like`). For float32 torch does
that on its own; for bfloat16 it would otherwise multiply by the float32
constant and round once at the end.
"""

from __future__ import annotations

import torch


def _like(x: float, t: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim tensor of ``t``'s dtype: the JAX weak-type cast."""
    return torch.tensor(x, dtype=t.dtype, device=t.device)


def interp(grad: torch.Tensor, exp_avg: torch.Tensor, b1: float) -> torch.Tensor:
    """The raw Lion update direction ``b1*m + (1-b1)*g``."""
    return exp_avg * _like(b1, exp_avg) + grad * _like(1.0 - b1, grad)


def momentum_update(grad: torch.Tensor, exp_avg: torch.Tensor, b2: float) -> torch.Tensor:
    """``m ← b2*m + (1-b2)*g`` with the rank-local gradient."""
    return exp_avg * _like(b2, exp_avg) + grad * _like(1.0 - b2, grad)


def decay_params(params: torch.Tensor, lr: torch.Tensor, wd: float) -> torch.Tensor:
    """Decoupled weight decay ``p ← p * (1 - lr*wd)``; the float32 factor is
    cast to the param dtype, as in the JAX package."""
    return params * (1.0 - lr * wd).to(params.dtype)


def sign_vote_bool(grad: torch.Tensor, exp_avg: torch.Tensor, b1: float) -> torch.Tensor:
    """Deterministic binarization: True where the update is > 0 (zero votes −1)."""
    return interp(grad, exp_avg, b1) > 0


def apply_signed_update(params: torch.Tensor, vote_pos: torch.Tensor,
                        lr: torch.Tensor) -> torch.Tensor:
    """``p ← p - lr * (vote ? +1 : -1)``."""
    s = torch.where(vote_pos, 1.0, -1.0).to(params.dtype)
    return params - lr.to(params.dtype) * s


def local_lion_leaf(params, grad, exp_avg, lr, wd, b1, b2):
    """One local-Lion step on one leaf: decay, true ``sign`` step (0 → no
    move), momentum. Returns ``(params, exp_avg)``."""
    p = decay_params(params, lr, wd)
    u = torch.sign(interp(grad, exp_avg, b1))
    p = p - lr.to(p.dtype) * u.to(p.dtype)
    return p, momentum_update(grad, exp_avg, b2)
