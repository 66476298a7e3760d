"""Pure per-leaf Lion math shared by the local and distributed optimizers.

Port of ``distributed_lion_tpu/ops/lion_math.py``. Every function keeps the
JAX dtype rules so the two packages round identically: a Python float
multiplies a tensor the way a JAX weak-typed literal does, i.e. it is
first rounded to the tensor's dtype (:func:`_like`). For float32 torch does
that on its own; for bfloat16 it would otherwise multiply by the float32
constant and round once at the end.
"""

from __future__ import annotations

import numpy as np
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


def stochastic_generator(seed: int, count: int, rank: int,
                         device: torch.device) -> torch.Generator:
    """The random stream of one rank's stochastic ballots at one step, on
    ``device``: seeded from ``(seed, count, rank)`` alone, so a run
    replays its draws, a resume needs only the seed and the step count, and
    ranks draw apart (the JAX package folds the count, then the worker
    index, into its key)."""
    words = np.random.SeedSequence([seed, count, rank]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(words[0]))


def stochastic_p_up(grad: torch.Tensor, exp_avg: torch.Tensor, b1: float,
                    max_grad_norm: float) -> torch.Tensor:
    """``clip((u + r) / 2r, 0, 1)`` in float32, with ``u`` the Lion update
    direction and ``r = (1 + 1/b1)·max_grad_norm``: the probability of a +1
    ballot."""
    r = (1.0 + 1.0 / b1) * max_grad_norm
    u = interp(grad, exp_avg, b1).to(torch.float32)
    return torch.clamp((u + _like(r, u)) / _like(2.0 * r, u), 0.0, 1.0)


def stochastic_vote_bool(grad: torch.Tensor, exp_avg: torch.Tensor, b1: float,
                         max_grad_norm: float, generator: torch.Generator) -> torch.Tensor:
    """Stochastic binarization (the reference's unbiased 1-bit quantizer):
    True with probability :func:`stochastic_p_up`, a uniform draw in [0, 1)
    from ``generator`` below it. Where ``|u| >= r`` the probability is 0 or
    1 and the ballot is the deterministic one."""
    p_up = stochastic_p_up(grad, exp_avg, b1, max_grad_norm)
    return torch.rand(p_up.shape, generator=generator, device=p_up.device) < p_up


def apply_signed_update(params: torch.Tensor, vote_pos: torch.Tensor,
                        lr: torch.Tensor) -> torch.Tensor:
    """``p ← p - lr * (vote ? +1 : -1)``."""
    s = torch.where(vote_pos, 1.0, -1.0).to(params.dtype)
    return params - lr.to(params.dtype) * s


def cache_tally(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` bits of a packed elected-sign cache (LSB first, as
    ``codec.pack_signs`` packs) as an int8 tally: 1 where +1 was elected, 0
    where −1, so an apply that elects ``tally > 0`` reads the cached signs,
    with no bool or float copy of the vector."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 1).reshape(-1)[:n].view(torch.int8)


def lazy_update(params, grad, exp_avg, tally, valid: int, lr, wd, b2):
    """The JAX package's lazy-refresh update (XLA path,
    distributed_lion.py:806-815, 863-868) over a flat vector: every
    coordinate decays; the first ``valid`` coordinates (the slots that have
    voted) then move by ``-lr * (tally > 0 ? +1 : -1)``, the rest by
    ``-lr * 0``, which leaves them as decayed; momentum updates from the
    local gradient everywhere. Returns new ``(params, exp_avg)``."""
    p = decay_params(params, lr, wd)
    p[:valid] = apply_signed_update(p[:valid], tally[:valid] > 0, lr)
    return p, momentum_update(grad, exp_avg, b2)


def local_lion_leaf(params, grad, exp_avg, lr, wd, b1, b2):
    """One local-Lion step on one leaf: decay, true ``sign`` step (0 → no
    move), momentum. Returns ``(params, exp_avg)``."""
    p = decay_params(params, lr, wd)
    u = torch.sign(interp(grad, exp_avg, b1))
    p = p - lr.to(p.dtype) * u.to(p.dtype)
    return p, momentum_update(grad, exp_avg, b2)
