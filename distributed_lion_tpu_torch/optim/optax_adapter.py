"""The AdamW baseline: port of ``distributed_lion_tpu/optim/optax_adapter.py``.

The reference's non-``--lion`` path is torch AdamW with weight decay 0.1
(run_clm.py:583-585); the JAX package runs it as ``optax.adamw``. This
module is that transformation written out as plain tensor ops on the flat
buffers, in ``optax.adamw``'s order of operations, so it rounds as the JAX
package does (``torch.optim.AdamW`` orders them otherwise):

1. ``scale_by_adam``: ``mu = (1-b1)*g + b1*mu`` and ``nu = (1-b2)*g*g +
   b2*nu`` in the param dtype; ``count += 1``; bias correction by the
   incremented count, ``1 - b**count`` in float32 cast to the moment's
   dtype; ``u = mu_hat / (sqrt(nu_hat) + eps)`` (``eps`` outside the square
   root, ``eps_root`` 0);
2. ``add_decayed_weights``: ``u = u + wd*p``;
3. ``scale_by_learning_rate``: ``u = (-lr(count_before)) * u``, the LR at
   the count before the increment;
4. ``apply_updates``: ``p = p + u``.

A Python float multiplies a tensor as a JAX weak-typed literal does, first
rounded to the tensor's dtype (``ops.lion_math._like``). The state is
replicated: the trainer averages the grads over the ranks with one
``all_reduce`` before the step (the JAX package's ``lax.pmean``). The JAX
package runs no Pallas kernel here, so plain ops are the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_lion_tpu_torch.ops.lion_math import _like
from distributed_lion_tpu_torch.optim.lion import FlatParams, Schedule, resolve_lr


class AdamWState(NamedTuple):
    count: torch.Tensor  # int32 step counter on the params' device
    mu: torch.Tensor     # first moment, flat, in the param dtype
    nu: torch.Tensor     # second moment, flat, in the param dtype


class AdamW:
    """``optax.adamw`` over a :class:`FlatParams`; ``step`` updates
    ``flat.params`` and the moments in place."""

    def __init__(self, learning_rate: Schedule = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.1):
        self.learning_rate, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, flat: FlatParams) -> AdamWState:
        return AdamWState(count=torch.zeros((), dtype=torch.int32, device=flat.device),
                          mu=torch.zeros_like(flat.params), nu=torch.zeros_like(flat.params))

    @torch.no_grad()
    def step(self, flat: FlatParams, state: AdamWState) -> AdamWState:
        p, g, mu, nu = flat.params, flat.grads, state.mu, state.nu
        b1, b2 = self.b1, self.b2
        mu.copy_(g * _like(1.0 - b1, g) + mu * _like(b1, mu))
        nu.copy_((g * g) * _like(1.0 - b2, g) + nu * _like(b2, nu))
        count = state.count + 1
        steps = count.to(torch.float32)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=p.device) ** steps
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=p.device) ** steps
        u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + _like(self.eps, nu))
        u = u + p * _like(self.weight_decay, p)
        u = (-resolve_lr(self.learning_rate, state.count)).to(u.dtype) * u
        p.copy_(p + u)
        return AdamWState(count, mu, nu)


def adamw(learning_rate: Schedule = 1e-4, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.1) -> AdamW:
    """The reference's AdamW baseline (run_clm.py:583-585: weight decay
    0.1), as the JAX package's ``adamw``."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)
