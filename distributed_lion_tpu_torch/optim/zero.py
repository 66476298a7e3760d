"""ZeRO-1 AdamW: port of ``distributed_lion_tpu/optim/zero.py``.

AdamW's moments are split over the data-parallel ranks: the flat parameter
vector, padded to ``W * chunk`` coordinates (``chunk = zero1_chunk(N,
W)``), falls into W equal chunks, and rank ``r`` keeps the float32 ``m``
and ``v`` of chunk ``r`` only (2N/W floats where the replicated AdamW of
``optim/optax_adapter.py`` keeps 2N). Each step rank ``r`` updates its
chunk of the params and one ``all_gather_into_tensor`` reassembles them on
every rank, cut back to N coordinates and cast to the param dtype. The
grads must be the same on every rank (the trainer's averaged flat buffer,
``async_grad=False``): each rank updates the chunk it owns from them.

The step follows the JAX module's order of operations, which is not
optax's (it rounds differently), in float32:

- ``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g*g``;
- ``t = count + 1``, ``m_hat = m / (1 - b1**t)``, ``v_hat = v / (1 -
  b2**t)``, the powers in float32;
- ``p = p - lr(count) * (m_hat / (sqrt(v_hat) + eps) + wd*p)``.

A Python float multiplies a tensor as a JAX weak-typed literal does
(``ops.lion_math._like``). The JAX package's chunk is a ``[1, chunk]`` block
of a ``[world, chunk]`` array; here it is a rank-local tensor. The JAX
package runs no Pallas kernel here, so plain ops are the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from distributed_lion_tpu_torch.ops.lion_math import _like
from distributed_lion_tpu_torch.optim.lion import FlatParams, Schedule, resolve_lr
from distributed_lion_tpu_torch.parallel import collectives
from distributed_lion_tpu_torch.parallel.mesh import rank_of


class Zero1State(NamedTuple):
    count: torch.Tensor  # int32 step counter on the params' device
    m: torch.Tensor      # this rank's float32 [chunk] of the first moment
    v: torch.Tensor      # this rank's float32 [chunk] of the second moment


def zero1_chunk(n_params: int, world: int) -> int:
    """Coordinates of each rank's chunk: ``ceil(N / W)``, at least 1."""
    return max(1, math.ceil(n_params / world))


class AdamWZero1:
    """AdamW with ZeRO-1 state over ``group`` (None: a world of one, no
    collective); ``step`` updates ``flat.params`` in place from
    ``flat.grads``."""

    def __init__(self, learning_rate: Schedule = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.1, group=None):
        self.learning_rate, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.group = group
        self.world, self.rank = collectives.world_of(group), rank_of(group)

    def init(self, flat: FlatParams) -> Zero1State:
        chunk = zero1_chunk(flat.numel, self.world)
        zeros = torch.zeros(chunk, dtype=torch.float32, device=flat.device)
        return Zero1State(count=torch.zeros((), dtype=torch.int32, device=flat.device),
                          m=zeros, v=zeros.clone())

    def _chunk(self, flat_buf: torch.Tensor, chunk: int) -> torch.Tensor:
        """This rank's float32 chunk of a flat buffer, zero past N."""
        lo = self.rank * chunk
        hi = min(lo + chunk, flat_buf.numel())
        out = torch.zeros(chunk, dtype=torch.float32, device=flat_buf.device)
        if hi > lo:
            out[:hi - lo] = flat_buf[lo:hi]
        return out

    @torch.no_grad()
    def step(self, flat: FlatParams, state: Zero1State) -> Zero1State:
        b1, b2 = self.b1, self.b2
        chunk = state.m.numel()
        p_c = self._chunk(flat.params, chunk)
        g_c = self._chunk(flat.grads, chunk)
        t = state.count + 1
        m = state.m * _like(b1, state.m) + g_c * _like(1.0 - b1, g_c)
        v = state.v * _like(b2, state.v) + g_c * _like(1.0 - b2, g_c) * g_c
        tf = t.to(torch.float32)
        mhat = m / (1.0 - _like(b1, tf) ** tf)
        vhat = v / (1.0 - _like(b2, tf) ** tf)
        lr = resolve_lr(self.learning_rate, state.count)
        p_c = p_c - lr * (mhat / (torch.sqrt(vhat) + _like(self.eps, vhat))
                          + p_c * _like(self.weight_decay, p_c))
        if self.group is None:
            new_flat = p_c
        else:  # the ZeRO exchange
            new_flat = p_c.new_empty(self.world * chunk)
            collectives._all_gather(new_flat, p_c, group=self.group)
        flat.params.copy_(new_flat[:flat.numel])
        state.m.copy_(m)
        state.v.copy_(v)
        return Zero1State(t, state.m, state.v)


def adamw_zero1(learning_rate: Schedule = 1e-4, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.1, group=None) -> AdamWZero1:
    """AdamW with decoupled weight decay and ZeRO-1 state, as the JAX
    package's ``adamw_zero1``."""
    return AdamWZero1(learning_rate, b1, b2, eps, weight_decay, group)
