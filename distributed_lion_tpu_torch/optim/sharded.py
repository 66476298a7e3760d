"""The standalone optimizer step: port of ``distributed_lion_tpu/optim/sharded.py``.

The JAX package's wrapper puts Distributed Lion into a ``shard_map`` over
the data axis: replicated params, a momentum stacked ``[world, ...]`` and
sharded over ``data``, the gradients stacked the same way, one vote
collective inside, for users who bring their own training loop. In torch
each rank is its own process: it already holds its own momentum and its own
gradient, and the optimizer makes the vote's collective over its process
group itself. So this module reduces to a thin wrapper: :func:`state_specs`
names which state fields are a rank's own and which are replicated,
:func:`make_sharded_step` checks the optimizer against the group and the
state's layout and calls ``DistributedLion.step`` on this rank's gradient,
and :func:`shard_state` takes a rank's row of a stacked state (such as the
JAX package's ``init_global_state`` builds).
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_lion_tpu_torch.optim.distributed_lion import DistributedLion
from distributed_lion_tpu_torch.optim.lion import FlatParams, LionState
from distributed_lion_tpu_torch.parallel.mesh import DATA_AXIS

REPLICATED = "replicated"


def state_specs(has_elected: bool = False, has_guard: bool = False) -> LionState:
    """The layout of a :class:`LionState` over the data group (JAX
    ``state_specs``): ``DATA_AXIS`` for a field each rank holds its own of
    (the momentum, the guard's previous ballot), ``REPLICATED`` for one
    every rank holds the same (the count, the elected-sign cache under
    ``vote_every`` > 1, the guard's health mask), None for an absent one."""
    return LionState(count=REPLICATED, exp_avg=DATA_AXIS, steps=REPLICATED,
                     elected=REPLICATED if has_elected else None,
                     health=REPLICATED if has_guard else None,
                     prev_ballot=DATA_AXIS if has_guard else None)


def make_sharded_step(opt: DistributedLion, group=None, has_elected: bool = False,
                      has_guard: bool = False) -> Callable:
    """``step(params, grads, state) -> (params, state)``, plus the guard
    frame with ``has_guard`` (JAX ``make_sharded_step``): ``params`` this
    rank's :class:`FlatParams`, ``grads`` its own flat gradient (never
    averaged: the reference's ``no_sync`` contract), ``state`` its
    :class:`LionState` (:func:`shard_state`). The election runs over
    ``group``, which must be the optimizer's vote group. ``has_elected``
    says the optimizer was built with ``vote_every`` > 1, ``has_guard`` with
    a guard; an optimizer built with ``telemetry`` needs the trainer (its
    frame folds into the trainer's accumulator), as in the JAX package."""
    if opt.group is not group:
        raise ValueError("the optimizer votes over another process group than the step's: "
                         "build it with distributed_lion(group=group)")
    if has_elected != (opt.vote_every > 1):
        raise ValueError(f"has_elected={has_elected} but the optimizer has vote_every "
                         f"{opt.vote_every}")
    if has_guard != (opt.guard != "off"):
        raise ValueError(f"has_guard={has_guard} but the optimizer has guard {opt.guard!r}")
    if opt.telemetry:
        raise ValueError("an optimizer built with telemetry=True needs the Trainer: its "
                         "vote-health frame folds into the trainer's accumulator")

    def step(params: FlatParams, grads: torch.Tensor, state: LionState) -> tuple:
        if (state.elected is not None) != has_elected or (state.health is not None) != has_guard:
            raise ValueError("the state's elected cache or guard fields do not match the step's "
                             "has_elected / has_guard")
        with torch.no_grad():
            params.grads.copy_(grads.reshape(-1))
        out = opt.step(params, state)
        if type(out) is tuple:   # (state, guard frame)
            return (params, *out)
        return params, out

    return step


def shard_state(state: LionState, rank: int) -> LionState:
    """Rank ``rank``'s state from a stacked one: row ``rank`` of the
    momentum ``[world, n]`` (and of the guard's previous ballot); the
    replicated fields as they are. A mixed-dtype tree's momentum (one
    buffer per dtype, a tuple) has no stacked form: refused."""
    if isinstance(state.exp_avg, tuple):
        raise NotImplementedError(
            "shard_state: a mixed-dtype tree's momentum is one buffer per dtype, not a "
            "stacked [world, n] tensor with a row per rank")
    return state._replace(
        exp_avg=state.exp_avg[rank].clone(),
        prev_ballot=None if state.prev_ballot is None else state.prev_ballot[rank].clone())
