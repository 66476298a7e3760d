"""Distributed Lion: 1-bit majority-vote Lion over ``torch.distributed``.

Port of ``distributed_lion_tpu/optim/distributed_lion.py``, deterministic
fused path (``_step_pallas``, :370-519). Each step, every rank:

1. forms int8 ±1 ballots from its own momentum and gradient
   (:func:`fused_lion.fused_ballots`, one launch per vote bucket);
2. votes each bucket over the wire (``parallel.collectives``), bucket k's
   collective issued ``async_op=True`` while bucket k−1 applies;
3. applies the elected ±lr step with decoupled weight decay and updates its
   momentum from its local gradient (:func:`fused_lion.fused_apply`, one
   launch per bucket, in place on the flat buffers).

Buckets are ``codec.bucket_bounds`` of the flat buffers (the same
boundaries as the JAX package), so a bucket is one window and one launch,
where the JAX package launches once per leaf window. Momentum is rank-local:
the JAX package's ``[world, ...]`` stacked momentum is that, stacked.

Ported: the deterministic mode with ``vote_every == 1`` and uniform dtypes,
on the three flat wires, momentum in the param dtype. Refused, naming their
ROADMAP items: stochastic binarization (``max_grad_norm``), lazy refresh
(``vote_every > 1``), the DCN pipeline (``dcn_pipeline_depth``), the vote
guard (``guard``) and vote-health telemetry (``telemetry``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.ops import fused_lion
from distributed_lion_tpu_torch.ops.codec import bucket_bounds, parse_wire
from distributed_lion_tpu_torch.optim.lion import (
    FlatParams,
    LionState,
    Schedule,
    _validate,
    init_state,
    lion,
    resolve_lr,
)
from distributed_lion_tpu_torch.parallel import collectives
from distributed_lion_tpu_torch.parallel.mesh import DATA_AXIS


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet ({item})")


class DistributedLion:
    """The majority-vote optimizer over a :class:`FlatParams`. ``group`` is
    the vote's process group (None: a world of one, no collective).
    ``tally`` optionally records the bytes each collective hands the
    backend (:class:`collectives.WireTally`)."""

    def __init__(self, learning_rate: Schedule = 1e-4, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 0.0, *, group=None,
                 wire: str = "sign_psum", vote_buckets: int = 1,
                 tally: Optional[collectives.WireTally] = None):
        parse_wire(wire)
        _validate(learning_rate, b1, b2)
        if vote_buckets < 1:
            raise ValueError(f"vote_buckets must be >= 1, got {vote_buckets}")
        self.learning_rate, self.b1, self.b2 = learning_rate, b1, b2
        self.weight_decay = weight_decay
        self.group, self.wire, self.vote_buckets = group, wire, vote_buckets
        self.tally = tally
        self.world = collectives.world_of(group)

    def init(self, flat: FlatParams) -> LionState:
        return init_state(flat)

    @torch.no_grad()
    def step(self, flat: FlatParams, state: LionState) -> LionState:
        """One optimizer step from ``flat.grads``; updates ``flat.params``
        and ``state.exp_avg`` in place."""
        lr = resolve_lr(self.learning_rate, state.count)
        p, g, m = flat.params, flat.grads, state.exp_avg
        pending = None
        for start, size in bucket_bounds(flat.numel, self.vote_buckets,
                                         self.world, self.wire):
            w = slice(start, start + size)
            ballots = fused_lion.fused_ballots(g[w], m[w], self.b1)
            vote = collectives.vote_total_async(ballots, self.wire, self.group,
                                                self.tally)
            if pending is not None:  # apply k−1 while bucket k is on the wire
                self._apply(p, g, m, lr, *pending)
            pending = (w, vote)
        if pending is not None:
            self._apply(p, g, m, lr, *pending)
        return LionState(state.count + 1, m)

    def _apply(self, p, g, m, lr, w: slice, vote: collectives.PendingVote):
        fused_lion.fused_apply(p[w], g[w], m[w], vote.wait(), lr,
                               self.weight_decay, self.b2)


def distributed_lion(
    learning_rate: Schedule = 1e-4,
    b1: float = 0.9,
    b2: float = 0.99,
    weight_decay: float = 0.0,
    *,
    axis_name: Optional[str] = DATA_AXIS,
    group=None,
    max_grad_norm: Optional[float] = None,
    wire: str = "sign_psum",
    vote_every: int = 1,
    vote_buckets: int = 1,
    dcn_pipeline_depth: int = 0,
    telemetry: bool = False,
    guard: str = "off",
    tally: Optional[collectives.WireTally] = None,
):
    """Build the majority-vote Lion optimizer, as the JAX package's
    ``distributed_lion``. ``axis_name=None`` is the local-Lion fallback;
    otherwise the vote runs over ``group``, defaulting to the started
    default process group, or to a world of one when there is none."""
    parse_wire(wire)
    if dcn_pipeline_depth < 0:
        raise ValueError(f"dcn_pipeline_depth must be >= 0, got {dcn_pipeline_depth}")
    if axis_name is None:
        if max_grad_norm is not None:
            raise ValueError(
                "max_grad_norm (stochastic binarization) requires a vote axis; "
                "pass axis_name or use lion() for the local optimizer")
        if telemetry or guard != "off" or dcn_pipeline_depth > 0:
            raise ValueError(
                "telemetry, the vote guard and the DCN pipeline act on the "
                "vote; with axis_name=None there is none — use lion()")
        return lion(learning_rate, b1, b2, weight_decay)
    if vote_every < 1:
        raise ValueError(f"vote_every must be >= 1, got {vote_every}")
    if max_grad_norm is not None:
        _refuse("stochastic binarization (max_grad_norm)", "ROADMAP Queue 1 item 4")
    if vote_every > 1:
        _refuse("lazy sign refresh (vote_every > 1)", "ROADMAP Queue 1 item 4")
    if dcn_pipeline_depth > 0:
        _refuse("the cross-step DCN pipeline (dcn_pipeline_depth)",
                "ROADMAP Queue 1 item 11")
    if guard != "off":
        _refuse(f"the vote guard (guard={guard!r})", "ROADMAP Queue 1 item 10")
    if telemetry:
        _refuse("vote-health telemetry", "ROADMAP Queue 1 item 10")
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    return DistributedLion(learning_rate, b1, b2, weight_decay, group=group,
                           wire=wire, vote_buckets=vote_buckets, tally=tally)

