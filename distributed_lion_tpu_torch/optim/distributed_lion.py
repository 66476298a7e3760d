"""Distributed Lion: 1-bit majority-vote Lion over ``torch.distributed``.

Port of ``distributed_lion_tpu/optim/distributed_lion.py``. The
deterministic mode follows the fused path (``_step_pallas``, :370-519).
Each step, every rank:

1. forms int8 ±1 ballots from its own momentum and gradient
   (:func:`fused_lion.fused_ballots`, one launch per vote bucket);
2. votes each bucket over the wire (``parallel.collectives``), bucket k's
   first collective issued ``async_op=True`` while bucket k−1 applies;
3. applies the elected ±lr step with decoupled weight decay and updates its
   momentum from its local gradient (:func:`fused_lion.fused_apply`, one
   launch per bucket, in place on the flat buffers).

Buckets are ``codec.bucket_bounds`` of the flat buffers (the same
boundaries as the JAX package), so a bucket is one window and one launch,
where the JAX package launches once per leaf window. Momentum is rank-local:
the JAX package's ``[world, ...]`` stacked momentum is that, stacked.

The stochastic mode (``max_grad_norm`` set) follows the JAX package's XLA
path (:703-800) in plain PyTorch ops, in the same bucket pipeline: the
ballot is +1 with probability ``clip((u + r)/2r, 0, 1)``
(``lion_math.stochastic_vote_bool``), drawn from a generator seeded by
``(seed, step count, rank)`` (``lion_math.stochastic_generator``, the step
count read from the host's ``LionState.steps``); the update decays, then
applies the elected sign, each rounded to the param dtype as the XLA path
rounds them.

With ``telemetry=True`` each bucket also runs
:func:`fused_lion.bucket_vote_stats` on its ballots and its tally, and
packs its election (``codec.pack_signs``), after the tally arrives and
before the bucket applies; ``step`` then returns ``(state, frame)``, the
JAX package's vote-health frame (:437-463, :504-518, with the stochastic
flip fraction of :854-862) for ``train.telemetry.fold``. Telemetry only
observes: the elections and the update are the same with it on or off.

Ported: the deterministic and the stochastic modes with ``vote_every ==
1`` and uniform dtypes, on the three flat wires and the synchronous
``hier:<g>`` wire, momentum in the param dtype, and vote-health
telemetry; and :func:`remap_worker_momentum`, the elastic resume's remap of
the per-rank momenta to another world size. Refused, naming their ROADMAP
items: lazy refresh (``vote_every
> 1``), the DCN pipeline (``dcn_pipeline_depth``) and the vote guard
(``guard``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.ops import fused_lion, lion_math
from distributed_lion_tpu_torch.ops.codec import bucket_bounds, pack_signs, parse_wire
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
from distributed_lion_tpu_torch.parallel.mesh import DATA_AXIS, rank_of
from distributed_lion_tpu_torch.train import telemetry as _vt


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet ({item})")


class DistributedLion:
    """The majority-vote optimizer over a :class:`FlatParams`. ``group`` is
    the vote's process group (None: a world of one, no collective).
    ``max_grad_norm`` selects stochastic binarization, whose draws
    ``seed`` seeds. ``tally`` optionally records the bytes each collective
    hands the backend (:class:`collectives.WireTally`); ``telemetry`` makes
    ``step`` return the vote-health frame too. A ``hier:<g>`` wire builds
    its process groups here, so every rank builds the optimizer."""

    def __init__(self, learning_rate: Schedule = 1e-4, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 0.0, *, group=None,
                 wire: str = "sign_psum", vote_buckets: int = 1,
                 max_grad_norm: Optional[float] = None, seed: Optional[int] = None,
                 tally: Optional[collectives.WireTally] = None,
                 telemetry: bool = False):
        kind, size = parse_wire(wire)
        _validate(learning_rate, b1, b2)
        if vote_buckets < 1:
            raise ValueError(f"vote_buckets must be >= 1, got {vote_buckets}")
        if max_grad_norm is not None and seed is None:
            raise ValueError("stochastic binarization (max_grad_norm) draws its ballots "
                             "from a seed; pass seed")
        if max_grad_norm is not None and not max_grad_norm > 0:
            raise ValueError(f"max_grad_norm must be > 0, got {max_grad_norm}")
        self.learning_rate, self.b1, self.b2 = learning_rate, b1, b2
        self.weight_decay = weight_decay
        self.group, self.wire, self.vote_buckets = group, wire, vote_buckets
        self.max_grad_norm, self.seed = max_grad_norm, seed
        self.tally = tally
        self.telemetry = telemetry
        self.world, self.rank = collectives.world_of(group), rank_of(group)
        self.hier = (collectives.HierGroups(group, size)
                     if kind == "hier" and group is not None else None)

    def init(self, flat: FlatParams) -> LionState:
        return init_state(flat)

    @torch.no_grad()
    def step(self, flat: FlatParams, state: LionState):
        """One optimizer step from ``flat.grads``; updates ``flat.params``
        and ``state.exp_avg`` in place. Returns the new state, or
        ``(state, frame)`` with telemetry on."""
        lr = resolve_lr(self.learning_rate, state.count)
        p, g, m = flat.params, flat.grads, state.exp_avg
        frame = _vt.empty_frame(0, flat.device) if self.telemetry else None
        stochastic = self.max_grad_norm is not None
        if stochastic:
            gen = lion_math.stochastic_generator(self.seed, state.steps, self.rank, flat.device)
            if frame is not None:  # ballots that differ from the deterministic ones
                flips = torch.zeros((), dtype=torch.int64, device=flat.device)
        packed: list = []
        pending = None
        for start, size in bucket_bounds(flat.numel, self.vote_buckets,
                                         self.world, self.wire):
            w = slice(start, start + size)
            if stochastic:
                vote_pos = lion_math.stochastic_vote_bool(g[w], m[w], self.b1,
                                                          self.max_grad_norm, gen)
                ballots = torch.where(vote_pos, 1, -1).to(torch.int8)
                if frame is not None:
                    flips += (vote_pos != lion_math.sign_vote_bool(g[w], m[w], self.b1)).sum()
            else:
                ballots = fused_lion.fused_ballots(g[w], m[w], self.b1)
            vote = collectives.vote_total_async(ballots, self.wire, self.group, self.tally,
                                                keep_ballots=self.telemetry, hier=self.hier)
            if pending is not None:  # apply k−1 while bucket k is on the wire
                self._apply(p, g, m, lr, frame, packed, *pending)
            pending = (w, ballots, vote)
        if pending is not None:
            self._apply(p, g, m, lr, frame, packed, *pending)
        state = LionState(state.count + 1, m, state.steps + 1)
        if frame is None:
            return state
        n = torch.tensor(flat.numel, dtype=torch.int32, device=flat.device)
        if not _vt.tally_wire(self.wire):  # a ±1 proxy carries no margin
            frame["margin_hist"].zero_()
        # bucket boundaries are byte-aligned, so the per-bucket packed
        # elections concatenate to the packed full vector
        frame.update(elected=torch.cat(packed) if packed else frame["elected"],
                     voted=n, valid=n,
                     flip_valid=torch.ones_like(frame["flip_valid"]))
        if stochastic:
            frame["stoch_flip_frac"] = flips.to(torch.float32) / flat.numel
        return state, frame

    def _apply(self, p, g, m, lr, frame, packed, w: slice, ballots, vote):
        total = vote.wait()
        if frame is not None:
            hist, dis = fused_lion.bucket_vote_stats(ballots, total, self.world, _vt.NBINS)
            frame["margin_hist"] += hist
            frame["disagree"] += dis
            packed.append(pack_signs(total > 0))
        if self.max_grad_norm is None:
            fused_lion.fused_apply(p[w], g[w], m[w], total, lr, self.weight_decay, self.b2)
            return
        decayed = lion_math.decay_params(p[w], lr, self.weight_decay)
        p[w] = lion_math.apply_signed_update(decayed, total > 0, lr)
        m[w] = lion_math.momentum_update(g[w], m[w], self.b2)


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
    seed: Optional[int] = None,
):
    """Build the majority-vote Lion optimizer, as the JAX package's
    ``distributed_lion``. ``axis_name=None`` is the local-Lion fallback;
    otherwise the vote runs over ``group``, defaulting to the started
    default process group, or to a world of one when there is none.
    ``seed`` seeds the stochastic mode (the JAX package's init rng); a
    stochastic optimizer without one is refused."""
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
    if vote_every > 1:
        _refuse("lazy sign refresh (vote_every > 1)", "ROADMAP Queue 1 item 4")
    if dcn_pipeline_depth > 0:
        _refuse("the cross-step DCN pipeline (dcn_pipeline_depth)",
                "ROADMAP Queue 1 item 11")
    if guard != "off":
        _refuse(f"the vote guard (guard={guard!r})", "ROADMAP Queue 1 item 10")
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    return DistributedLion(learning_rate, b1, b2, weight_decay, group=group,
                           wire=wire, vote_buckets=vote_buckets,
                           max_grad_norm=max_grad_norm, seed=seed, tally=tally,
                           telemetry=telemetry)



def remap_worker_momentum(exp_avg: torch.Tensor, old_world: int, new_world: int) -> torch.Tensor:
    """Remap per-rank Lion momenta stacked ``[W, ...]`` (one row per rank's
    momentum file) to ``[W', ...]`` for an elastic resume, as the JAX
    package's ``remap_worker_momentum``; every policy keeps the
    cross-worker mean, the center of the vote:

    - ``W' == W``: the input itself;
    - ``W' < W`` with ``W % W' == 0``: new rank i takes the mean of old
      ranks ``[i*g, (i+1)*g)``, ``g = W/W'``;
    - ``W' > W`` with ``W' % W == 0``: each old rank's momentum is repeated
      ``W'/W`` times;
    - otherwise every new rank takes the mean of all old ranks.

    Means are taken in float32 and cast back to the momentum's dtype: the
    terms summed in rank order, then times the float32 reciprocal of their
    count, which is how XLA on the CPU reduces up to 32 terms, so the
    result equals the JAX package's bit for bit at those worlds."""
    if new_world == old_world:
        return exp_avg
    if new_world < 1 or old_world < 1:
        raise ValueError(f"invalid world sizes {old_world}->{new_world}")
    if exp_avg.shape[0] != old_world:
        raise ValueError(f"momentum has leading dim {exp_avg.shape[0]}, expected old world "
                         f"{old_world}")
    f32 = exp_avg.to(torch.float32)

    def mean(rows: torch.Tensor) -> torch.Tensor:  # over dim 1, in order
        total = rows[:, 0]
        for i in range(1, rows.shape[1]):
            total = total + rows[:, i]
        return total * torch.tensor(1.0 / rows.shape[1], dtype=torch.float32)

    if old_world % new_world == 0:
        out = mean(f32.reshape((new_world, old_world // new_world) + f32.shape[1:]))
    elif new_world % old_world == 0:
        out = f32.repeat_interleave(new_world // old_world, dim=0)
    else:
        out = mean(f32[None]).expand((new_world,) + f32.shape[1:])
    return out.to(exp_avg.dtype).contiguous()
