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

**Momentum dtype.** ``mom_dtype`` (``bfloat16`` halves the per-rank
state) stores the momentum apart from the param dtype. Each step first
casts the flat grads into a buffer the optimizer owns, in the momentum
dtype (JAX ``step``, :681); every ballot and update reads that cast. The
deterministic step at ``vote_every == 1`` runs the fused kernels at any
(param, momentum) dtype pair, float32 params with bfloat16 grads and
momentum among them, as the JAX fused path's gate (:696-701) admits it.

**Lazy sign refresh** (``vote_every`` K > 1; JAX ``_elect_lazy``,
:573-650, and the lazy branch of ``step``, :806-852). ``LionState.elected``
caches the packed elected signs of ``K * chunk`` coordinates, ``chunk =
codec.vote_chunk_elems(n, K)``, replicated across ranks. At step ``count``
slot ``s = count mod K`` votes the slice ``[s*chunk, (s+1)*chunk)`` of the
ballot vector, padded past n with −1 ballots (the JAX package pads with
False votes), through the same bucketed wire (``bucket_bounds`` over the
slice); the slice's packed election lands in the cache at byte
``s*chunk/8``. The update then follows the XLA path: every coordinate
decays; a coordinate whose slot has voted (slot <= count: after the first
K − 1 steps, all) moves by ``-lr`` times its cached sign, the others do not
move; momentum updates from the local gradient everywhere. The slice's
ballots come from :func:`fused_lion.fused_ballots` on the slot's window at
float32 momentum, whose rounding (per op, float32) is the XLA path's there;
at bfloat16 momentum XLA:CPU rounds every op to bfloat16 with bfloat16
constants, which the kernel (float32 math, float32 constants) does not, so
the ballots are plain ops in the momentum dtype
(``lion_math.sign_vote_bool``). The update runs :func:`fused_lion.fused_apply`
over the voted slots' window, with the cache's bits as its tally
(``lion_math.cache_tally``), where params and momentum are float32: there
the kernel's per-op rounding is the XLA path's, bit for bit; the window
past them (cold start only) decays and updates momentum in plain ops, and
every other dtype pair runs ``lion_math.lazy_update``. With telemetry the
frame covers the slice: its histogram and disagreement the slice's real
coordinates (:func:`fused_lion.bucket_vote_stats` per bucket), ``elected``
the refreshed cache, ``voted`` the slice's real coordinates, ``valid`` the
coordinates that moved, ``flip_valid`` from step K on (the slot's previous
bytes are a real election only after one rotation).

**Lazy refresh under stochastic binarization** (``vote_every`` K > 1 with
``max_grad_norm``; JAX ``_elect_lazy`` over the stochastic ballots). The
JAX package draws the whole ballot vector and votes the slot's slice of it;
the port draws only the slice, bucket by bucket from
``stochastic_generator(seed, count, rank)`` in plain ops (as the
every-step stochastic mode), which has the same law since the other draws
are discarded. :meth:`DistributedLion.replay_slice_ballots` draws them
again from the same three numbers. The vote, the cache and the apply are
the deterministic lazy path's. With telemetry ``stoch_flip_frac`` is the
JAX package's full-vector mean: the coordinates outside the slice draw
after it from the same stream, for the fraction only, so the voted ballots
are the same with telemetry on or off.

**The vote guard** (``guard='observe'|'enforce'``; JAX ``guard``, :152,
:235-255, :286-310, :338-347, :350-368, :410-416, :446-492, :573-650,
:676-800), in all three modes. ``LionState`` then carries the ``[W]``
health mask and this rank's packed previous ballot
(:func:`optim.lion.guard_ballot_len` bytes). Each step first counts the
nonfinite coordinates of the local grads (cast to the momentum dtype) and
momentum, before anything else reads them; under ``enforce`` it then zeroes
the nonfinite grad coordinates in place (``isfinite`` where, as JAX's
``jnp.where``; ``nan_to_num`` would map inf elsewhere), so neither the
ballot nor the momentum update sees them, and elects with ``alive =
state.health`` (``parallel.collectives``' masked election). The guard reads
this rank's UNMASKED ballots (the wire zeroes its own buffer), packs them
into ``prev_ballot`` in place, window by window (:func:`guard_vote`), and emits the guard frame: ``nonfinite``,
``flips`` (popcount of the XOR with the previous packed ballot),
``disagree`` (the int count of ballots that lost, cast to float32, over
the voted coordinates), replicated ``[W]`` vectors from one
``all_reduce`` of a stacked ``[3, W]`` float64 tensor (exact for every
count below 2**53), and ``flip_valid`` and ``voted``. The counts are int64,
where JAX's are int32; only ``> 0`` and ``== 0`` of them are read. Under
lazy refresh ``prev_ballot`` has the elected cache's slot layout and the
slot's bytes are refreshed, ``flip_valid`` from step K on, and
``disagree`` is over the slot's real coordinates. ``observe`` computes the
same frame and never touches the election or the grads; with an
all-healthy mask and finite inputs ``enforce`` is bit-identical to
``off``. :func:`heal_worker_momentum` (stacked rows) and
:func:`heal_rank_momentum` (rank-local rows over the group) re-average a
quarantined rank's momentum from the healthy mean.

**The cross-step DCN pipeline** (``dcn_pipeline_depth`` d > 0, the
``hier:<g>`` wire only; JAX ``_hier_pipelined``, :521-571, and the
pipelined branches of ``step``, :737-775, :573-650, :820-852). Each step,
bucket by bucket, launches its ballots into ring slot ``count mod d``
(``parallel.collectives.hier_launch``: legs 1 and 2) and consumes the
segment it replaces, launched d steps ago (``hier_consume``: the masks and
leg 3), so the step applies the complete election of step ``count − d``'s
ballots, the same on every rank. ``LionState.dcn_ring`` holds this rank's
``[d, codec.hier_ring_slot_bytes]`` uint8 slots, byte for byte the JAX
package's row of its ``[world, d, …]`` ring. (``LionState.moe_ring``, the
MoE balance ring of ``--ep_dcn_pipeline``, is the trainer's: every step
here passes it through untouched, as JAX :941-953.) The JAX package routes these
steps to its XLA path; the port keeps its kernels where they compute the
same bits: the ballots are :func:`fused_lion.fused_ballots` (or the
stochastic draws), and from step d + 1 each bucket runs
:func:`fused_lion.fused_apply` with the consumed election as its ±1
tally. For the first d steps nothing has landed: every coordinate decays
and its momentum updates, in plain ops, and no sign step is taken. With
telemetry the frame's histogram is zero (``hier`` is a proxy wire), its
disagreement is the fresh ballots against the stale election
(:func:`fused_lion.bucket_vote_stats`, from step d + 1), ``voted`` and
``valid`` are 0 until an election has landed, ``flip_valid`` from step
d + 2; the guard's ``prev_ballot`` tracks the launched ballots, its
disagreement the stale election, 0 in the cold start. Under lazy refresh
the launched slice is slot ``count mod K`` as always, the consumed
election is of slot ``(count − d) mod K`` and lands in the cache there (the
cache keeps its bytes while nothing has landed), a slot's coordinates move
from step ``slot + d + 1`` on, the frame's disagreement is 0 (the two
slices are different coordinates) and ``flip_valid`` starts at step
K + d + 1. Leg 2 is waited on inside the launch: the bytes are those a
handle kept pending across steps would give.

**Mixed param dtypes** (JAX ``step``'s XLA path for a tree whose leaves do
not share one dtype, :696-701, :703-731, :863-868). ``FlatParams`` keeps one
buffer per dtype and the momentum one buffer per param buffer; the ballots,
the packed vote bytes, the buckets, the elections, the lazy slices, the DCN
ring, the telemetry frame and the guard's previous ballot all run over the
leaf-order flat coordinates, whose windows :meth:`FlatParams.runs` maps onto
the buffers, so the ballot vector is JAX's ``_flatten_votes`` of the tree.
Each window's ballots and update run through the kernels, as a
single-dtype tree's do: they read and write the window's own dtypes and
compute in float32. For float32 windows that is the XLA path's bits up to
its FMAs; for bfloat16 ones it rounds once where the XLA path rounds every
op in bfloat16 (ROADMAP Queue 3, "two apply paths"), so a ballot whose
u-term lies within those roundings of zero can differ from JAX's.

Ported: the deterministic and the stochastic modes on the three flat wires
and the ``hier:<g>`` wire with its DCN pipeline, lazy refresh in both
modes, ``mom_dtype``, mixed param dtypes, vote-health telemetry and the
vote guard; and :func:`remap_worker_momentum`, the elastic resume's remap of
the per-rank momenta to another world size.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.ops import fused_lion, lion_math
from distributed_lion_tpu_torch.ops.codec import (
    bucket_bounds,
    hier_chunk_slot_bytes,
    hier_ring_slot_bytes,
    pack_signs,
    parse_wire,
    popcount,
    vote_chunk_elems,
)
from distributed_lion_tpu_torch.optim.lion import (
    FlatParams,
    LionState,
    Schedule,
    _validate,
    init_state,
    lion,
    momenta,
    resolve_lr,
    resolve_mom_dtype,
)
from distributed_lion_tpu_torch.parallel import collectives
from distributed_lion_tpu_torch.parallel.mesh import DATA_AXIS, rank_of
from distributed_lion_tpu_torch.train import telemetry as _vt


GUARD_MODES = ("off", "observe", "enforce")
# coordinates a pass of the guard's input check, its reads of the vote and
# the momentum heal covers at once: bounds their temporaries (a bool mask,
# packed bytes, W float32 rows). A multiple of 8, so windows pack to whole
# bytes; read at call time.
GUARD_WINDOW = 1 << 26


def ballot_flips(packed_now: torch.Tensor, packed_prev: torch.Tensor) -> torch.Tensor:
    """Bit flips between two packed ballots (JAX ``_ballot_flips``): ≈ 0
    across consecutive votes is the frozen voter's signature."""
    return popcount(torch.bitwise_xor(packed_now, packed_prev))


def guard_inputs(g: torch.Tensor, m: torch.Tensor, sanitize: bool) -> torch.Tensor:
    """The int64 count of nonfinite coordinates in ``g`` and ``m`` (JAX
    ``_nonfinite_count``, measured before anything else reads them); with
    ``sanitize`` the nonfinite coordinates of ``g`` are then zeroed in
    place. Window by window, so the mask never spans the whole buffer."""
    nf = torch.zeros((), dtype=torch.int64, device=g.device)
    for lo in range(0, g.numel(), GUARD_WINDOW):
        gw = g[lo:lo + GUARD_WINDOW]
        bad = ~torch.isfinite(gw)
        nf += bad.sum() + (~torch.isfinite(m[lo:lo + GUARD_WINDOW])).sum()
        if sanitize:
            gw.masked_fill_(bad, 0)
    return nf


def guard_vote(guard: dict, prev: torch.Tensor, byte0: int, ballots: torch.Tensor,
               total: Optional[torch.Tensor], real: int) -> None:
    """The guard's reads of one bucket's vote, window by window: into
    ``guard['dis']`` the count of this rank's unmasked ballots that lost
    the election ``total`` (None: none to compare with), over the first
    ``real`` coordinates; into ``guard['flips']`` the bit flips of the
    packed ballots against ``prev`` from byte ``byte0``, which they then
    overwrite in place."""
    for lo in range(0, ballots.numel(), GUARD_WINDOW):
        mine = ballots[lo:lo + GUARD_WINDOW] > 0
        r = max(0, min(mine.numel(), real - lo))
        if total is not None:
            guard["dis"] += (mine[:r] != (total[lo:lo + r] > 0)).sum()
        now = pack_signs(mine)
        old = prev[byte0 + lo // 8:byte0 + lo // 8 + now.numel()]
        guard["flips"] += ballot_flips(now, old)
        old.copy_(now)

class DistributedLion:
    """The majority-vote optimizer over a :class:`FlatParams`. ``group`` is
    the vote's process group (None: a world of one, no collective).
    ``max_grad_norm`` selects stochastic binarization, whose draws
    ``seed`` seeds. ``vote_every`` K > 1 votes a rotating 1/K slice a step;
    ``mom_dtype`` stores the momentum in that dtype. ``tally`` optionally
    records the bytes each collective hands the backend
    (:class:`collectives.WireTally`); ``telemetry`` makes ``step`` return
    the vote-health frame too, and ``guard`` (``'observe'``,
    ``'enforce'``) the guard frame after it. ``dcn_pipeline_depth`` d > 0
    pipelines a ``hier:<g>`` wire's cross-group leg across d steps. A
    ``hier:<g>`` wire builds its process groups here, so every rank builds
    the optimizer."""

    def __init__(self, learning_rate: Schedule = 1e-4, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 0.0, *, group=None,
                 wire: str = "sign_psum", vote_buckets: int = 1, vote_every: int = 1,
                 mom_dtype=None, max_grad_norm: Optional[float] = None,
                 seed: Optional[int] = None,
                 tally: Optional[collectives.WireTally] = None,
                 telemetry: bool = False, guard: str = "off",
                 dcn_pipeline_depth: int = 0):
        kind, size = parse_wire(wire)
        if guard not in GUARD_MODES:
            raise ValueError(f"guard must be 'off', 'observe' or 'enforce', got {guard!r}")
        _check_depth(dcn_pipeline_depth, kind, wire)
        _validate(learning_rate, b1, b2)
        if vote_buckets < 1:
            raise ValueError(f"vote_buckets must be >= 1, got {vote_buckets}")
        if vote_every < 1:
            raise ValueError(f"vote_every must be >= 1, got {vote_every}")
        if max_grad_norm is not None and seed is None:
            raise ValueError("stochastic binarization (max_grad_norm) draws its ballots "
                             "from a seed; pass seed")
        if max_grad_norm is not None and not max_grad_norm > 0:
            raise ValueError(f"max_grad_norm must be > 0, got {max_grad_norm}")
        self.learning_rate, self.b1, self.b2 = learning_rate, b1, b2
        self.weight_decay = weight_decay
        self.group, self.wire, self.vote_buckets = group, wire, vote_buckets
        self.vote_every, self.mom_dtype = vote_every, resolve_mom_dtype(mom_dtype)
        self.max_grad_norm, self.seed = max_grad_norm, seed
        self.tally = tally
        self.telemetry = telemetry
        self.guard = guard
        self.world, self.rank = collectives.world_of(group), rank_of(group)
        self.depth = dcn_pipeline_depth
        if kind == "hier" and group is not None:
            self.hier = collectives.HierGroups(group, size)
        elif kind == "hier" and dcn_pipeline_depth > 0:
            if size != 1:
                raise ValueError(f"hier wire: group size {size} does not divide world 1")
            self.hier = collectives.HierGroups.local()
        else:
            self.hier = None
        self._g_cast: dict = {}   # buffer index -> the grads cast to its momentum dtype

    def init(self, flat: FlatParams) -> LionState:
        ring = None
        if self.depth > 0:
            ring = (self.depth, hier_ring_slot_bytes(flat.numel, self.world, self.hier.size,
                                                     self.vote_buckets, self.vote_every))
        return init_state(flat, self.mom_dtype, self.vote_every,
                          self.world if self.guard != "off" else 0, ring)

    def _grads(self, flat: FlatParams, ms: list) -> list:
        """Each grad buffer in its momentum's dtype: the buffer itself, or one
        cast into a buffer this optimizer owns."""
        out = []
        for k, (g, m) in enumerate(zip(flat.grad_bufs, ms)):
            if g.dtype != m.dtype:
                cast = self._g_cast.get(k)
                if cast is None or cast.shape != m.shape or cast.dtype != m.dtype:
                    cast = self._g_cast[k] = torch.empty_like(m)
                g = cast.copy_(g)
            out.append(g)
        return out

    def _ballots(self, flat: FlatParams, gs: list, ms: list, lo: int, hi: int, gen,
                 flips) -> torch.Tensor:
        """The int8 ±1 ballots of the flat coordinates ``[lo, hi)``, window
        by window of the buffers: stochastic draws from ``gen`` (their
        differences from the deterministic ballots counted into ``flips``
        where it is a tensor), else the ballot kernel, or under lazy
        refresh with a momentum that is not float32 the XLA path's plain
        ops (``sign_vote_bool`` in the momentum dtype), as JAX's lazy
        refresh votes."""
        plain = self.vote_every > 1
        parts = []
        for k, a, b, _ in flat.runs(lo, hi):
            g, m = gs[k][a:b], ms[k][a:b]
            if gen is not None:
                vote_pos = lion_math.stochastic_vote_bool(g, m, self.b1, self.max_grad_norm, gen)
                if flips is not None:
                    flips += (vote_pos != lion_math.sign_vote_bool(g, m, self.b1)).sum()
                parts.append(torch.where(vote_pos, 1, -1).to(torch.int8))
            elif plain and m.dtype != torch.float32:
                parts.append(lion_math.sign_vote_bool(g, m, self.b1).to(torch.int8) * 2 - 1)
            else:
                parts.append(fused_lion.fused_ballots(g, m, self.b1))
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts) if parts else torch.empty(0, dtype=torch.int8,
                                                          device=flat.device)

    @torch.no_grad()
    def step(self, flat: FlatParams, state: LionState):
        """One optimizer step from ``flat.grads``; updates ``flat.params``
        and ``state.exp_avg`` in place. Returns the new state, or
        ``(state, frame)`` with telemetry on."""
        lr = resolve_lr(self.learning_rate, state.count)
        ps, ms = flat.param_bufs, momenta(state)
        gs = self._grads(flat, ms)
        bufs = (flat, ps, gs, ms)
        frame = _vt.empty_frame(0, flat.device) if self.telemetry else None
        guard = None
        if self.guard != "off":
            # nonfinite ballot inputs, counted before the sanitize and
            # before the sign hides them (a NaN u-term votes −1)
            zero = torch.zeros((), dtype=torch.int64, device=flat.device)
            nf = zero.clone()
            for g, m in zip(gs, ms):
                nf += guard_inputs(g, m, self.guard == "enforce")
            guard = {"nf": nf, "dis": zero, "flips": zero.clone(), "prev": state.prev_ballot}
        if self.vote_every > 1:
            return self._step_lazy(bufs, state, lr, frame, guard)
        count, depth = state.steps, self.depth
        # under the DCN pipeline the step applies the election launched
        # depth steps ago: none in the first depth steps
        landed = count >= depth
        if depth:
            row, segs = self._ring_row(state, flat.numel)
        stochastic = self.max_grad_norm is not None
        gen = flips = None
        if stochastic:
            gen = lion_math.stochastic_generator(self.seed, count, self.rank, flat.device)
            if frame is not None:  # ballots that differ from the deterministic ones
                flips = torch.zeros((), dtype=torch.int64, device=flat.device)
        packed: list = []
        pending = None
        for i, (start, size) in enumerate(bucket_bounds(flat.numel, self.vote_buckets,
                                                        self.world, self.wire)):
            w = slice(start, start + size)
            ballots = self._ballots(flat, gs, ms, start, start + size, gen, flips)
            if depth:
                total = self._pipe(ballots, state, row, segs[i], size)
                vote = collectives.PendingVote(lambda total=total: total)
            else:
                vote = self._vote(ballots, state, guard)
            if pending is not None:  # apply k−1 while bucket k is on the wire
                self._apply(bufs, lr, frame, packed, guard, landed, *pending)
            pending = (w, ballots, vote)
        if pending is not None:
            self._apply(bufs, lr, frame, packed, guard, landed, *pending)
        gframe = None
        if guard is not None:  # prev_ballot now holds this step's ballots
            gframe = self._guard_frame(guard["nf"], guard["flips"], count >= 1,
                                       guard["dis"], flat.numel)
        state = state._replace(count=state.count + 1, steps=count + 1)
        if frame is None:
            return state if gframe is None else (state, gframe)
        n = torch.tensor(flat.numel if landed else 0, dtype=torch.int32, device=flat.device)
        if not _vt.tally_wire(self.wire):  # a ±1 proxy carries no margin
            frame["margin_hist"].zero_()
        # bucket boundaries are byte-aligned, so the per-bucket packed
        # elections concatenate to the packed full vector; a pipelined
        # election is a real previous one from the second that lands
        frame.update(elected=torch.cat(packed) if packed else frame["elected"],
                     voted=n, valid=n,
                     flip_valid=torch.full_like(frame["flip_valid"],
                                                count >= depth + 1 if depth else True))
        if stochastic:
            frame["stoch_flip_frac"] = flips.to(torch.float32) / flat.numel
        return (state, frame) if gframe is None else (state, frame, gframe)

    def _vote(self, ballots, state: LionState, guard):
        """Start one bucket's vote: masked by the health mask under
        ``enforce``; the ballots kept intact where telemetry or the guard
        reads them after the tally."""
        return collectives.vote_total_async(
            ballots, self.wire, self.group, self.tally,
            keep_ballots=self.telemetry or guard is not None, hier=self.hier,
            alive=state.health if self.guard == "enforce" else None, count=state.steps)

    def _ring_row(self, state: LionState, n_ballot: int) -> tuple:
        """The DCN ring's row this step consumes and refills, slot ``count
        mod d``, and each vote bucket's segment of it."""
        segs, off = [], 0
        for _, size in bucket_bounds(n_ballot, self.vote_buckets, self.world, self.wire):
            seg = hier_chunk_slot_bytes(size, self.world, self.hier.size)
            segs.append(slice(off, off + seg))
            off += seg
        ring = state.dcn_ring
        if ring.shape[-1] != off:
            raise ValueError(
                f"dcn_ring slot holds {ring.shape[-1]} bytes but this ballot/bucket layout "
                f"needs {off} — the ring was built for a different world/wire/bucket config "
                "(init_global_state and the step must agree)")
        return ring[state.steps % self.depth], segs

    def _pipe(self, ballots, state: LionState, row: torch.Tensor, seg: slice,
              n: int) -> torch.Tensor:
        """One bucket of the DCN pipeline: launch ``ballots`` into
        ``row[seg]`` and return the election of the segment they replace,
        launched ``depth`` steps ago."""
        alive = state.health if self.guard == "enforce" else None
        tally = self.tally if self.tally is not None else collectives.WireTally()
        launch = collectives.hier_launch(ballots, self.hier, tally, alive, self.group,
                                         state.steps)
        total = collectives.hier_consume(row[seg], n, self.hier, tally, alive, state.steps,
                                         self.depth)
        row[seg] = launch.wait()
        return total

    def _guard_frame(self, nf, flips, flip_valid: bool, dis, voted: int) -> dict:
        """The guard frame (JAX ``_guard_frame``): the three per-rank
        scalars become replicated ``[W]`` vectors through one
        ``all_reduce`` of a one-hot ``[3, W]`` float64 tensor; ``disagree``
        is the count cast to float32 over ``voted`` (1 when nothing was
        voted), as JAX divides it."""
        dev = nf.device
        vec = torch.zeros(3, self.world, dtype=torch.float64, device=dev)
        vec[0, self.rank] = nf
        vec[1, self.rank] = flips
        vec[2, self.rank] = dis.to(torch.float32) / max(voted, 1)
        if self.group is not None:
            dist.all_reduce(vec, group=self.group)
        # filled on the device: a tensor made from a host value would wait
        # for the card
        return {"nonfinite": vec[0].to(torch.int64), "flips": vec[1].to(torch.int64),
                "flip_valid": torch.full((), bool(flip_valid), device=dev),
                "disagree": vec[2].to(torch.float32),
                "voted": torch.full((), voted, dtype=torch.int64, device=dev)}

    def _apply(self, bufs: tuple, lr, frame, packed, guard, landed: bool, w: slice, ballots,
               vote):
        """Apply one bucket's election, window by window of the buffers;
        ``landed`` False (the DCN pipeline's first steps): decay and
        momentum only, in plain ops. The apply kernel, except under
        stochastic binarization: the XLA path's plain ops there."""
        total = vote.wait()
        if guard is not None:  # this rank's unmasked ballots against the election;
            # bucket boundaries are byte-aligned
            guard_vote(guard, guard["prev"], w.start // 8, ballots, total if landed else None,
                       ballots.numel())
        if frame is not None:
            if landed:
                hist, dis = fused_lion.bucket_vote_stats(ballots, total, self.world, _vt.NBINS)
                frame["margin_hist"] += hist
                frame["disagree"] += dis
            packed.append(pack_signs(total > 0))
        flat, ps, gs, ms = bufs
        for k, a, b, rel in flat.runs(w.start, w.stop):
            p, g, m, t = ps[k][a:b], gs[k][a:b], ms[k][a:b], total[rel:rel + b - a]
            if not landed:
                p.copy_(lion_math.decay_params(p, lr, self.weight_decay))
                m.copy_(lion_math.momentum_update(g, m, self.b2))
            elif self.max_grad_norm is None:
                fused_lion.fused_apply(p, g, m, t, lr, self.weight_decay, self.b2)
            else:
                decayed = lion_math.decay_params(p, lr, self.weight_decay)
                p.copy_(lion_math.apply_signed_update(decayed, t > 0, lr))
                m.copy_(lion_math.momentum_update(g, m, self.b2))

    def _slice_buckets(self, n: int, count: int) -> tuple:
        """``(lo, real, [(start, size, r)])`` of slot ``count mod K``'s slice:
        its first coordinate, its coordinates below n, and each vote bucket's
        offset in the slice, size and coordinates below n."""
        chunk = vote_chunk_elems(n, self.vote_every)
        lo = (count % self.vote_every) * chunk
        real = max(0, min(chunk, n - lo))
        return lo, real, [(start, size, max(0, min(size, real - start)))
                          for start, size in bucket_bounds(chunk, self.vote_buckets,
                                                           self.world, self.wire)]

    def replay_slice_ballots(self, g: torch.Tensor, m: torch.Tensor,
                             count: int) -> torch.Tensor:
        """The bool ballots (True: +1) of slot ``count mod K``'s real
        coordinates under stochastic binarization, drawn as the lazy step
        at host step count ``count`` draws them: from
        ``stochastic_generator(seed, count, rank)``, bucket by bucket. From
        the same g and m they are the ballots that step voted."""
        gen = lion_math.stochastic_generator(self.seed, count, self.rank, g.device)
        lo, _, buckets = self._slice_buckets(g.numel(), count)
        return torch.cat([lion_math.stochastic_vote_bool(
            g[lo + start:lo + start + r], m[lo + start:lo + start + r], self.b1,
            self.max_grad_norm, gen) for start, _, r in buckets])

    def _step_lazy(self, bufs: tuple, state: LionState, lr, frame, guard):
        """The lazy refresh of the module doc: vote slot ``count mod K``'s
        slice bucket by bucket, write its election (under the DCN pipeline
        the election of slot ``(count − d) mod K``'s slice, launched d steps
        ago) into a copy of the cache, apply the cached signs."""
        flat, ps, gs, ms = bufs
        n, k, count, depth = flat.numel, self.vote_every, state.steps, self.depth
        chunk = vote_chunk_elems(n, k)
        lo, real, buckets = self._slice_buckets(n, count)
        landed = count >= depth
        # the slice the applied election belongs to: the launched one at depth 0
        wlo = ((count - depth) % k) * chunk
        if depth:
            row, segs = self._ring_row(state, chunk)
        stochastic = self.max_grad_norm is not None
        gen = flips = None
        if stochastic:
            gen = lion_math.stochastic_generator(self.seed, count, self.rank, flat.device)
            flips = torch.zeros((), dtype=torch.int64, device=flat.device)
        cache = state.elected.clone()      # the frame keeps the old one as its flip base
        pending = []
        for start, size, r in buckets:
            ballots = self._ballots(flat, gs, ms, lo + start, lo + start + r, gen,
                                    flips if frame is not None else None)
            if r < size:  # the slice past n votes −1
                ballots = torch.cat([ballots, ballots.new_full((size - r,), -1)])
            if depth:
                total = self._pipe(ballots, state, row, segs[len(pending)], size)
                vote = collectives.PendingVote(lambda total=total: total)
            else:
                vote = self._vote(ballots, state, guard)
            pending.append((start, size, r, ballots, vote))
        for start, size, r, ballots, vote in pending:
            total = vote.wait()
            if guard is not None:  # the slice's ballots, padding included, into
                # the slot's bytes, which last held them one rotation (K steps)
                # ago; under the pipeline the election is of another slice
                guard_vote(guard, guard["prev"], (lo + start) // 8, ballots,
                           None if depth else total, r)
            if frame is not None and r and not depth:
                hist, dis = fused_lion.bucket_vote_stats(ballots[:r], total[:r], self.world,
                                                         _vt.NBINS)
                frame["margin_hist"] += hist
                frame["disagree"] += dis
            if landed:  # bucket bounds and chunk are multiples of 8: whole bytes
                cache[(wlo + start) // 8:(wlo + start + size) // 8] = pack_signs(total > 0)
        # the slots whose election has landed: 0..count − d
        valid = min(max(count - depth + 1, 0) * chunk, n)
        tally = lion_math.cache_tally(cache, n)
        for j, a, b, rel in flat.runs(0, n):
            p, g, m, t = ps[j][a:b], gs[j][a:b], ms[j][a:b], tally[rel:rel + b - a]
            v = min(max(valid - rel, 0), b - a)   # this window's voted coordinates
            if p.dtype == m.dtype == torch.float32:
                if v:
                    fused_lion.fused_apply(p[:v], g[:v], m[:v], t[:v], lr,
                                           self.weight_decay, self.b2)
                if v < b - a:
                    p[v:] = lion_math.decay_params(p[v:], lr, self.weight_decay)
                    m[v:] = lion_math.momentum_update(g[v:], m[v:], self.b2)
            else:
                p_new, m_new = lion_math.lazy_update(p, g, m, t, v, lr,
                                                     self.weight_decay, self.b2)
                p.copy_(p_new)
                m.copy_(m_new)
        gframe = None
        if guard is not None:
            gframe = self._guard_frame(guard["nf"], guard["flips"], count >= k,
                                       guard["dis"], real)
        state = state._replace(count=state.count + 1, steps=count + 1, elected=cache)
        if frame is None:
            return state if gframe is None else (state, gframe)
        if not _vt.tally_wire(self.wire):
            frame["margin_hist"].zero_()

        def i32(x):
            return torch.tensor(x, dtype=torch.int32, device=flat.device)

        # the real coordinates of the slice whose election landed
        voted = max(0, min(chunk, n - wlo)) if landed else 0
        frame.update(elected=cache, voted=i32(voted), valid=i32(valid),
                     flip_valid=torch.tensor(count >= k + depth, device=flat.device))
        if stochastic:
            # the full vector's flip share, as the JAX package's: the
            # coordinates outside the slice draw after it from the same
            # stream, so the voted ballots do not depend on telemetry
            for wlo, whi in ((0, lo), (lo + real, n)):
                for j, a, b, _ in flat.runs(wlo, whi):
                    g, m = gs[j][a:b], ms[j][a:b]
                    flips += (lion_math.stochastic_vote_bool(g, m, self.b1,
                                                             self.max_grad_norm, gen)
                              != lion_math.sign_vote_bool(g, m, self.b1)).sum()
            frame["stoch_flip_frac"] = flips.to(torch.float32) / n
        return (state, frame) if gframe is None else (state, frame, gframe)


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
    mom_dtype=None,
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
    kind, _ = parse_wire(wire)
    if guard not in GUARD_MODES:
        raise ValueError(f"guard must be 'off', 'observe' or 'enforce', got {guard!r}")
    _check_depth(dcn_pipeline_depth, kind, wire)
    if axis_name is None:
        if max_grad_norm is not None:
            raise ValueError(
                "max_grad_norm (stochastic binarization) requires a vote axis; "
                "pass axis_name or use lion() for the local optimizer")
        if telemetry or guard != "off":
            raise ValueError(
                "telemetry and the vote guard act on the vote; with "
                "axis_name=None there is none — use lion()")
        if dcn_pipeline_depth > 0:
            raise ValueError(
                "dcn_pipeline_depth pipelines the vote wire; with axis_name=None there "
                "is no wire — use lion() for local training")
        return lion(learning_rate, b1, b2, weight_decay, mom_dtype)
    if vote_every < 1:
        raise ValueError(f"vote_every must be >= 1, got {vote_every}")
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    return DistributedLion(learning_rate, b1, b2, weight_decay, group=group,
                           wire=wire, vote_buckets=vote_buckets, vote_every=vote_every,
                           mom_dtype=mom_dtype, max_grad_norm=max_grad_norm, seed=seed,
                           tally=tally, telemetry=telemetry, guard=guard,
                           dcn_pipeline_depth=dcn_pipeline_depth)


def _check_depth(depth: int, kind: str, wire: str) -> None:
    """The JAX package's ``dcn_pipeline_depth`` rules (:264-270)."""
    if depth < 0:
        raise ValueError(f"dcn_pipeline_depth must be >= 0, got {depth}")
    if depth > 0 and kind != "hier":
        raise ValueError(
            f"dcn_pipeline_depth pipelines the hier wire's level-2 (DCN) leg; wire "
            f"{wire!r} has no such leg — use 'hier:<g>' or depth 0")



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


def _masked_mean(rows: torch.Tensor, healthy: torch.Tensor) -> torch.Tensor:
    """The float32 mean of the ``healthy`` rows of ``rows`` ([W, k]): every
    row times its 0/1 weight, summed in rank order, over the healthy count
    (at least 1), as JAX's ``jnp.sum(f32 * mask, axis=0) / denom``."""
    wts = healthy.to(torch.float32)
    f32 = rows.to(torch.float32)
    total = f32[0] * wts[0]
    for i in range(1, f32.shape[0]):
        total = total + f32[i] * wts[i]
    return total / torch.clamp_min(wts.sum(), 1.0)


def heal_worker_momentum(exp_avg: torch.Tensor, healthy, workers) -> torch.Tensor:
    """Reset the rows ``workers`` of per-rank momenta stacked ``[W, ...]``
    to the mean of the ``healthy`` rows, in float32 and cast back (JAX
    ``heal_worker_momentum``, bit for bit: the vote guard's readmission and
    the elastic resume over a checkpoint with quarantined ranks)."""
    healthy = torch.as_tensor(healthy, dtype=torch.bool, device=exp_avg.device)
    out = exp_avg.clone()
    mean = _masked_mean(exp_avg.reshape(exp_avg.shape[0], -1), healthy).to(exp_avg.dtype)
    for w in workers:
        out[int(w)] = mean.view(exp_avg.shape[1:])
    return out


@torch.no_grad()
def heal_rank_momentum(m: torch.Tensor, healthy, workers, group) -> None:
    """:func:`heal_worker_momentum` over rank-local momenta: every rank of
    ``group`` calls it; the ranks in ``workers`` overwrite their ``m`` in
    place with the mean of the ``healthy`` ranks'. Window by window, each
    window gathered from every rank and reduced in rank order, so the result
    is the stacked form's bit for bit and no rank holds more than ``W``
    windows."""
    rank = rank_of(group)
    workers = {int(w) for w in workers}
    healthy = torch.as_tensor(healthy, dtype=torch.bool, device=m.device)
    world = collectives.world_of(group)
    for lo in range(0, m.numel(), GUARD_WINDOW):
        mine = m[lo:lo + GUARD_WINDOW]
        rows = torch.empty((world, mine.numel()), dtype=m.dtype, device=m.device)
        if group is None:
            rows[0] = mine
        else:
            collectives._all_gather(rows.view(-1), mine.contiguous(), group=group)
        if rank in workers:
            mine.copy_(_masked_mean(rows, healthy).to(m.dtype))
