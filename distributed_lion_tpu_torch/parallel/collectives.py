"""Vote collectives over ``torch.distributed``: the wire layer.

Port of ``distributed_lion_tpu/parallel/collectives.py`` (``vote_total``,
:241-306, the packed_a2a election, :359-386, the hier election,
``hier_launch`` + ``hier_consume``, :394-606, and the DCN link emulator,
:111-238):

- ``sign_psum``: the int8 ±1 ballots are summed by one ``all_reduce``
  (int32 when W > 127, where int8 partial sums could overflow). Returns
  the exact tally.
- ``packed_allgather``: 1-bit packed uint8 ballots, one all-gather, then
  unpack and count locally. Returns the exact tally (int32).
- ``packed_a2a``: ``all_to_all_single`` of packed ballot chunks (each rank
  tallies one chunk), then an all-gather of the packed verdicts.
  Returns a ±1 proxy of the elected sign (int8), never the magnitude.
- ``hier:<g>``: a majority of group majorities over groups of g
  consecutive ranks (:class:`HierGroups`), split as the JAX package splits
  it into :func:`hier_launch` and :func:`hier_consume` (:394-560). The
  launch runs leg 1, an ``all_to_all_single`` of ballot chunks inside the
  group, which gives member ``i`` the tally of the chunk it owns, ``(i + 1)
  mod g`` (int8, int32 past g = 127), and leg 2, which gathers the packed
  verdicts of that chunk from the members at the same position in the
  other groups (the only cross-group, ``dcn``, leg); it returns a uint8
  slot segment of the per-group verdicts and the launch-time group mask.
  The consume weighs each group by that mask and by the current one, takes
  the majority, and runs leg 3, the in-group gather of the packed elected
  chunks. The synchronous wire consumes the slot in the step that launched
  it; the DCN pipeline (``optim.distributed_lion``, ``dcn_pipeline_depth``
  d) d steps later, the slot riding ``LionState.dcn_ring`` in between.
  Returns a ±1 proxy (int8). It equals the flat vote at g = 1 and g = W.

Every wire elects +1 exactly where the returned total is > 0; ties elect
−1 (at both levels of the hier wire). With no process group (a world of
one) the total is the rank's own ±1 ballots, as a ``psum`` over a size-1
mesh axis is. :func:`vote_total_async` issues the first collective with
``async_op=True`` and returns a :class:`PendingVote`, so the optimizer can
apply the previous bucket while this one is on the wire.

``alive`` (a ``[W]`` bool tensor, the same on every rank: the vote guard's
health mask) makes every wire a **masked election**, as the JAX package's
``vote_total(alive=...)``: a rank whose bit is off abstains and the
majority threshold shrinks to the healthy quorum ``Σ alive``. On
``sign_psum`` it sends zero ballots; ``packed_allgather`` and
``packed_a2a`` count the healthy rows only and elect where ``count * 2 >
Σ alive``; on ``hier:<g>`` its int8 ballots become 0 in leg 1 (it still
sends its share of the all-to-all), and at level 2 a group with no healthy
member abstains, the threshold being the number of groups that still hold
one. The zeroing goes into the wire's own buffer, never into ``ballots``.
With ``alive`` all true the tally is bit-identical to ``alive=None``, and
the bytes recorded in a :class:`WireTally` do not depend on the mask.

The ``dcn_delay`` fault (``train.resilience``) emulates a slow
cross-group link: each launch stamps the host clock for its optimizer step,
each consume sleeps until the stamp of the step it consumes plus the delay
and records what it paid in :data:`DCN_WAIT`. Unarmed, the gates do
nothing.

``WIRE_TALLY.capture()`` collects every :class:`WireTally` record made
inside it, one ``(leg, bytes)`` per launch, whichever tally the launch
records into: the port's counterpart of the JAX package's
``WIRE_TALLY.capture()`` around an abstract trace. The trainer captures its
first optimizer step (``train.telemetry.measure_step_wire``); outside a
capture nothing is kept.
"""

from __future__ import annotations

import contextlib
import threading
import time
from datetime import timedelta
from typing import Callable, Optional

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.ops.codec import (
    a2a_chunk_bytes,
    hier_legs,
    pack_signs,
    parse_wire,
    unpack_signs,
)
from distributed_lion_tpu_torch.train import resilience

# PyTorch 2.13 adds all_gather_single and deprecates all_gather_into_tensor
# (same arguments); earlier releases have only the latter.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class _WireCapture:
    """The process's capture of :class:`WireTally` records (module doc)."""

    def __init__(self):
        self._entries: Optional[list] = None

    @contextlib.contextmanager
    def capture(self):
        """Collect every record made inside the block into the list it
        yields."""
        entries: list[tuple[str, int]] = []
        outer, self._entries = self._entries, entries
        try:
            yield entries
        finally:
            self._entries = outer

    def record(self, leg: str, nbytes: int) -> None:
        if self._entries is not None:
            self._entries.append((leg, int(nbytes)))


WIRE_TALLY = _WireCapture()


class WireTally:
    """Bytes handed to the collective backend, recorded per launch as
    ``(leg, received_bytes)`` with the same per-leg convention as the JAX
    package's ``WireTally`` and ``codec.wire_bytes_per_param`` (bytes
    RECEIVED per rank). A world of one records nothing: no bytes move.
    Each record also goes to an open ``WIRE_TALLY.capture()``."""

    def __init__(self):
        self.entries: list[tuple[str, int]] = []

    def record(self, leg: str, nbytes: int) -> None:
        if nbytes > 0:
            self.entries.append((leg, int(nbytes)))
            WIRE_TALLY.record(leg, nbytes)

    def total(self) -> int:
        return sum(b for _, b in self.entries)


class PendingVote:
    """A vote whose first collective is in flight; :meth:`wait` finishes it
    and returns the tally. On NCCL the wait orders the current stream after
    the collective and does not block the host."""

    def __init__(self, finish: Callable[[], torch.Tensor]):
        self._finish = finish

    def wait(self) -> torch.Tensor:
        return self._finish()


def world_of(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


_SIDE_COUNT: dict[tuple[int, ...], int] = {}


def side_group(group, timeout: timedelta):
    """A gloo group over ``group``'s ranks for host-side agreement off the
    main group (the checkpoint commit, the preemption flag). Only the
    members of ``group`` build it, in the same order on each: it is a
    gloo backend on a prefix of the default store, named by the member
    ranks and a per-process count, where ``dist.new_group`` would be
    collective over the whole default group (and its local form names the
    group by how many groups each process holds, which differs between
    members of different subgroups). ``dist`` collectives take it as a
    group."""
    ranks = tuple(dist.get_process_group_ranks(group))
    k = _SIDE_COUNT.get(ranks, 0)
    _SIDE_COUNT[ranks] = k + 1
    store = dist.PrefixStore(f"dlion_side/{'_'.join(map(str, ranks))}/{k}/",
                             dist.distributed_c10d._get_default_store())
    return dist.ProcessGroupGloo(store, ranks.index(dist.get_rank()), len(ranks), timeout)


class HierGroups:
    """The process groups of the ``hier:<g>`` wire over ``group``: each
    rank's own group of g consecutive ranks (``intra``) and the ranks at its
    position in every group (``cross``); None where a group would hold one
    rank. ``dist.new_group`` is collective over the default group, so every
    rank of it builds this, in the same order, once (the optimizer does so
    at init). Where ``group`` is one of several vote groups (the data groups
    of a dp × tp grid), the ranks first gather every group's members and
    each process builds the subgroups of all of them, in one order."""

    def __init__(self, group, size: int):
        ranks = dist.get_process_group_ranks(group)
        w = len(ranks)
        if w % size:
            raise ValueError(f"hier wire: group size {size} does not divide world {w}")
        me = dist.get_rank(group)
        self.size, self.n_groups = size, w // size
        self.intra = self.cross = None
        peers = [tuple(ranks)]
        if w < dist.get_world_size():
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, tuple(ranks))
            peers = sorted(set(every))
        for part in peers:
            mine = part == tuple(ranks)
            for k in range(self.n_groups if size > 1 else 0):
                sub = dist.new_group(list(part[k * size:(k + 1) * size]))
                if mine and k == me // size:
                    self.intra = sub
            for i in range(size if self.n_groups > 1 else 0):
                sub = dist.new_group(list(part[i::size]))
                if mine and i == me % size:
                    self.cross = sub

    @classmethod
    def local(cls) -> "HierGroups":
        """The ``hier:1`` wire of a world of one: one group of one rank, no
        collective."""
        self = cls.__new__(cls)
        self.size, self.n_groups, self.intra, self.cross = 1, 1, None, None
        return self


def _own_bit(alive: torch.Tensor, group) -> torch.Tensor:
    return alive[0 if group is None else dist.get_rank(group)]


class DcnWaitTally:
    """The emulated DCN link's residual waits (the ``dcn_delay`` fault,
    ``train.resilience``; JAX ``DcnWaitTally``): per step key, the longest
    wait any bucket paid at the consume gate. A wait below the delay is the
    cross-step pipeline hiding part of the round trip. The trainer drains it
    at log cadence into ``dcn_wait_s``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._waits: dict = {}

    def add(self, key, wait_s: float) -> None:
        with self._lock:
            self._waits[key] = max(self._waits.get(key, 0.0), float(wait_s))

    def pop(self) -> dict:
        """``{step key: longest wait in seconds}`` since the last pop."""
        with self._lock:
            out, self._waits = self._waits, {}
            return out


DCN_WAIT = DcnWaitTally()
# the link's launch stamps (host monotonic clock), keyed by the optimizer
# step count; the first bucket to stamp a step wins
_DCN_STAMPS: dict = {}
_DCN_STAMPS_LOCK = threading.Lock()


def dcn_link_reset() -> None:
    """Forget the link's stamps and waits: the stamps are keyed by the step
    count, so a fresh run reusing counts 0..N would otherwise find a former
    run's expired stamps and wait for nothing. Call it between measured
    runs."""
    with _DCN_STAMPS_LOCK:
        _DCN_STAMPS.clear()
    DCN_WAIT.pop()


def _dcn_launch_gate(count: Optional[int]) -> None:
    """The launch half of the ``dcn_delay`` link: stamp "the transfer of
    step ``count`` started now". A no-op unless the fault is armed."""
    if not resilience.fault("dcn_delay") or count is None:
        return
    with _DCN_STAMPS_LOCK:
        _DCN_STAMPS.setdefault(int(count), time.monotonic())
        for k in [k for k in _DCN_STAMPS if k < int(count) - 64]:
            del _DCN_STAMPS[k]


def _dcn_consume_gate(count: Optional[int], depth: int) -> None:
    """The consume half: sleep until the transfer launched at step ``count
    - depth`` has been on the link for the delay, and record the residual
    in :data:`DCN_WAIT`; the steps run since the launch count toward the
    deadline. With no step count the link is synchronous: the whole delay.
    A no-op unless the fault is armed."""
    delay = resilience.fault("dcn_delay")
    if not delay:
        return
    if count is None:
        time.sleep(float(delay))
        DCN_WAIT.add(None, float(delay))
        return
    key = int(count) - depth
    if key < 0:
        return
    with _DCN_STAMPS_LOCK:
        t0 = _DCN_STAMPS.get(key)
    if t0 is not None:
        rem = t0 + float(delay) - time.monotonic()
        if rem > 0:
            time.sleep(rem)
        DCN_WAIT.add(key, max(rem, 0.0))


def hier_launch(ballots: torch.Tensor, hier: HierGroups, tally: WireTally,
                alive: Optional[torch.Tensor] = None, group=None,
                count: Optional[int] = None) -> PendingVote:
    """Legs 1 and 2 of the ``hier:<g>`` election (JAX ``hier_launch``):
    everything up to the arrival of the cross-group traffic. Leg 1, an
    ``all_to_all_single`` inside the group, is issued now; ``wait`` runs leg
    2 and returns the uint8 slot segment of this rank
    (``codec.hier_chunk_slot_bytes``): the ``[n_groups]`` launch-time
    group-alive bytes, then the ``[n_groups, chunk/8]`` packed verdicts of
    the chunk this rank owns, by source group. Member ``i`` of a group owns
    chunk ``(i + 1) mod g``, where the JAX package's ring reduce-scatter
    leaves it, so the bytes are the JAX package's for the same rank.
    ``count`` (the optimizer step) stamps the ``dcn_delay`` link only."""
    n, g, n_groups = ballots.numel(), hier.size, hier.n_groups
    legs = hier_legs(n, g * n_groups, g)
    chunk = legs["chunk"]
    acc = torch.int8 if g <= 127 else torch.int32
    buf = ballots.to(acc)
    if g * chunk > n:  # padding votes −1; its elections are cut off at consume
        buf = torch.cat([buf, buf.new_full((g * chunk - n,), -1)])
    group_alive = None
    if alive is not None:  # a quarantined member's ballots are 0 in leg 1
        buf = torch.where(_own_bit(alive, group), buf, torch.zeros_like(buf))
        group_alive = alive.view(n_groups, g).any(1)
    if g > 1:  # leg 1: member j receives every member's ballots for chunk (j + 1) mod g
        send = torch.roll(buf.view(g, chunk), -1, 0).reshape(-1)
        arrived = torch.empty_like(send)
        tally.record("ici", legs["leg1"])
        work = dist.all_to_all_single(arrived, send, group=hier.intra, async_op=True)
    else:
        arrived, work = buf, None
    _dcn_launch_gate(count)

    def finish():
        if work is not None:
            work.wait()
        mine = pack_signs(arrived.view(g, chunk).sum(0, dtype=torch.int32) > 0)  # tie → −1
        if n_groups > 1:  # leg 2: every group's verdict on my chunk
            stack = mine.new_empty(n_groups * mine.numel())
            tally.record("dcn", legs["leg2"])
            _all_gather(stack, mine, group=hier.cross)
        else:
            stack = mine
        mask = (torch.ones(n_groups, dtype=torch.uint8, device=mine.device)
                if group_alive is None else group_alive.to(torch.uint8))
        return torch.cat([mask, stack])

    return PendingVote(finish)


def hier_consume(slot: torch.Tensor, n: int, hier: HierGroups, tally: WireTally,
                 alive: Optional[torch.Tensor] = None, count: Optional[int] = None,
                 depth: int = 0) -> torch.Tensor:
    """Leg 3 of the ``hier:<g>`` election from a :func:`hier_launch` slot
    segment, possibly ``depth`` steps old (JAX ``hier_consume``): a source
    group counts where it held a healthy member at launch (the slot's mask)
    AND holds one now (``alive``); the chunk's election is the strict
    majority of the counting groups' verdicts (ties −1), and leg 3 gathers
    the elected chunks inside the group. Returns the int8 ±1 proxy of the
    ``n`` coordinates, the same on every rank."""
    g, n_groups = hier.size, hier.n_groups
    chunk = hier_legs(n, g * n_groups, g)["chunk"]
    _dcn_consume_gate(count, depth)
    counted = slot[:n_groups] > 0
    if alive is not None:
        counted = counted & alive.view(n_groups, g).any(1)
    bits = unpack_signs(slot[n_groups:], (n_groups, chunk)) & counted[:, None]
    mine = pack_signs(bits.sum(0, dtype=torch.int32) * 2 > counted.sum(dtype=torch.int32))
    if g > 1:  # leg 3: the elected chunks of my group's members, chunk c from member c − 1
        elected = mine.new_empty(g * mine.numel())
        tally.record("ici", hier_legs(n, g * n_groups, g)["leg3"])
        _all_gather(elected, mine, group=hier.intra)
        elected = torch.roll(elected.view(g, -1), 1, 0).reshape(-1)
    else:
        elected = mine
    return torch.where(unpack_signs(elected, (n,)), 1, -1).to(torch.int8)


def _hier_vote(ballots: torch.Tensor, hier: HierGroups, tally: WireTally,
               alive: Optional[torch.Tensor], group, count: Optional[int]) -> PendingVote:
    """The synchronous hier election (depth 0): a launch consumed in the
    same step."""
    launch = hier_launch(ballots, hier, tally, alive, group, count)
    return PendingVote(lambda: hier_consume(launch.wait(), ballots.numel(), hier, tally,
                                            alive, count))


def _healthy_count(bits: torch.Tensor, alive: Optional[torch.Tensor], w: int):
    """Per coordinate, the rows of ``bits`` ([W, k] bool) that vote +1,
    over the healthy rows under ``alive``; and the quorum."""
    if alive is None:
        return bits.sum(0, dtype=torch.int32), w
    return (bits & alive[:, None]).sum(0, dtype=torch.int32), alive.sum(dtype=torch.int32)


def vote_total_async(ballots: torch.Tensor, wire: str, group=None,
                     tally: Optional[WireTally] = None,
                     keep_ballots: bool = False,
                     hier: Optional[HierGroups] = None,
                     alive: Optional[torch.Tensor] = None,
                     count: Optional[int] = None) -> PendingVote:
    """Start the vote over int8 ±1 ``ballots`` ([n]); see the module doc.
    ``group`` is a process group, or None for a world of one without one.
    ``sign_psum`` at W <= 127 sums in place into ``ballots`` unless
    ``keep_ballots`` asks for a copy (telemetry and the vote guard compare
    the ballots with the tally) or ``alive`` masks them; the other wires
    never write them. ``hier`` is the :class:`HierGroups` of a
    ``hier:<g>`` wire over ``group``, built here when not given. ``alive``
    masks the election (module doc); in a world of one an abstaining rank's
    total is 0 everywhere (−1 elected), as on a one-device mesh. ``count``
    (the optimizer step) feeds the hier wire's ``dcn_delay`` link only."""
    kind, size = parse_wire(wire)
    if group is None:
        if alive is not None:
            return PendingVote(lambda: torch.where(alive[0], ballots, torch.zeros_like(ballots)))
        return PendingVote(lambda: ballots)
    w = dist.get_world_size(group)
    tally = tally if tally is not None else WireTally()

    def record(nbytes):
        if w > 1:
            tally.record("ici", nbytes)

    if kind == "hier":
        return _hier_vote(ballots, hier or HierGroups(group, size), tally, alive, group, count)

    if kind == "sign_psum":
        buf = ballots.to(torch.int8 if w <= 127 else torch.int32,
                         copy=keep_ballots and alive is None)
        if alive is not None:  # an abstainer sends zero ballots
            buf = torch.where(_own_bit(alive, group), buf, torch.zeros_like(buf))
        record(buf.numel() * buf.element_size())
        work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group,
                               async_op=True)

        def finish():
            work.wait()
            return buf

        return PendingVote(finish)

    n = ballots.numel()
    if kind == "packed_allgather":
        packed = pack_signs(ballots > 0)
        gathered = packed.new_empty(w * packed.numel())
        record(w * packed.numel())
        work = _all_gather(gathered, packed, group=group, async_op=True)

        def finish():
            work.wait()
            bits = unpack_signs(gathered, (w, packed.numel() * 8))
            count, quorum = _healthy_count(bits, alive, w)
            return count[:n] * 2 - quorum

        return PendingVote(finish)

    # packed_a2a: phase 1 sends row j of my packed ballots to rank j
    chunk = a2a_chunk_bytes(n, w)
    vote_pos = ballots > 0
    pad = chunk * 8 * w - n
    if pad:
        vote_pos = torch.cat([vote_pos, vote_pos.new_zeros(pad)])
    packed = pack_signs(vote_pos)
    arrived = torch.empty_like(packed)
    record((w - 1) * chunk)
    work = dist.all_to_all_single(arrived, packed, group=group, async_op=True)

    def finish():
        work.wait()
        count, quorum = _healthy_count(unpack_signs(arrived, (w, chunk * 8)), alive, w)
        verdict = count * 2 > quorum  # tie → False (−1)
        mine = pack_signs(verdict)
        gathered = mine.new_empty(w * chunk)
        record((w - 1) * chunk)
        _all_gather(gathered, mine, group=group)
        elected = unpack_signs(gathered, (n,))
        return torch.where(elected, 1, -1).to(torch.int8)

    return PendingVote(finish)


def vote_total(ballots: torch.Tensor, wire: str, group=None,
               tally: Optional[WireTally] = None,
               keep_ballots: bool = False,
               hier: Optional[HierGroups] = None,
               alive: Optional[torch.Tensor] = None,
               count: Optional[int] = None) -> torch.Tensor:
    """Synchronous form of :func:`vote_total_async`."""
    return vote_total_async(ballots, wire, group, tally, keep_ballots, hier, alive,
                            count).wait()
