"""Vote collectives over ``torch.distributed``: the wire layer.

Port of ``distributed_lion_tpu/parallel/collectives.py`` (``vote_total``,
:241-306, and the packed_a2a election, :359-386) for the three flat wires:

- ``sign_psum``: the int8 ±1 ballots are summed by one ``all_reduce``
  (int32 when W > 127, where int8 partial sums could overflow). Returns
  the exact tally.
- ``packed_allgather``: 1-bit packed uint8 ballots, one all-gather, then
  unpack and count locally. Returns the exact tally (int32).
- ``packed_a2a``: ``all_to_all_single`` of packed ballot chunks (each rank
  tallies one chunk), then an all-gather of the packed verdicts.
  Returns a ±1 proxy of the elected sign (int8), never the magnitude.

Every wire elects +1 exactly where the returned total is > 0; ties elect
−1. With no process group (a world of one) the total is the rank's own ±1
ballots, as a ``psum`` over a size-1 mesh axis is. :func:`vote_total_async`
issues the first collective with ``async_op=True`` and returns a
:class:`PendingVote`, so the optimizer can apply the previous bucket while
this one is on the wire.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.ops.codec import (
    a2a_chunk_bytes,
    pack_signs,
    parse_wire,
    unpack_signs,
)

# PyTorch 2.13 adds all_gather_single and deprecates all_gather_into_tensor
# (same arguments); earlier releases have only the latter.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class WireTally:
    """Bytes handed to the collective backend, recorded per launch as
    ``(leg, received_bytes)`` with the same per-leg convention as the JAX
    package's ``WireTally`` and ``codec.wire_bytes_per_param`` (bytes
    RECEIVED per rank). A world of one records nothing: no bytes move."""

    def __init__(self):
        self.entries: list[tuple[str, int]] = []

    def record(self, leg: str, nbytes: int) -> None:
        if nbytes > 0:
            self.entries.append((leg, int(nbytes)))

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


def vote_total_async(ballots: torch.Tensor, wire: str, group=None,
                     tally: Optional[WireTally] = None,
                     keep_ballots: bool = False) -> PendingVote:
    """Start the vote over int8 ±1 ``ballots`` ([n]); see the module doc.
    ``group`` is a process group, or None for a world of one without one.
    ``sign_psum`` at W <= 127 sums in place into ``ballots`` unless
    ``keep_ballots`` asks for a copy (telemetry compares the ballots with
    the tally); the other wires never write them."""
    kind, _ = parse_wire(wire)
    if group is None:
        return PendingVote(lambda: ballots)
    w = dist.get_world_size(group)
    tally = tally if tally is not None else WireTally()

    def record(nbytes):
        if w > 1:
            tally.record("ici", nbytes)

    if kind == "sign_psum":
        buf = ballots.to(torch.int8 if w <= 127 else torch.int32, copy=keep_ballots)
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
            count = bits.sum(0, dtype=torch.int32)[:n]
            return count * 2 - w

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
        bits = unpack_signs(arrived, (w, chunk * 8))
        verdict = bits.sum(0, dtype=torch.int32) * 2 > w  # tie → False (−1)
        mine = pack_signs(verdict)
        gathered = mine.new_empty(w * chunk)
        record((w - 1) * chunk)
        _all_gather(gathered, mine, group=group)
        elected = unpack_signs(gathered, (n,))
        return torch.where(elected, 1, -1).to(torch.int8)

    return PendingVote(finish)


def vote_total(ballots: torch.Tensor, wire: str, group=None,
               tally: Optional[WireTally] = None,
               keep_ballots: bool = False) -> torch.Tensor:
    """Synchronous form of :func:`vote_total_async`."""
    return vote_total_async(ballots, wire, group, tally, keep_ballots).wait()
