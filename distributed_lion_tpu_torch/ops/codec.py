"""1-bit sign codec and wire byte accounting.

Port of ``distributed_lion_tpu/ops/codec.py`` for the three flat wires
(``sign_psum``, ``packed_allgather``, ``packed_a2a``) and the synchronous
hierarchical wire ``hier:<g>``. Packed bytes, bucket boundaries and byte
counts equal the JAX package's exactly, with the hier wire's cross-group
(``dcn``) leg reported apart, and so do the DCN pipeline's ring-slot sizes
(:func:`hier_chunk_slot_bytes`, :func:`hier_ring_slot_bytes`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

FLAT_WIRES = ("sign_psum", "packed_allgather", "packed_a2a")


def packed_size(n: int) -> int:
    """Number of uint8 bytes needed to pack ``n`` sign bits (ceil(n/8))."""
    return (n + 7) // 8


def parse_wire(wire: str) -> tuple[str, Optional[int]]:
    """Validate a wire-format string into ``(kind, group_size)``: the flat
    wires parse to ``(wire, None)``, ``"hier:<g>"`` to ``("hier", g)`` (g
    consecutive ranks form a group)."""
    if wire.startswith("hier:"):
        try:
            g = int(wire.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"bad hier wire spec {wire!r}: expected 'hier:<int>'")
        if g < 1:
            raise ValueError(f"hier group size must be >= 1, got {g}")
        return "hier", g
    if wire in FLAT_WIRES:
        return wire, None
    raise ValueError(f"unknown wire format: {wire!r}")


def vote_chunk_elems(n: int, vote_every: int) -> int:
    """Coordinates refreshed per step under ``vote_every`` lazy refresh."""
    return max(8, -(-n // (8 * vote_every)) * 8)


def bucket_alignment(world_size: int, wire: str) -> int:
    """Element alignment of bucket boundaries: whole bytes (8) for the tally
    wires, whole per-worker a2a chunks (8·W) for ``packed_a2a``, whole
    per-member chunks (8·g) for ``hier:<g>``."""
    kind, group = parse_wire(wire)
    if kind == "packed_a2a":
        return 8 * world_size
    if kind == "hier":
        return 8 * group
    return 8


def bucket_bounds(n: int, vote_buckets: int, world_size: int,
                  wire: str) -> list[tuple[int, int]]:
    """Split an ``n``-coordinate ballot into ≤ ``vote_buckets`` contiguous
    ``(start, size)`` chunks; every chunk but the last is a multiple of the
    wire alignment."""
    if vote_buckets < 1:
        raise ValueError(f"vote_buckets must be >= 1, got {vote_buckets}")
    if n <= 0:
        return []
    align = bucket_alignment(world_size, wire)
    per = -(-n // vote_buckets)
    per = -(-per // align) * align
    bounds = []
    off = 0
    while off < n:
        size = min(per, n - off)
        bounds.append((off, size))
        off += size
    return bounds


def a2a_chunk_bytes(n: int, world_size: int) -> int:
    """uint8 bytes per worker-chunk on the packed_a2a wire."""
    return max(1, -(-n // (8 * world_size)))


def hier_chunk_slot_bytes(nb: int, world_size: int, group: int) -> int:
    """uint8 bytes of one bucket's in-flight DCN slot segment for an
    ``nb``-coordinate ballot on the ``hier:<g>`` wire: the ``[n_groups]``
    launch-time group-alive bytes, then the ``[n_groups, chunk/8]`` packed
    per-group verdicts of this rank's owned chunk
    (``parallel.collectives.hier_launch``'s output)."""
    n_groups = world_size // group
    return n_groups * (1 + a2a_chunk_bytes(nb, group))


def hier_ring_slot_bytes(n: int, world_size: int, group: int,
                         vote_buckets: int = 1, vote_every: int = 1) -> int:
    """uint8 bytes of one slot of the cross-step DCN ring
    (``dcn_pipeline_depth``): the per-bucket segments
    (:func:`hier_chunk_slot_bytes`) over ``bucket_bounds`` of the step's
    ballot, which under lazy refresh is the padded rotating slice
    (``vote_chunk_elems(n, vote_every)`` coordinates). The optimizer's
    ``LionState.dcn_ring``, the launch and consume slicing and the
    checkpoint's restore check all read it."""
    if world_size % group:
        raise ValueError(
            f"hier wire: group size {group} does not divide world {world_size}")
    ballot = n if vote_every <= 1 else vote_chunk_elems(n, vote_every)
    return sum(hier_chunk_slot_bytes(size, world_size, group)
               for _, size in bucket_bounds(ballot, max(vote_buckets, 1),
                                            world_size, f"hier:{group}"))


def pack_signs(positive: torch.Tensor) -> torch.Tensor:
    """Pack a bool tensor (True = +1 vote) into uint8, 8 votes per byte,
    LSB first; padding bits are zeros."""
    flat = positive.reshape(-1).to(torch.uint8)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shifts = torch.arange(8, dtype=torch.uint8, device=flat.device)
    return (flat.view(-1, 8) << shifts).sum(-1, dtype=torch.int32).to(torch.uint8)


def unpack_signs(packed: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`pack_signs`: uint8 bytes → bool tensor of ``shape``."""
    n = math.prod(shape)
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].reshape(shape).to(torch.bool)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of a uint8 tensor, counted exactly as an int64 scalar: each
    byte's bits summed in place (SWAR), so no per-bit copy of the tensor is
    made and nothing is read back to the host (``torch.bincount`` on a card
    reads its input's maximum back)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return ((x + (x >> 4)) & 0x0F).sum(dtype=torch.int64)


def hier_legs(n: int, world_size: int, group: int) -> dict:
    """Bytes RECEIVED per rank by each leg of the ``hier:<g>`` election of
    one ``n``-coordinate ballot: ``chunk`` coordinates owned per member
    (whole bytes), leg 1 the in-group exchange of ballot chunks at the
    accumulator width (int8, int32 past g = 127), leg 2 the cross-group
    exchange of packed verdict chunks (the only ``dcn`` leg), leg 3 the
    in-group gather of packed elected chunks."""
    n_groups = world_size // group
    acc_bytes = 1 if group <= 127 else 4
    chunk = 8 * a2a_chunk_bytes(n, group)
    return {"chunk": chunk,
            "leg1": (group - 1) * chunk * acc_bytes,
            "leg2": (n_groups - 1) * (chunk // 8),
            "leg3": (group - 1) * (chunk // 8)}


def _recv_bytes(n: int, world_size: int, kind: str,
                group: Optional[int]) -> tuple[int, int]:
    """``(bytes, dcn bytes)`` received per worker for one contiguous
    ``n``-coordinate ballot."""
    if kind == "hier":
        legs = hier_legs(n, world_size, group)
        return legs["leg1"] + legs["leg2"] + legs["leg3"], legs["leg2"]
    if kind == "sign_psum":
        return n * (1 if world_size <= 127 else 4), 0
    if kind == "packed_allgather":
        return world_size * packed_size(n), 0
    return 2 * (world_size - 1) * a2a_chunk_bytes(n, world_size), 0


def wire_bytes_per_param(num_params: int, world_size: int, wire: str,
                         vote_every: int = 1, accum_steps: int = 1,
                         vote_buckets: int = 1, dcn_pipeline_depth: int = 0) -> dict:
    """Bytes RECEIVED per worker per optimizer step, with the same keys and
    values as the JAX package's accounting; the hier wire adds its group
    count, its cross-group leg alone, and ``dcn_overlap_frac``: 1.0 where
    the cross-step pipeline (``dcn_pipeline_depth`` > 0) takes a leg that
    moves bytes off the step's critical path, else 0.0. The bytes do not
    depend on the depth: a step launches and consumes one slot."""
    kind, group = parse_wire(wire)
    n_voted = (num_params if vote_every <= 1
               else min(num_params, vote_chunk_elems(num_params, vote_every)))
    if kind == "hier" and world_size % group:
        raise ValueError(
            f"hier group size {group} does not divide world {world_size}")
    per_bucket = [_recv_bytes(size, world_size, kind, group)
                  for _, size in bucket_bounds(n_voted, max(vote_buckets, 1),
                                               world_size, wire)]
    ours = sum(b for b, _ in per_bucket)
    overlappable = (sum(b for b, _ in per_bucket[1:]) / ours
                    if ours and world_size > 1 else 0.0)
    extras: dict = {}
    if kind == "hier":
        dcn = sum(d for _, d in per_bucket)
        extras = {"hier_groups": world_size // group,
                  "dcn_bytes_per_step": dcn,
                  "dcn_bits_per_param": 8.0 * dcn / max(num_params, 1),
                  "dcn_pipeline_depth": max(dcn_pipeline_depth, 0),
                  "dcn_overlap_frac": (1.0 if dcn_pipeline_depth > 0 and dcn > 0
                                       and world_size > 1 else 0.0)}
    if world_size <= 1:
        ours = 0  # a one-voter wire moves nothing
    reference = world_size * packed_size(num_params) * 8
    bf16_allreduce = 2 * num_params
    if world_size <= 1:
        reference = bf16_allreduce = 0
    bits = 8.0 * ours / max(num_params, 1)
    return extras | {
        "wire": wire,
        "vote_every": vote_every,
        "vote_buckets": max(vote_buckets, 1),
        "overlappable_wire_frac": overlappable,
        "bytes_per_step": ours,
        "bits_per_param": bits,
        "bits_per_param_per_microbatch": bits / max(accum_steps, 1),
        "reference_bytes_per_step": reference,
        "bf16_allreduce_bytes_per_step": bf16_allreduce,
        "vs_bf16_allreduce": ours / max(bf16_allreduce, 1),
        "vs_bf16_allreduce_equal_tokens":
            ours / max(bf16_allreduce * max(accum_steps, 1), 1),
    }
