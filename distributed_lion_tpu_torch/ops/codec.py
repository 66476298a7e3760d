"""1-bit sign codec and wire byte accounting.

Port of ``distributed_lion_tpu/ops/codec.py`` for the three flat wires
(``sign_psum``, ``packed_allgather``, ``packed_a2a``). Packed bytes, bucket
boundaries and byte counts equal the JAX package's exactly. The
hierarchical ``hier:<g>`` wire is not ported yet (ROADMAP Queue 1 item 3)
and raises ``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch

FLAT_WIRES = ("sign_psum", "packed_allgather", "packed_a2a")


def packed_size(n: int) -> int:
    """Number of uint8 bytes needed to pack ``n`` sign bits (ceil(n/8))."""
    return (n + 7) // 8


def parse_wire(wire: str) -> tuple[str, None]:
    """Validate a wire-format string into ``(kind, None)``."""
    if wire.startswith("hier:"):
        raise NotImplementedError(
            f"wire {wire!r}: the hierarchical vote is not ported yet "
            "(ROADMAP Queue 1 item 3); use sign_psum, packed_allgather or "
            "packed_a2a")
    if wire in FLAT_WIRES:
        return wire, None
    raise ValueError(f"unknown wire format: {wire!r}")


def vote_chunk_elems(n: int, vote_every: int) -> int:
    """Coordinates refreshed per step under ``vote_every`` lazy refresh."""
    return max(8, -(-n // (8 * vote_every)) * 8)


def bucket_alignment(world_size: int, wire: str) -> int:
    """Element alignment of bucket boundaries: whole bytes (8) for the tally
    wires, whole per-worker a2a chunks (8·W) for ``packed_a2a``."""
    kind, _ = parse_wire(wire)
    return 8 * world_size if kind == "packed_a2a" else 8


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


def _recv_bytes(n: int, world_size: int, kind: str) -> int:
    """Bytes received per worker for one contiguous ``n``-coordinate ballot."""
    if kind == "sign_psum":
        return n * (1 if world_size <= 127 else 4)
    if kind == "packed_allgather":
        return world_size * packed_size(n)
    return 2 * (world_size - 1) * a2a_chunk_bytes(n, world_size)


def wire_bytes_per_param(num_params: int, world_size: int, wire: str,
                         vote_every: int = 1, accum_steps: int = 1,
                         vote_buckets: int = 1) -> dict:
    """Bytes RECEIVED per worker per optimizer step, with the same keys and
    values as the JAX package's accounting for the flat wires."""
    kind, _ = parse_wire(wire)
    n_voted = (num_params if vote_every <= 1
               else min(num_params, vote_chunk_elems(num_params, vote_every)))
    per_bucket = [_recv_bytes(size, world_size, kind)
                  for _, size in bucket_bounds(n_voted, max(vote_buckets, 1),
                                               world_size, wire)]
    ours = sum(per_bucket)
    overlappable = (sum(per_bucket[1:]) / ours
                    if ours and world_size > 1 else 0.0)
    if world_size <= 1:
        ours = 0  # a one-voter wire moves nothing
    reference = world_size * packed_size(num_params) * 8
    bf16_allreduce = 2 * num_params
    if world_size <= 1:
        reference = bf16_allreduce = 0
    bits = 8.0 * ours / max(num_params, 1)
    return {
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
