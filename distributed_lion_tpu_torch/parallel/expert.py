"""Expert parallelism: port of ``distributed_lion_tpu/parallel/expert.py``.

A Switch-style MoE FFN: top-1 routing (each token to the argmax of a learned
gate's softmax), a fixed capacity ``ceil(cf · N / E)`` per expert with the
overflow dropped (the residual carries a dropped token unchanged), the
load-balancing auxiliary loss, and the experts sharded over the ``expert``
axis (``parallel.mesh.ExpertAxis``): rank ``e`` of ep holds experts ``[e·E/ep,
(e+1)·E/ep)`` (:func:`expert_shard_dim`), and each rank's tokens reach their
experts through two ``all_to_all_single`` hops over the expert group
(dispatch and return), each an autograd function whose backward is the
other hop. Under a tensor axis (ep × tp) each expert's FFN is also
Megatron-split (``parallel.tensor_parallel``: ``w_in [E, d, f/tp]``, ``b_in
[E, f/tp]``, ``w_out [E, f/tp, d]``), entered through *f*, left through *g*,
with the gate and ``b_out`` replicated over tensor and ``b_out`` added after
the reduction.

The routing arithmetic is int32 whatever the activations' dtype (a
bfloat16 cumulative sum cannot count past 256 and would put two tokens in
one slot). The JAX package's ``[N, E, C]`` one-hot masks are not built:
each ``(expert, slot)`` holds at most one token, so the dispatch is a
scatter of the kept tokens' rows into ``[E·C, d]`` by slot index, and the
combine a gather of each kept token's row scaled by its gate probability,
the same function with one rounding per product (module tests: float32
within 1e-6 of JAX's einsums). The expert FFN is two batched products with
the tanh GELU.

Decoding passes JAX's two inference arguments: ``capacity_override``
(the decode paths give ``B·S``, so no token is dropped and routing is a
per-token function) and ``valid`` (dead lanes, a left-padded batch's pad
slots, leave the assignment before the queue count: they take no slot,
route nowhere and give exact-zero rows; the aux loss averages over the
valid lanes). Every leaf goes through ``ops.quant.maybe_dequant``, so NF4
and int8 expert banks serve. The serving engine's ``return_stats``,
``stats_axis`` and ``stats_lanes`` are not ported (ROADMAP Queue 1 item
12(d)).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from distributed_lion_tpu_torch.ops.quant import maybe_dequant
from distributed_lion_tpu_torch.parallel.mesh import ExpertAxis, TensorAxis
from distributed_lion_tpu_torch.parallel.tensor_parallel import (
    copy_to_tp_region,
    reduce_from_tp_region,
)

EXPERT_LEAVES = ("w_in", "b_in", "w_out", "b_out")   # dim 0 over the expert axis
AUX_WEIGHT = 0.01   # the Switch recipe's aux weight in the train loss


def capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, math.ceil(capacity_factor * n_tokens / n_experts))


def moe_init(n_experts: int, d_model: int, d_ff: int, dtype=torch.float32,
             gen: Optional[torch.Generator] = None) -> dict:
    """Gate and per-expert FFN weights on the CPU (JAX ``moe_init``): gate,
    ``w_in`` and ``w_out`` N(0, 0.02) drawn from ``gen`` in that order, the
    biases zero."""
    def normal(*shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32) * 0.02).to(dtype)

    return {"gate": normal(d_model, n_experts),
            "w_in": normal(n_experts, d_model, d_ff),
            "b_in": torch.zeros(n_experts, d_ff, dtype=dtype),
            "w_out": normal(n_experts, d_ff, d_model),
            "b_out": torch.zeros(n_experts, d_model, dtype=dtype)}


def expert_shard_dim(name: str) -> Optional[int]:
    """The dim of a leaf (dotted or ``/``-joined path) split over the expert
    axis (JAX ``moe_param_specs``): dim 0 of an MoE FFN's ``w_in``, ``b_in``,
    ``w_out`` and ``b_out``; None (replicated) for the gate and every other
    leaf."""
    parts = name.replace("/", ".").split(".")
    return 0 if len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in EXPERT_LEAVES else None


def _hop(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _to_experts(x: torch.Tensor, ep: int, group) -> torch.Tensor:
    """``[E, C, d]`` slots of every expert → ``[E/ep, ep·C, d]``: each rank
    sends expert block ``j`` to rank ``j`` and keeps its arrivals in source
    order along the capacity dim (JAX ``all_to_all(split_axis=0,
    concat_axis=1, tiled=True)``)."""
    E, C, D = x.shape
    got = _hop(x, group).reshape(ep, E // ep, C, D)   # [source, my experts, C, d]
    return got.transpose(0, 1).reshape(E // ep, ep * C, D)


def _from_experts(x: torch.Tensor, ep: int, group) -> torch.Tensor:
    """The inverse of :func:`_to_experts`: ``[E/ep, ep·C, d]`` → ``[E, C, d]``
    back on the tokens' rank."""
    El, SC, D = x.shape
    send = x.reshape(El, ep, SC // ep, D).transpose(0, 1).contiguous()   # [dest, El, C, d]
    return _hop(send, group).view(ep * El, SC // ep, D)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ep, group):
        ctx.ep, ctx.group = ep, group
        return _to_experts(x, ep, group)

    @staticmethod
    def backward(ctx, g):
        return _from_experts(g, ctx.ep, ctx.group), None, None


class _Return(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ep, group):
        ctx.ep, ctx.group = ep, group
        return _from_experts(x, ep, group)

    @staticmethod
    def backward(ctx, g):
        return _to_experts(g, ctx.ep, ctx.group), None, None


def route(x: torch.Tensor, gate: torch.Tensor, n_experts: int, cap: int,
          valid: Optional[torch.Tensor] = None) -> tuple:
    """Top-1 routing of ``x [N, d]`` (JAX expert.py:185-201): ``(probs [N, E]
    in x's dtype, expert index [N], the token's slot in its expert's queue
    [N] int32, kept [N] bool)``; the slot counts in int32 in token order
    over the ``valid`` lanes (all when None), a dead lane taking no slot
    and never kept.
    The softmax is ``jax.nn.softmax``'s, each op in x's dtype (the shifted
    exponent, its sum, the quotient), so a bfloat16 near-tie breaks as in the
    JAX package (``torch.softmax`` rounds once and may pick another expert)."""
    logits = x @ maybe_dequant(gate, x.dtype).to(x.dtype)
    unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    idx = torch.argmax(probs, dim=-1)
    # [E, N]: the queue count runs along the inner dim (a scan along the outer
    # dim of [N, E] took 1.3 ms a call at N 8192 on the H100, run (y1)'s profile)
    one_hot = F.one_hot(idx, n_experts).t().to(torch.int32)
    if valid is not None:
        one_hot = one_hot * valid.to(torch.int32)
    pos = (torch.cumsum(one_hot, dim=1, dtype=torch.int32) * one_hot).sum(0) - 1
    return probs, idx, pos, (pos >= 0) & (pos < cap)


def moe_ffn(params: Mapping[str, torch.Tensor], x: torch.Tensor, *,
            capacity_factor: float = 1.25, expert: Optional[ExpertAxis] = None,
            tp: Optional[TensorAxis] = None, capacity_override: Optional[int] = None,
            valid: Optional[torch.Tensor] = None,
            balance_tokens: Optional[torch.Tensor] = None,
            balance_axis: Optional[ExpertAxis] = None, return_tallies: bool = False):
    """The MoE FFN of local tokens ``x [N, d]`` (JAX ``moe_ffn``, all but the
    serving stats). ``capacity_override`` replaces the capacity (the decode
    paths: ``N``, no drop); ``valid`` ``[N]`` bool masks dead lanes out of
    the routing and the aux loss (module doc). ``params`` holds this rank's
    experts ``[E/ep, ...]`` (and its tensor slices under ``tp``) and the
    whole gate ``[d, E]``; with ``expert`` (size > 1) the tokens cross the
    expert group. Capacity comes from the local N. ``balance_tokens``
    (``[E+1]`` float32: per-expert
    token counts and the lane count) replaces the local load fraction in the
    aux loss, except an all-zero tally (lane count 0, a ring's cold start),
    which falls back to the local one; ``balance_axis`` instead sums the
    local counts over that axis's group in the forward (the synchronous
    depth 0). ``return_tallies`` also returns this call's local ``[E+1]``
    tally (detached). Returns ``(y [N, d], aux)`` or ``(y, aux, tallies)``."""
    if balance_tokens is not None and balance_axis is not None:
        raise ValueError("balance_tokens and balance_axis are alternatives; pass one")
    dt = x.dtype
    w_in, b_in, w_out, b_out = (maybe_dequant(params[k], dt).to(dt) for k in EXPERT_LEAVES)
    n, d = x.shape
    ep = 1 if expert is None else expert.size
    n_experts = w_in.shape[0] * ep
    cap = (capacity_override if capacity_override is not None
           else capacity(n, n_experts, capacity_factor))

    probs, idx, pos, keep = route(x, params["gate"], n_experts, cap, valid)
    gate_p = probs.gather(-1, idx[:, None])[:, 0]

    # the load-balance aux on the pre-drop assignment, over the valid lanes
    if valid is None:
        counts = torch.bincount(idx, minlength=n_experts).to(torch.float32)
        n_lanes = torch.tensor(float(n), device=x.device)
        frac_probs = probs.mean(dim=0)
    else:
        v32 = valid.to(torch.float32)
        counts = torch.zeros(n_experts, dtype=torch.float32, device=x.device).index_add_(
            0, idx, v32)
        n_lanes = v32.sum()
        frac_probs = (probs * v32[:, None]).sum(0) / torch.clamp_min(n_lanes, 1.0)
    local_frac = counts / torch.clamp_min(n_lanes, 1.0)
    if balance_tokens is not None:
        fed = balance_tokens[:n_experts] / torch.clamp_min(balance_tokens[n_experts], 1.0)
        frac_tokens = torch.where(balance_tokens[n_experts] > 0.0, fed, local_frac)
    elif balance_axis is not None and balance_axis.size > 1:
        tot = torch.cat([counts, n_lanes[None]])
        dist.all_reduce(tot, group=balance_axis.group)
        frac_tokens = tot[:n_experts] / torch.clamp_min(tot[n_experts], 1.0)
    else:
        frac_tokens = local_frac
    aux = n_experts * torch.sum(frac_tokens * frac_probs)

    # dispatch: each kept token's row into its (expert, slot) of [E·C, d]
    slot = idx * cap + pos
    kept = torch.nonzero(keep).flatten()
    dispatch = x.new_zeros(n_experts * cap, d).index_copy(0, slot[kept], x[kept])
    dispatch = dispatch.view(n_experts, cap, d)
    if ep > 1:
        dispatch = _Dispatch.apply(dispatch, ep, expert.group)
    group = None if tp is None else tp.group
    dispatch = copy_to_tp_region(dispatch, group)
    h = F.gelu(torch.bmm(dispatch, w_in) + b_in[:, None, :], approximate="tanh")
    out = reduce_from_tp_region(torch.bmm(h, w_out), group) + b_out[:, None, :]
    if ep > 1:
        out = _Return.apply(out, ep, expert.group)

    # combine: each kept token's slot row times its gate probability
    rows = out.reshape(n_experts * cap, d).index_select(0, torch.where(keep, slot, 0))
    y = torch.where(keep[:, None], rows * gate_p[:, None], 0.0).to(dt)
    if return_tallies:
        return y, aux, torch.cat([counts, n_lanes[None]]).detach()
    return y, aux
