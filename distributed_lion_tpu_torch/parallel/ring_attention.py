"""Sequence parallelism's attention: port of ``distributed_lion_tpu/parallel/ring_attention.py``.

Each rank of a seq group (``parallel.mesh.SeqAxis``) holds a contiguous
chunk of the tokens: rank ``s`` of ``S`` positions ``[s·T, (s+1)·T)``, its
q, k and v ``[B, H, T, hd]``.

- :func:`ring_attention`: q stays, the (k, v) blocks rotate around the
  group (:func:`ppermute`, one hop a step) while an online softmax (running
  max, denominator and numerator, float32) folds in one block a hop.
  Causality is by chunk: an earlier chunk is attended whole, the diagonal
  chunk through the triangular mask, a later chunk not at all. Each hop's
  products are the JAX package's ``einsum``s with its rounding: scores a
  float32-result product of the compute-dtype q and k
  (``ops.products.product_f32``), ``p`` cast to v's dtype before its
  product with v, accumulated in float32, the output cast to q's dtype.
  The diagonal hop comes first, so every row's running max is finite
  before a later chunk's hop; a later chunk's hop would add exactly
  nothing (a factor of 1, a term of 0), so it is skipped, and only its
  blocks travel on. The backward is written by hand
  (:class:`_RingAttention`): autograd through the hops would keep every
  hop's ``[B, H, T, T]`` float32 scores, and a rank whose later hops are
  skipped would not make their collectives in the backward.
- :func:`ulysses_attention`: an all-to-all swaps the sequence shard for a
  head shard (``[B, H, T, hd]`` → ``[B, H/S, S·T, hd]``), dense causal
  attention runs on the whole sequence of ``H/S`` heads
  (``ops.attention.attention_xla``, as the JAX package's), and a second
  all-to-all swaps back.

Both are plain PyTorch products, as the JAX package computes them in
``jnp``: no Pallas kernel runs on this path. The collectives are autograd
functions whose backward is the inverse permutation. A ``ppermute`` is an
``all_to_all_single`` with one nonzero split each way, which NCCL and gloo
(CUDA tensors included) both run; peers are indices on the seq group, and
``dist`` maps them to the group's global ranks.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.ops.attention import attention_xla
from distributed_lion_tpu_torch.ops.products import product_f32
from distributed_lion_tpu_torch.parallel.mesh import SeqAxis


def _shift(x: torch.Tensor, seq: SeqAxis, shift: int) -> torch.Tensor:
    """``x`` of seq rank ``s`` lands on ``(s + shift) % S``; returns what
    ``(s − shift) % S`` sent."""
    S, s = seq.size, seq.rank
    flat = x.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    send = [flat.numel() if j == (s + shift) % S else 0 for j in range(S)]
    recv = [flat.numel() if j == (s - shift) % S else 0 for j in range(S)]
    dist.all_to_all_single(out, flat, output_split_sizes=recv, input_split_sizes=send,
                           group=seq.group)
    return out.view(x.shape)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, shift):
        ctx.seq, ctx.shift = seq, shift
        return _shift(x, seq, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.seq, -ctx.shift), None, None


def ppermute(x: torch.Tensor, seq: SeqAxis, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` over the seq group with the permutation
    ``s → (s + shift) % S``; its backward sends the cotangent the other way."""
    return _PPermute.apply(x, seq, shift)


class _RingAttention(torch.autograd.Function):
    """The ring's forward (the JAX body) and its backward by hand: the
    forward saves q, k, v, the float32 output and each row's logsumexp,
    no hop's scores; the backward rotates the (k, v) blocks again, each
    with its float32 (dk, dv) accumulator beside it, recomputes each hop's
    probabilities ``P = exp(s − lse)`` and adds ``dv += Pᵀ·dO``, ``dS = P ∘
    (dO·vᵀ − Σ dO∘O)``, ``dq += dS·k``, ``dk += dSᵀ·q`` (the products in
    the compute dtype with float32 results, as the forward's), and a last
    hop takes every block's accumulator home. Every rank makes every hop's
    collective, the skipped chunks' included."""

    @staticmethod
    def forward(ctx, q, k, v, seq):
        S, idx = seq.size, seq.rank
        B, H, T, hd = q.shape
        scale = 1.0 / math.sqrt(hd)
        m = torch.full((B, H, T, 1), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, T, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, T, hd), dtype=torch.float32, device=q.device)
        diag = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        kv = torch.stack([k, v])
        for step in range(S):
            src = (idx - step) % S   # whose chunk this hop holds
            if src <= idx:   # a later chunk adds nothing (module doc)
                scores = product_f32(q, kv[0].transpose(-1, -2)) * scale
                if src == idx:
                    scores.masked_fill_(~diag, -math.inf)
                new_m = torch.maximum(m, scores.amax(-1, keepdim=True))
                # the -inf guards of ring_attention.py:68-75
                safe_m = torch.where(torch.isinf(new_m), 0.0, new_m)
                alpha = torch.exp(torch.where(torch.isinf(m), -math.inf, m) - safe_m)
                alpha = torch.where(torch.isinf(m), 0.0, alpha)
                p = torch.exp(scores - safe_m)
                p = torch.where(torch.isinf(scores), 0.0, p)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + product_f32(p.to(v.dtype), kv[1])
                m = new_m
                del scores, p
            if step + 1 < S:
                kv = _shift(kv, seq, 1)
        out = acc / torch.clamp_min(l, 1e-30)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.seq = seq
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        seq = ctx.seq
        S, idx = seq.size, seq.rank
        T, hd = q.shape[2], q.shape[3]
        scale = 1.0 / math.sqrt(hd)
        diag = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        do = dout.to(v.dtype)
        delta = (dout.to(torch.float32) * out).sum(-1, keepdim=True)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for step in range(S):
            src = (idx - step) % S
            if src <= idx:
                k_blk, v_blk = kv[0], kv[1]
                scores = product_f32(q, k_blk.transpose(-1, -2)) * scale
                if src == idx:
                    scores.masked_fill_(~diag, -math.inf)
                p = torch.exp(scores - lse)   # 0 where masked
                del scores
                dkv[1] += product_f32(p.to(v.dtype).transpose(-1, -2), do)
                ds = p * (product_f32(do, v_blk.transpose(-1, -2)) - delta)
                del p
                ds = (ds * scale).to(q.dtype)
                dq += product_f32(ds, k_blk)
                dkv[0] += product_f32(ds.transpose(-1, -2), q)
                del ds
            if step + 1 < S:
                kv = _shift(kv, seq, 1)
            dkv = _shift(dkv, seq, 1)   # each accumulator travels with its block, then home
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   seq: SeqAxis) -> torch.Tensor:
    """Causal attention of this rank's chunk ``q``, ``k``, ``v`` ``[B, H, T,
    hd]`` over the chunks of the whole seq group (ring_attention.py:32-87);
    returns ``[B, H, T, hd]`` in q's dtype."""
    return _RingAttention.apply(q, k, v, seq)


def _seq_to_heads(x: torch.Tensor, S: int, group) -> torch.Tensor:
    """``[B, H, T, hd]`` (rank s's tokens) → ``[B, H/S, S·T, hd]`` (its heads)."""
    B, H, T, hd = x.shape
    send = x.reshape(B, S, H // S, T, hd).transpose(0, 1).contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)   # out[i]: rank i's tokens of my heads
    return out.permute(1, 2, 0, 3, 4).reshape(B, H // S, S * T, hd)


def _heads_to_seq(x: torch.Tensor, S: int, group) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`."""
    B, Hs, TT, hd = x.shape
    send = x.reshape(B, Hs, S, TT // S, hd).permute(2, 0, 1, 3, 4).contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)   # out[i]: my tokens of rank i's heads
    return out.transpose(0, 1).reshape(B, S * Hs, TT // S, hd)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, S, group):
        ctx.S, ctx.group = S, group
        return _seq_to_heads(x, S, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.S, ctx.group), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, S, group):
        ctx.S, ctx.group = S, group
        return _heads_to_seq(x, S, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.S, ctx.group), None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      seq: SeqAxis) -> torch.Tensor:
    """DeepSpeed-Ulysses attention (ring_attention.py:90-109): needs the
    rank's head count divisible by the seq axis."""
    S = seq.size
    H = q.shape[1]
    if H % S != 0:
        raise ValueError(f"n_heads {H} not divisible by seq axis size {S}")
    q, k, v = (_SeqToHeads.apply(x, S, seq.group) for x in (q, k, v))
    return _HeadsToSeq.apply(attention_xla(q, k, v, causal=True), S, seq.group)


def seq_attention(q, k, v, seq: SeqAxis, impl: str = "ring") -> torch.Tensor:
    """The seq-parallel attention ``impl`` (``ring`` | ``ulysses``) names."""
    if impl == "ulysses":
        return ulysses_attention(q, k, v, seq)
    if impl != "ring":
        raise ValueError(f"unknown seq_impl {impl!r} (ring | ulysses)")
    return ring_attention(q, k, v, seq)
