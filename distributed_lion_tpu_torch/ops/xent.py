"""Chunked and vocab-parallel cross entropy: port of ``distributed_lion_tpu/ops/xent.py``.

The causal-LM loss without the ``[N, V]`` float32 logits: the head's
product, the streaming logsumexp, the label gather and the argmax of the
accuracy metric run one vocabulary chunk at a time. At Llama-3-8B's
vocabulary of 128,256 one row of T 2048 has float32 logits of 1.05 GB, and
the dense path writes a ``log_softmax`` of the same size and two more in
its backward.

:func:`chunked_softmax_xent` keeps the JAX contract:

- chunk ``c`` is a view of the original head, rows ``emb[s:s+vc]``
  (``"vd"``, a tied ``[V, d]`` embedding) or columns ``emb[:, s:s+vc]``
  (``"dv"``, an untied ``[d, V]`` head), with ``vc = ceil(V / n_chunks)``
  and ``s = min(c·vc, V − vc)``: no padded or transposed copy of the head.
  Columns below ``c·vc`` (the tail chunk's overlap with the one before)
  and columns ≥ ``valid_v`` (a padded head's alignment columns) are −inf,
  out of the logsumexp, the gather and the argmax;
- the carries ``(max, sumexp, label logit, best, best index)`` with the
  JAX body's ``isfinite`` guards (xent.py:84-107), so every all-masked
  chunk adds nothing; the argmax takes a later chunk only on a strictly
  larger maximum and the first index within a chunk, so ``correct`` is the
  dense argmax's;
- each chunk's logits are a compute-dtype product with a float32 result
  (``ops.products.product_f32``, the JAX ``preferred_element_type``
  einsum), the head chunk cast to the hidden dtype first.

The JAX body is ``jax.checkpoint``-ed: its backward recomputes each chunk's
logits. Here a ``torch.autograd.Function`` does the same. The forward saves
only its inputs and the ``[N]`` logsumexp, no chunk's logits; the backward
recomputes chunk by chunk ``p = exp(logits − lse)``, forms the cotangent
``g·(p − onehot)``, rounds it to the hidden dtype (as
``ops.products.matmul_f32``'s backward does) and adds its two products:
into a float32 ``d hidden``, rounded once at the end as the dense head's
one product is, and into the chunk's own columns (or rows) of one
head-gradient buffer, only those of its ``[c·vc, s + vc)`` window. A
masked column's cotangent is exactly 0, so no column's gradient depends on
another chunk, and the head's gradient is one buffer, where autograd's
backward of a slice would allocate a zero head per chunk. Peak logits
memory is one ``[N, vc]`` float32 chunk in each pass.

:func:`chunked_clm_loss_and_metrics` is the shift-by-one causal-LM loss
from final hidden states (``models.loss.clm_loss_and_metrics``' contract);
:func:`masked_local_nll` gives the masked sums for a loss of its own.

:func:`tp_vocab_xent` is Megatron's vocab-parallel cross entropy
(xent.py:123-190): each tensor rank holds ``[d, V/tp]`` contiguous columns of
the head and computes only their logits. The normalizer comes from the
maximum over ranks of the detached logits and the sum over ranks of the
rank's ``Σ exp`` (*g*); the label logit from the one rank whose columns hold
it (*g*); columns at or above ``valid_v`` are −inf; the argmax of the
accuracy metric is the maximum over ranks, then the minimum id among the
ranks that reach it, which keeps the dense argmax's lowest-index tie rule.
``hidden`` enters through *f*, so its cotangent is summed over the tensor
group. :func:`tp_vocab_clm_loss_and_metrics` is its shift-by-one causal-LM
loss (xent.py:290-305). :func:`chunked_clm_loss_seq_parallel` is the
chunked loss of one seq rank's chunk (xent.py:213-252): the labels and mask
of ``models.loss.shifted_labels_and_mask``, the chunk's masked sums from
:func:`masked_local_nll`, the loss and metrics of
``models.loss.seq_parallel_sums``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from distributed_lion_tpu_torch.models.loss import seq_parallel_sums, shifted_labels_and_mask
from distributed_lion_tpu_torch.ops.products import matmul_f32, product_f32
from distributed_lion_tpu_torch.parallel.mesh import TensorAxis
from distributed_lion_tpu_torch.parallel.tensor_parallel import (
    all_max,
    all_min,
    copy_to_tp_region,
    reduce_from_tp_region,
)

LAYOUTS = ("vd", "dv")


def _chunk(emb: torch.Tensor, start: int, vc: int, layout: str, dtype) -> torch.Tensor:
    """Chunk ``[start, start + vc)`` of the head as a ``[d, vc]`` right
    operand in ``dtype`` (a view where the dtype already matches)."""
    ec = emb[start:start + vc].t() if layout == "vd" else emb[:, start:start + vc]
    return ec.to(dtype)


def _masked_logits(hidden, emb, start, lo, vc, v_real, layout) -> torch.Tensor:
    """float32 logits ``[N, vc]`` of one chunk, −inf outside
    ``[lo, v_real)``."""
    logits = product_f32(hidden, _chunk(emb, start, vc, layout, hidden.dtype))
    cols = start + torch.arange(vc, device=hidden.device)
    fresh = (cols >= lo) & (cols < v_real)
    return logits.masked_fill_(~fresh[None, :], float("-inf"))


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, emb, labels, n_chunks, layout, v_real):
        n = hidden.shape[0]
        v = emb.shape[0] if layout == "vd" else emb.shape[1]
        vc = -(-v // n_chunks)
        dev = hidden.device
        m = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
        s = torch.zeros(n, dtype=torch.float32, device=dev)
        lab = torch.zeros(n, dtype=torch.float32, device=dev)
        best = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
        besti = torch.zeros(n, dtype=torch.int64, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        for c in range(n_chunks):
            start = min(c * vc, v - vc)
            logits = _masked_logits(hidden, emb, start, c * vc, vc, v_real, layout)
            cm = logits.max(-1).values
            local = labels - start
            in_range = (labels >= c * vc) & (local < vc)
            gathered = torch.gather(logits, 1, local.clamp(0, vc - 1)[:, None])[:, 0]
            lab = lab + torch.where(in_range, gathered, zero)
            upd = cm > best
            best = torch.where(upd, cm, best)
            besti = torch.where(upd, logits.argmax(-1) + start, besti)
            new_m = torch.maximum(m, cm)
            scale = torch.where(torch.isfinite(m), torch.exp(m - new_m), zero)
            # the chunk's logits are spent: exp(logits - new_m) in place
            add = torch.where(torch.isfinite(cm),
                              logits.sub_(new_m[:, None]).exp_().sum(-1), zero)
            s = s * scale + add
            m = new_m
        lse = m + torch.log(s)
        ctx.save_for_backward(hidden, emb, labels, lse)
        ctx.n_chunks, ctx.layout, ctx.v_real = n_chunks, layout, v_real
        correct = besti == labels
        ctx.mark_non_differentiable(correct)
        return lse - lab, correct

    @staticmethod
    def backward(ctx, g, _):
        hidden, emb, labels, lse = ctx.saved_tensors
        n_chunks, layout, v_real = ctx.n_chunks, ctx.layout, ctx.v_real
        v = emb.shape[0] if layout == "vd" else emb.shape[1]
        vc = -(-v // n_chunks)
        need_h, need_e = ctx.needs_input_grad[:2]
        # d hidden sums over the chunks in float32 and is rounded once, as
        # the dense head's one product over the whole vocabulary is
        dh = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device) if need_h \
            else None
        de = torch.zeros_like(emb) if need_e else None
        g = g.to(torch.float32)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        for c in range(n_chunks):
            start, lo = min(c * vc, v - vc), c * vc
            if lo >= v:
                break  # this chunk and every later one hold only counted columns
            logits = _masked_logits(hidden, emb, start, lo, vc, v_real, layout)
            logits.sub_(lse[:, None]).exp_().mul_(g[:, None])  # g·p, 0 where masked
            local = labels - start
            in_range = (labels >= lo) & (local < vc)
            logits[rows[in_range], local[in_range]] -= g[in_range]  # g·(p − onehot)
            d = logits.to(hidden.dtype)
            del logits  # only the rounded cotangent enters the products
            if need_h:
                dh += product_f32(d, _chunk(emb, start, vc, layout, hidden.dtype).t())
            if need_e:
                off = lo - start  # the chunk's columns below lo belong to the one before
                gw = hidden.t() @ d[:, off:]  # [d, vc − off]
                if layout == "vd":
                    de[lo:start + vc].copy_(gw.t())
                else:
                    de[:, lo:start + vc].copy_(gw)
        return None if dh is None else dh.to(hidden.dtype), de, None, None, None, None


def chunked_softmax_xent(hidden: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                         n_chunks: int = 8, emb_layout: str = "vd",
                         valid_v: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming cross entropy against a head (xent.py:26-118).

    ``hidden`` ``[N, d]`` (any float dtype), ``emb`` the head, ``[V, d]``
    with ``"vd"`` or ``[d, V]`` with ``"dv"``, ``labels`` ``[N]`` ids below
    ``V``. ``valid_v`` > 0 marks head columns ≥ it as padding. Returns
    ``(nll [N] float32, correct [N] bool)``: the per-position negative log
    likelihood and argmax == label."""
    if emb_layout not in LAYOUTS:
        raise ValueError(f"emb_layout must be 'vd' or 'dv', got {emb_layout!r}")
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    v = emb.shape[0] if emb_layout == "vd" else emb.shape[1]
    v_real = valid_v if valid_v > 0 else v
    if v_real > v:
        raise ValueError(f"valid_v {v_real} > head columns {v}")
    return _ChunkedXent.apply(hidden, emb, labels.long(), n_chunks, emb_layout, v_real)


def _shifted_clm_metrics(xent_fn: Callable, hidden: torch.Tensor, tokens: torch.Tensor,
                         loss_mask: Optional[torch.Tensor]):
    """The shift-by-one tail (xent.py:199-215): ``xent_fn(h [N, d],
    labels [N]) -> (nll, correct)`` over positions 0..T−2 predicting tokens
    1..T−1; the masked mean loss and accuracy."""
    b, t, d = hidden.shape
    h = hidden[:, :-1].reshape(b * (t - 1), d)
    labels = tokens[:, 1:].reshape(-1).long()
    nll, correct = xent_fn(h, labels)
    if loss_mask is None:
        mask = torch.ones_like(nll)
    else:
        mask = loss_mask[:, 1:].reshape(-1).to(torch.float32)
    nmask = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / nmask
    acc = (correct.to(torch.float32) * mask).sum() / nmask
    return loss, {"loss": loss, "accuracy": acc, "n_tokens": mask.sum()}


def chunked_clm_loss_and_metrics(hidden: torch.Tensor, emb: torch.Tensor,
                                 tokens: torch.Tensor, n_chunks: int = 8,
                                 loss_mask: Optional[torch.Tensor] = None,
                                 emb_layout: str = "vd", valid_v: int = 0):
    """The causal-LM loss from final hidden states ``[B, T, d]``
    (xent.py:306-325): ``(mean_loss, {"loss", "accuracy", "n_tokens"})``,
    the contract of ``models.loss.clm_loss_and_metrics``; ``loss_mask``
    ``[B, T]`` over the label positions."""
    return _shifted_clm_metrics(
        lambda h, lab: chunked_softmax_xent(h, emb, lab, n_chunks, emb_layout, valid_v),
        hidden, tokens, loss_mask)


def tp_vocab_xent(hidden: torch.Tensor, head_shard: torch.Tensor, labels: torch.Tensor,
                  tp: TensorAxis, valid_v: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Vocab-parallel cross entropy (module doc). ``hidden`` ``[N, d]``,
    replicated over the tensor group; ``head_shard`` ``[d, V/tp]``, this
    rank's columns ``[t·V/tp, (t+1)·V/tp)``; ``labels`` ``[N]``. Returns
    ``(nll [N] float32, correct [N] bool)``, the same on every rank."""
    vshard = head_shard.shape[1]
    start = tp.rank * vshard
    hidden = copy_to_tp_region(hidden, tp.group)
    logits = matmul_f32(hidden, head_shard.to(hidden.dtype))
    cols = start + torch.arange(vshard, device=hidden.device)
    if valid_v > 0:
        # padding columns: out of the normalizer and the argmax, zero grad
        logits = logits.masked_fill((cols >= valid_v)[None, :], float("-inf"))
    with torch.no_grad():
        # the shift cancels in the softmax's gradient: detached, exactly
        m = all_max(logits.max(-1).values, tp.group)
    se = reduce_from_tp_region(torch.exp(logits - m[:, None]).sum(-1), tp.group)
    lse = torch.log(se) + m
    labels = labels.long()
    in_range = (labels >= start) & (labels < start + vshard)
    idx = torch.clamp(labels - start, 0, vshard - 1)
    lab = torch.gather(logits, 1, idx[:, None])[:, 0]
    label_logit = reduce_from_tp_region(torch.where(in_range, lab, 0.0), tp.group)
    nll = lse - label_logit
    with torch.no_grad():
        stopped = logits.detach()
        cand = torch.where(stopped.max(-1).values == m, stopped.argmax(-1) + start,
                           torch.full_like(labels, 2**30))
        best = all_min(cand, tp.group)
    return nll, best == labels


def tp_vocab_clm_loss_and_metrics(hidden: torch.Tensor, head_shard: torch.Tensor,
                                  tokens: torch.Tensor, tp: TensorAxis,
                                  loss_mask: Optional[torch.Tensor] = None, valid_v: int = 0):
    """The shift-by-one causal-LM loss over a vocab-split head (xent.py:290-305):
    the contract of :func:`chunked_clm_loss_and_metrics`; ``valid_v`` masks a
    padded head's alignment columns."""
    return _shifted_clm_metrics(
        lambda h, lab: tp_vocab_xent(h, head_shard, lab, tp, valid_v), hidden, tokens,
        loss_mask)


def masked_local_nll(hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor, n_chunks: int = 0, emb_layout: str = "vd",
                     valid_v: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``hidden`` ``[B, T, d]`` with per-position ``labels`` and ``mask``
    ``[B, T]`` → (masked nll sum, masked correct count), float32 scalars
    (xent.py:259-296). ``n_chunks`` > 0 streams the head through
    :func:`chunked_softmax_xent`; else a dense float32 ``log_softmax``
    (``valid_v`` cuts a padded head's columns first)."""
    b, t, d = hidden.shape
    flat_labels = labels.reshape(-1).long()
    if n_chunks > 0:
        nll, correct = chunked_softmax_xent(hidden.reshape(b * t, d), head, flat_labels,
                                            n_chunks, emb_layout, valid_v)
    else:
        w = head.t() if emb_layout == "vd" else head
        logits = matmul_f32(hidden.reshape(b * t, d), w.to(hidden.dtype))
        if valid_v > 0:
            logits = logits[:, :valid_v]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, flat_labels[:, None])[:, 0]
        correct = logp.argmax(-1) == flat_labels
    fm = mask.reshape(-1).to(torch.float32)
    return (nll * fm).sum(), (correct.to(torch.float32) * fm).sum()


def chunked_clm_loss_seq_parallel(hidden: torch.Tensor, emb: torch.Tensor,
                                  tokens: torch.Tensor, n_chunks: int, seq,
                                  emb_layout: str = "vd", valid_v: int = 0):
    """The chunked-vocabulary loss of one seq rank's chunk ``hidden`` ``[B,
    T, d]``, ``tokens`` ``[B, T]``: ``(loss_local, metrics)`` with
    ``models.loss.clm_loss_seq_parallel``'s contract, and no ``[B, T, V]``
    logits."""
    labels, mask = shifted_labels_and_mask(tokens, seq)
    nll_sum, correct_sum = masked_local_nll(hidden, emb, labels, mask, n_chunks, emb_layout,
                                            valid_v)
    return seq_parallel_sums(nll_sum, correct_sum, mask, seq)
