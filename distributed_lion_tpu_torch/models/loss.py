"""Causal-LM loss and eval metrics: port of ``distributed_lion_tpu/models/loss.py``.

:func:`clm_loss_and_metrics` is the dense loss; under an expert axis,
whose ranks split a data rank's batch rows, :func:`clm_loss_sharded_rows`
is one rank's rows' (with the MoE aux); under a seq axis
(``parallel.mesh.SeqAxis``) :func:`clm_loss_seq_parallel` is one chunk's,
with the shard-boundary protocol (:func:`shift_in_next_shard`) that the
chunked head (``ops.xent.chunked_clm_loss_seq_parallel``) and DPO's
logprobs (``train.dpo``) share; under a seq and a pipe axis together
:func:`pipelined_seq_parallel_loss` is the last pipeline stage's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.parallel.pipeline import from_last_stage
from distributed_lion_tpu_torch.parallel.ring_attention import ppermute


def clm_loss_and_metrics(logits: torch.Tensor, tokens: torch.Tensor,
                         loss_mask: Optional[torch.Tensor] = None):
    """Next-token cross entropy with shift-by-one labels (loss.py:15-47).

    ``logits`` [B, T, V] float32, ``tokens`` [B, T] integer (labels are
    ``tokens[:, 1:]``), ``loss_mask`` optional [B, T] over the LABEL
    positions. Returns ``(mean_loss, {"loss", "accuracy", "n_tokens"})``,
    all 0-dim tensors on the logits' device.
    """
    shift_logits = logits[:, :-1]
    shift_labels = tokens[:, 1:].long()
    if loss_mask is None:
        mask = torch.ones(shift_labels.shape, dtype=torch.float32,
                          device=logits.device)
    else:
        mask = loss_mask[:, 1:].to(torch.float32)
    logp = torch.log_softmax(shift_logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, shift_labels[..., None])[..., 0]
    n = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / n
    pred = shift_logits.argmax(-1)
    acc = ((pred == shift_labels) * mask).sum() / n
    return loss, {"loss": loss, "accuracy": acc, "n_tokens": mask.sum()}


def clm_loss_sharded_rows(logits: torch.Tensor, tokens: torch.Tensor, axis,
                          aux: Optional[torch.Tensor] = None, aux_weight: float = 0.01):
    """The causal-LM loss when batch rows are split over ``axis`` (a
    ``parallel.mesh.ExpertAxis``) and the params replicated along it
    (loss.py:50-87): ``local NLL sum / global token count`` (+
    ``aux_weight·aux/shards``), so that the sum of its gradient over the axis
    is the whole batch's; the metrics (``loss`` the cross entropy alone,
    ``accuracy``, ``n_tokens`` a shard's average, ``aux_loss`` the shards'
    mean aux) summed over the axis's group by one ``all_reduce``, outside
    autograd."""
    shift_logits = logits[:, :-1]
    labels = tokens[:, 1:].long()
    logp = torch.log_softmax(shift_logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    shards = axis.size
    with torch.no_grad():
        correct = (shift_logits.argmax(-1) == labels).sum().to(torch.float32)
        sums = torch.stack([torch.tensor(float(nll.numel()), device=nll.device), correct,
                            nll.sum(), torch.zeros((), device=nll.device) if aux is None
                            else aux.detach().to(torch.float32) / shards])
        dist.all_reduce(sums, group=axis.group)
        n_global = torch.clamp_min(sums[0], 1.0)
    loss_local = nll.sum() / n_global
    metrics = {"loss": sums[2] / n_global, "accuracy": sums[1] / n_global,
               "n_tokens": n_global / shards}
    if aux is not None:
        loss_local = loss_local + aux_weight * aux / shards
        metrics["aux_loss"] = sums[3]
    return loss_local, metrics


def shift_in_next_shard(x: torch.Tensor, seq) -> tuple[torch.Tensor, bool]:
    """The seq-parallel shard boundary (loss.py:95-111): ``x`` ``[..., T]``
    shifted left by one column, its last column the NEXT seq rank's first,
    from one ppermute toward the previous rank; and whether this rank holds
    the last chunk, whose filled column (rank 0's) the caller masks."""
    nxt = ppermute(x[..., :1].detach(), seq, shift=-1)
    return torch.cat([x[..., 1:], nxt], dim=-1), seq.rank == seq.size - 1


def shifted_labels_and_mask(tokens: torch.Tensor, seq) -> tuple:
    """Labels ``[B, T]`` and their float32 mask, the last chunk's last
    position masked: it has no next token (loss.py:114-124)."""
    labels, is_last = shift_in_next_shard(tokens, seq)
    mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    if is_last:
        mask[:, -1] = 0.0
    return labels.long(), mask


def seq_parallel_sums(nll_sum: torch.Tensor, correct_sum: torch.Tensor, mask: torch.Tensor,
                      seq) -> tuple:
    """The loss of a seq-parallel chunk and the metrics of the whole
    sequence (loss.py:127-162), from the chunk's masked sums: ``loss_local =
    nll_sum / n_global``, whose gradient summed over the seq group is the
    whole sequence's, and ``{"loss", "accuracy", "n_tokens"}`` summed over
    the group (one ``all_reduce``, outside autograd: only ``loss_local`` is
    differentiated)."""
    with torch.no_grad():
        sums = torch.stack([mask.sum(), correct_sum.detach().to(torch.float32),
                            nll_sum.detach().to(torch.float32)])
        dist.all_reduce(sums, group=seq.group)
        n_global = torch.clamp_min(sums[0], 1.0)
    loss_local = nll_sum / n_global
    return loss_local, {"loss": sums[2] / n_global, "accuracy": sums[1] / n_global,
                        "n_tokens": n_global / seq.size}


def clm_loss_seq_parallel(logits: torch.Tensor, tokens: torch.Tensor, seq) -> tuple:
    """The causal-LM loss of one seq rank's chunk: ``logits`` ``[B, T, V]``
    and ``tokens`` ``[B, T]`` of positions ``[s·T, (s+1)·T)``; a chunk's last
    label is the next chunk's first token (:func:`shifted_labels_and_mask`).
    Returns ``(loss_local, metrics)``: the trainer sums the gradient over the
    seq group."""
    labels, mask = shifted_labels_and_mask(tokens, seq)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    correct = (logits.argmax(-1) == labels).to(torch.float32)
    return seq_parallel_sums((nll * mask).sum(), (correct * mask).sum(), mask, seq)


def pipelined_seq_parallel_loss(head_partials, acc: Optional[torch.Tensor],
                                tokens: torch.Tensor, seq, pipe) -> tuple:
    """The sp × pp loss scaffold of the pipelined models (loss.py:164-203):
    the boundary labels (a hop over the seq group) and the global token
    count on every stage, as the JAX package hoists its collectives out of
    the last-stage branch; ``head_partials(acc, labels, mask) -> (masked nll
    sum, masked correct sum)`` on the last stage only (``acc`` its outputs,
    None elsewhere; zeros stand in on the other stages). Returns
    ``(loss_local, metrics)``: ``loss_local = nll_sum / n_global``, whose
    gradient summed over the seq group (and, for the replicated leaves, the
    pipe group) is the whole batch's; the loss and accuracy summed over the
    seq group, then the pipe group, and ``n_tokens`` the per-seq-shard
    count, the same on every rank."""
    labels, mask = shifted_labels_and_mask(tokens, seq)
    if acc is not None:
        nll_sum, correct_sum = head_partials(acc, labels, mask)
    else:
        nll_sum = correct_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    loss_local, metrics = seq_parallel_sums(nll_sum, correct_sum, mask, seq)
    over = from_last_stage(torch.stack([metrics["loss"], metrics["accuracy"]]), pipe)
    return loss_local, {"loss": over[0], "accuracy": over[1], "n_tokens": metrics["n_tokens"]}
