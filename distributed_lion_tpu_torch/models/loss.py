"""Causal-LM loss and eval metrics: port of ``distributed_lion_tpu/models/loss.py``."""

from __future__ import annotations

from typing import Optional

import torch


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
