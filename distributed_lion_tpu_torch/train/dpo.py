"""The DPO loss over a trained policy and a frozen reference: port of ``distributed_lion_tpu/train/dpo.py``.

The reference's ``dpo_llama2.py`` does not parse as shipped; this is its
intended workload, as the JAX package implements it. Policy and reference
score (prompt, chosen) and (prompt, rejected); with β 0.1 the loss is

    −log σ(β · [(logπ_c − logπ_r) − (logref_c − logref_r)])

over a batch ``{"chosen", "rejected", "chosen_mask", "rejected_mask"}`` of
``[B, T]`` rows (``data/dpo.py``), the masks selecting completion tokens.

:func:`make_dpo_loss_fn` builds the trainer's ``loss_fn(batch, seed) ->
(loss, metrics)`` (``train/loop.py``): two policy passes, chosen then
rejected, each with its own adapter-dropout seed folded from the
microbatch's (the JAX package splits its dropout key; in eval, ``seed``
None, there is no dropout), and two reference passes under
``torch.no_grad()`` (the JAX package's ``stop_gradient``). Metrics are the
JAX package's: ``loss``, ``reward_accuracy`` and ``reward_margin``.

With ``vocab_chunks`` > 0 the apply functions return ``(hidden, head)``
in place of logits and the label logprobs stream through the
chunked-vocabulary cross entropy (:func:`sequence_logprob_chunked`,
``ops/xent.py``): none of the four passes writes a ``[B, T, V]`` float32
``log_softmax``. Under tensor parallelism the apply functions close over
this rank's slices and reduce over the tensor group inside the model, so
the loss needs no variant of its own (the JAX package threads the frozen
trees through its step as arguments, ``make_dpo_loss_fn_frozen``; here they
stay in the closures).

Under a seq axis (``seq_axis``, a ``parallel.mesh.SeqAxis``; dpo.py:32-118)
every ``[B, T]`` leaf is this rank's token chunk.
:func:`sequence_logprob_seq_parallel` and
:func:`sequence_logprob_chunked_seq_parallel` take a chunk's last label and
its mask bit from the next chunk (one ppermute of both,
``models.loss.shift_in_next_shard``), drop the last chunk's last position,
and sum the chunk's partial logprobs over the seq group through *g*
(``reduce_from_tp_region`` on the seq group: ``all_reduce`` forward,
identity backward), so every seq rank computes the same pairwise loss and
the trainer's sum of the gradient over the seq group is the whole
sequence's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from distributed_lion_tpu_torch.models.gpt2 import fold_seed
from distributed_lion_tpu_torch.models.loss import shift_in_next_shard
from distributed_lion_tpu_torch.ops.xent import chunked_softmax_xent
from distributed_lion_tpu_torch.parallel.mesh import SeqAxis
from distributed_lion_tpu_torch.parallel.tensor_parallel import reduce_from_tp_region


def sequence_logprob(logits: torch.Tensor, tokens: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Sum of the label log-probs over the masked (completion) positions,
    ``[B]``: float32 ``log_softmax`` of ``logits[:, :-1]``, labels
    ``tokens[:, 1:]``, weights ``mask[:, 1:]``."""
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return (ll * mask[:, 1:].to(torch.float32)).sum(-1)


def sequence_logprob_chunked(hidden: torch.Tensor, head: torch.Tensor, tokens: torch.Tensor,
                             mask: torch.Tensor, n_chunks: int,
                             emb_layout: str = "dv") -> torch.Tensor:
    """:func:`sequence_logprob` from final hidden states ``[B, T, d]`` and
    the head (dpo.py:66-83): each label's logprob is −nll of
    ``ops.xent.chunked_softmax_xent``, so no ``[B, T, V]`` tensor exists."""
    b, t, d = hidden.shape
    h = hidden[:, :-1].reshape(b * (t - 1), d)
    nll, _ = chunked_softmax_xent(h, head, tokens[:, 1:].reshape(-1), n_chunks, emb_layout)
    return (-nll.reshape(b, t - 1) * mask[:, 1:].to(torch.float32)).sum(-1)


def _shifted_label_mask(tokens: torch.Tensor, mask: torch.Tensor, seq: SeqAxis) -> tuple:
    """A chunk's labels and their float32 mask bits, each a chunk's last
    column from the next chunk (one ppermute of both), the last chunk's last
    position dropped (dpo.py:48-54)."""
    both, is_last = shift_in_next_shard(torch.stack([tokens.long(), mask.long()]), seq)
    lmask = both[1].to(torch.float32)
    if is_last:
        lmask[:, -1] = 0.0
    return both[0], lmask


def sequence_logprob_seq_parallel(logits: torch.Tensor, tokens: torch.Tensor,
                                  mask: torch.Tensor, seq: SeqAxis) -> torch.Tensor:
    """:func:`sequence_logprob` of the whole sequence ``[B]`` from one seq
    rank's chunk (module doc)."""
    labels, lmask = _shifted_label_mask(tokens, mask, seq)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    return reduce_from_tp_region((ll * lmask).sum(-1), seq.group)


def sequence_logprob_chunked_seq_parallel(hidden: torch.Tensor, head: torch.Tensor,
                                          tokens: torch.Tensor, mask: torch.Tensor,
                                          seq: SeqAxis, n_chunks: int,
                                          emb_layout: str = "dv") -> torch.Tensor:
    """:func:`sequence_logprob_seq_parallel` from final hidden states and the
    head, through the chunked-vocabulary cross entropy (dpo.py:96-118)."""
    labels, lmask = _shifted_label_mask(tokens, mask, seq)
    b, t, d = hidden.shape
    nll, _ = chunked_softmax_xent(hidden.reshape(b * t, d), head, labels.reshape(-1),
                                  n_chunks, emb_layout)
    return reduce_from_tp_region((-nll.reshape(b, t) * lmask).sum(-1), seq.group)


def make_dpo_loss_fn(policy_apply: Callable, ref_apply: Callable, beta: float = 0.1, *,
                     seq_axis: Optional[SeqAxis] = None, vocab_chunks: int = 0) -> Callable:
    """``loss_fn(batch, seed) -> (loss, metrics)`` from
    ``policy_apply(tokens, dropout_seed)`` (the adapters in its closure) and
    ``ref_apply(tokens)`` (the frozen reference), each returning logits, or
    with ``vocab_chunks`` > 0 ``(hidden, head)`` with the head ``[d, V]``
    (dpo.py:132-160; the loss is then marked ``_vocab_chunked``). With
    ``seq_axis`` (size > 1) the batch is this rank's token chunk and the
    apply functions run the model on the same axis."""
    sp = seq_axis is not None and seq_axis.size > 1

    def seqlp(out, tokens, mask):
        if vocab_chunks <= 0:
            return (sequence_logprob_seq_parallel(out, tokens, mask, seq_axis) if sp
                    else sequence_logprob(out, tokens, mask))
        if not (isinstance(out, tuple) and len(out) == 2):
            raise TypeError(
                "vocab_chunks > 0 requires apply functions returning (hidden, head); got "
                f"{type(out).__name__}")
        if sp:
            return sequence_logprob_chunked_seq_parallel(*out, tokens, mask, seq_axis,
                                                         vocab_chunks)
        return sequence_logprob_chunked(*out, tokens, mask, vocab_chunks)

    def loss_fn(batch: dict, seed: Optional[int]):
        seed_c = seed_r = None
        if seed is not None:  # one adapter-dropout seed per policy pass
            seed_c, seed_r = fold_seed(seed, 0), fold_seed(seed, 1)
        chosen, rejected = batch["chosen"], batch["rejected"]
        pol_c = seqlp(policy_apply(chosen, seed_c), chosen, batch["chosen_mask"])
        pol_r = seqlp(policy_apply(rejected, seed_r), rejected, batch["rejected_mask"])
        with torch.no_grad():
            ref_c = seqlp(ref_apply(chosen), chosen, batch["chosen_mask"])
            ref_r = seqlp(ref_apply(rejected), rejected, batch["rejected_mask"])
        logits = beta * ((pol_c - pol_r) - (ref_c - ref_r))
        loss = -F.logsigmoid(logits).mean()
        with torch.no_grad():
            reward_c, reward_r = beta * (pol_c - ref_c), beta * (pol_r - ref_r)
            metrics = {"loss": loss.detach(),
                       "reward_accuracy": (reward_c > reward_r).to(torch.float32).mean(),
                       "reward_margin": (reward_c - reward_r).mean()}
        return loss, metrics

    if vocab_chunks > 0:
        loss_fn._vocab_chunked = True
    return loss_fn
