"""Pipeline-parallel GPT-2: port of ``distributed_lion_tpu/models/gpt2_pipe.py``.

``run_clm --pipeline_parallel S`` splits GPT-2's blocks into S stages over
the pipe group (``parallel.mesh.PipeAxis``). Stage ``p`` (:class:`GPT2Stage`)
holds blocks ``[p·L/S, (p+1)·L/S)`` as an ``nn.ModuleList`` and the
replicated ``wte``, ``wpe`` and ``ln_f``, cut from the same seeded init as
the unsplit model; its parameters keep the unsplit model's names
(``blocks.6.attn.qkv`` on stage 1 of 2 at 12 layers), so weights, momentum
and checkpoints carry over by name. The JAX package stacks the stages'
leaves ``[S, L/S, ...]`` and shards them over ``pipe``; the weight carrier
(``utils/serialization.py``) maps that layout to the stages.

:func:`make_pipeline_loss` (JAX :110-233) runs the GPipe schedule of
``parallel/pipeline.py``: stage 0 embeds each microbatch, every stage runs
its blocks through ``models.gpt2.remat`` (``remat_policy`` included), and
the last stage computes ONE head loss over all M microbatches' outputs
concatenated to ``[B, T, d]``, a mean over all B·T tokens, with the padded
vocabulary columns dropped, or the chunked cross entropy with
``vocab_chunks``. The other stages skip the head. The loss function runs the
backward itself (``_runs_backward``: the trainer does not call
``loss.backward()``), and its loss and metrics reach every stage by a sum
over the pipe group of the last stage's values and the others' zeros, as
JAX's ``psum``. Stage leaves end with complete gradients; the replicated
leaves carry disjoint partials (stage 0 the embedding's, the last stage the
tied head's and ``ln_f``'s), which the trainer sums over the pipe group.

Under a tensor axis each stage's blocks run tensor-parallel (tp × pp) with
the activations replicated over the tensor group at the stage boundaries;
under a seq axis (sp × pp) each stage's rank holds its token chunk, its
blocks ring their attention over the seq group inside every tick, and the
loss is :func:`models.loss.pipelined_seq_parallel_loss`'s. Dropout is
refused (:func:`validate_pipeline`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_lion_tpu_torch.models.gpt2 import (
    GPT2,
    GPT2Config,
    _layer_norm,
    jax_leaf_order,
    remat,
)
from distributed_lion_tpu_torch.models.loss import (
    clm_loss_and_metrics,
    pipelined_seq_parallel_loss,
)
from distributed_lion_tpu_torch.ops.products import matmul_f32
from distributed_lion_tpu_torch.ops.xent import chunked_clm_loss_and_metrics, masked_local_nll
from distributed_lion_tpu_torch.parallel.mesh import PipeAxis, SeqAxis, TensorAxis, resolve_device
from distributed_lion_tpu_torch.parallel.pipeline import GPipe, from_last_stage, stage_layers
from distributed_lion_tpu_torch.parallel.tensor_parallel import gpt2_shard_dim


def is_stage_leaf(name: str) -> bool:
    """Whether leaf ``name`` belongs to one stage (split over the pipe
    axis), not replicated over it."""
    return name.startswith("blocks.")


def whole_name(name: str, first: int) -> str:
    """A stage's local leaf name (``blocks.<i>.…``) as the unsplit model's,
    its blocks starting at layer ``first``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        parts[1] = str(first + int(parts[1]))
    return ".".join(parts)


def pipeline_params(state: dict, n_layer: int, pipe: PipeAxis) -> dict:
    """Stage ``pipe.rank``'s leaves of a whole-model state dict: the
    replicated ones and its blocks, under the unsplit model's names."""
    mine = stage_layers(n_layer, pipe)
    return {k: v for k, v in state.items()
            if not is_stage_leaf(k) or int(k.split(".")[1]) in mine}


def unpipeline_params(stages: list) -> dict:
    """The whole model's state dict from every stage's (the replicated
    leaves taken from the first)."""
    whole: dict = {}
    for s in stages:
        for k, v in s.items():
            whole.setdefault(k, v)
    return whole


def pipeline_param_specs(tensor: bool = False) -> Callable[[str], tuple]:
    """The shard rule of the pipeline layout (JAX :68-107): ``name ->
    (split over pipe, dim split over tensor or None)``. Each stage's blocks
    are split over pipe; with ``tensor`` their Megatron dims too
    (``parallel.tensor_parallel.gpt2_shard_dim``). ``wte``, ``wpe`` and
    ``ln_f`` are replicated over both."""
    def rule(name: str) -> tuple:
        return is_stage_leaf(name), (gpt2_shard_dim(name) if tensor else None)
    return rule


def validate_pipeline(model_cfg, cfg, pp: int, n_micro: int) -> None:
    """Config-time guards for ``--pipeline_parallel`` (JAX :236-254, its
    words)."""
    if model_cfg.n_layer % pp:
        raise ValueError(f"n_layer {model_cfg.n_layer} not divisible by "
                         f"pipeline stages {pp}")
    if getattr(model_cfg, "dropout", 0.0) > 0.0:
        raise ValueError("dropout is unsupported under pipeline parallelism "
                         "(per-microbatch keys would need schedule-aware "
                         "plumbing); set --dropout 0")
    check_microbatches(cfg, n_micro)


def check_microbatches(cfg, n_micro: int) -> None:
    """The train and eval batches split into ``n_micro`` microbatches."""
    if cfg.per_device_train_batch_size % n_micro:
        raise ValueError(
            f"per_device_train_batch_size {cfg.per_device_train_batch_size} "
            f"not divisible by pipeline_microbatches {n_micro}")
    if cfg.per_device_eval_batch_size % n_micro:
        raise ValueError(
            f"per_device_eval_batch_size {cfg.per_device_eval_batch_size} "
            f"not divisible by pipeline_microbatches {n_micro}")


class GPT2Stage(nn.Module):
    """Stage ``pipe.rank`` of a pipelined GPT-2 (module doc): drawn whole on
    the CPU from ``seed`` as :class:`models.gpt2.GPT2` draws it (its tensor
    slices under ``tp``), the stage's blocks and the replicated leaves kept
    and moved to ``device``."""

    def __init__(self, cfg: GPT2Config, pipe: PipeAxis, *, device="cuda", seed: int = 0,
                 tp: Optional[TensorAxis] = None, seq: Optional[SeqAxis] = None):
        super().__init__()
        device = resolve_device(device)
        whole = GPT2(cfg, device="cpu", seed=seed, tp=tp, seq=seq)
        self.cfg, self.pipe, self.tp, self.seq = cfg, pipe, whole.tp, whole.seq
        self.layers = stage_layers(cfg.n_layer, pipe)
        self.wte, self.wpe, self.ln_f = whole.wte, whole.wpe, whole.ln_f
        self.blocks = nn.ModuleList(whole.blocks[i] for i in self.layers)
        del whole
        self.to(device)

    def jax_named_parameters(self) -> list:
        """The stage's parameters under the unsplit model's names, in
        ``jax.tree.leaves`` order of those names: the flat layout."""
        return jax_leaf_order((whole_name(n, self.layers.start), p)
                              for n, p in self.named_parameters())

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Stage 0's input: token and position embeddings in the compute
        dtype, positions from the seq chunk's first."""
        cd, T = self.cfg.compute_dtype, tokens.shape[1]
        start = self.seq.rank * T
        return F.embedding(tokens, self.wte).to(cd) + self.wpe[start:start + T].to(cd)

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = remat(block, self.cfg, x, self.cfg, None)
        return x


def stage_loss(tokens: torch.Tensor, *, pipe: PipeAxis, seq: SeqAxis, n_micro: int,
               embed: Callable, run_blocks: Callable, final: Callable, head_loss: Callable,
               head_partials: Callable, width: int, dtype) -> tuple:
    """One pipelined causal-LM loss of this stage's rank (module doc):
    ``embed(tokens)`` on stage 0, ``run_blocks`` on every stage,
    ``final(acc)`` (the last norm) and ``head_loss(h, tokens)`` or, under a
    seq axis, ``head_partials(h, labels, mask)`` on the last stage. Runs the
    backward when grad is on. Returns ``(loss, metrics)`` outside autograd,
    the same on every stage."""
    B, T = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro {n_micro}")
    mb = B // n_micro
    grad = torch.is_grad_enabled()
    run = GPipe(run_blocks, pipe, n_micro)
    outs = run.forward(lambda i: embed(tokens[i * mb:(i + 1) * mb]),
                       ((mb, T, width), dtype, tokens.device))
    last = outs is not None
    acc = torch.cat(outs) if last else None
    if seq.size > 1:
        loss, metrics = pipelined_seq_parallel_loss(
            lambda a, labels, mask: head_partials(final(a), labels, mask), acc, tokens, seq,
            pipe)
    elif last:
        loss, metrics = head_loss(final(acc), tokens)
    else:
        loss = None
    if grad:
        if last:
            loss.backward()
        run.backward([o.grad for o in outs] if last else None)
    if seq.size > 1:
        return from_last_stage(loss, pipe), metrics
    keys = ("loss", "accuracy", "n_tokens")
    vec = (torch.stack([metrics[k].detach().to(torch.float32) for k in keys]) if last
           else torch.zeros(len(keys), dtype=torch.float32, device=tokens.device))
    vec = from_last_stage(vec, pipe)
    return vec[0], dict(zip(keys, vec))


def make_pipeline_loss(stage: GPT2Stage, n_micro: int, vocab_chunks: int = 0) -> Callable:
    """The trainer's ``loss_fn(batch, seed)`` of a GPT-2 stage (JAX
    :110-233): ``batch`` ``[B, T]`` tokens (the rank's token chunk under a
    seq axis), B divisible by ``n_micro``. Marked ``_runs_backward`` (and
    ``_vocab_chunked`` with ``vocab_chunks``)."""
    cfg = stage.cfg

    def head_loss(h, tokens):
        if vocab_chunks > 0:
            return chunked_clm_loss_and_metrics(h, stage.wte, tokens, vocab_chunks,
                                                valid_v=cfg.vocab_size)
        logits = matmul_f32(h, stage.wte.to(h.dtype).t())
        # the padded-vocabulary layout: its alignment columns dropped
        return clm_loss_and_metrics(logits[..., :cfg.vocab_size], tokens)

    def head_partials(h, labels, mask):
        return masked_local_nll(h, stage.wte, labels, mask, vocab_chunks,
                                valid_v=cfg.vocab_size)

    def loss_fn(batch, seed):
        del seed   # dropout is refused under pipelining
        if isinstance(batch, dict):
            raise NotImplementedError("the pipelined GPT-2 loss takes token batches")
        if stage.seq.size == 1 and batch.shape[1] > cfg.n_ctx:
            raise ValueError(f"sequence length {batch.shape[1]} exceeds n_ctx {cfg.n_ctx}")
        return stage_loss(batch, pipe=stage.pipe, seq=stage.seq, n_micro=n_micro,
                          embed=stage.embed, run_blocks=stage.run_blocks,
                          final=lambda a: _layer_norm(a, stage.ln_f), head_loss=head_loss,
                          head_partials=head_partials, width=cfg.d_model,
                          dtype=cfg.compute_dtype)

    loss_fn._runs_backward = True
    if vocab_chunks > 0:
        loss_fn._vocab_chunked = True
    return loss_fn
