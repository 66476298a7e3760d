"""Pipeline-parallel Llama: port of ``distributed_lion_tpu/models/llama_pipe.py``.

The Llama twin of ``models/gpt2_pipe.py``, the same GPipe schedule
(``parallel/pipeline.py``) and the same contracts: stage ``p``
(:class:`LlamaStage`) holds blocks ``[p·L/S, (p+1)·L/S)`` of the seeded
init's tree (``models.llama.llama_init`` with ``layers``) and the replicated
``wte``, ``lm_head`` and ``ln_f``, under the unsplit model's names. The
boundary layers differ from GPT-2's: the rotary tables (from T, offset by
the seq chunk's first position under a seq axis) replace the learned
positions, RMSNorm the LayerNorm, and the head is the untied ``lm_head`` in
its ``[d, V]`` layout (``"dv"``), streamed through the chunked cross entropy
with ``vocab_chunks``. Stage 0's ``wte`` and the last stage's ``lm_head``
and ``ln_f`` carry the replicated leaves' disjoint gradient partials, which
the trainer sums over the pipe group.
"""

from __future__ import annotations

from typing import Callable, Optional

from torch import nn

from distributed_lion_tpu_torch.models.gpt2 import jax_leaf_order, remat
from distributed_lion_tpu_torch.models.gpt2_pipe import (
    check_microbatches,
    is_stage_leaf,
    stage_loss,
    whole_name,
)
from distributed_lion_tpu_torch.models.llama import (
    LlamaConfig,
    _block,
    rms_norm,
    rope_angles,
)
from distributed_lion_tpu_torch.models.lora import iter_paths, lora_embed
from distributed_lion_tpu_torch.models.loss import clm_loss_and_metrics
from distributed_lion_tpu_torch.ops.products import matmul_f32
from distributed_lion_tpu_torch.ops.xent import chunked_clm_loss_and_metrics, masked_local_nll
from distributed_lion_tpu_torch.parallel.mesh import PipeAxis, SeqAxis, TensorAxis
from distributed_lion_tpu_torch.parallel.pipeline import stage_layers
from distributed_lion_tpu_torch.parallel.tensor_parallel import llama_shard_dim


def llama_pipeline_params(tree: dict, pipe: PipeAxis) -> dict:
    """Stage ``pipe.rank``'s part of a whole Llama weight tree: the
    replicated leaves and its blocks."""
    mine = stage_layers(len(tree["blocks"]), pipe)
    return {k: ([tree["blocks"][i] for i in mine] if k == "blocks" else v)
            for k, v in tree.items()}


def llama_pipeline_param_specs(tensor: bool = False) -> Callable[[str], tuple]:
    """``name -> (split over pipe, dim split over tensor or None)`` (JAX
    :63-92): the stage blocks over pipe, with ``tensor`` their Megatron
    dims too; ``wte``, ``lm_head`` and ``ln_f`` replicated over both."""
    def rule(name: str) -> tuple:
        return is_stage_leaf(name), (llama_shard_dim(name) if tensor else None)
    return rule


def validate_llama_pipeline(model_cfg: LlamaConfig, cfg, pp: int, n_micro: int) -> None:
    """Config-time guards for ``--pipeline_parallel`` on the Llama family
    (JAX :193-208)."""
    if model_cfg.n_layer % pp:
        raise ValueError(f"n_layer {model_cfg.n_layer} not divisible by "
                         f"pipeline stages {pp}")
    check_microbatches(cfg, n_micro)


class LlamaStage(nn.Module):
    """Stage ``pipe.rank`` of a pipelined Llama over its weight tree
    ``params`` (``{"wte", "lm_head", "ln_f", "blocks": [its blocks]}``, every
    leaf an ``nn.Parameter``; ``tp`` size > 1: this rank's slices). The
    tensors are not registered as module parameters, as in
    :class:`models.llama.Llama`."""

    def __init__(self, cfg: LlamaConfig, pipe: PipeAxis, params: dict,
                 tp: Optional[TensorAxis] = None, seq: Optional[SeqAxis] = None):
        super().__init__()
        self.cfg, self.pipe, self.params = cfg, pipe, params
        self.tp, self.seq = tp or TensorAxis(), seq or SeqAxis()
        self.layers = stage_layers(cfg.n_layer, pipe)

    def jax_named_parameters(self) -> list:
        """The tree's leaves under the unsplit model's names, in
        ``jax.tree.leaves`` order of those names: the flat layout."""
        named = jax_leaf_order((whole_name(".".join(path), self.layers.start), t)
                               for path, t in iter_paths(self.params))
        frozen = [name for name, t in named if not isinstance(t, nn.Parameter)]
        if frozen:
            raise TypeError(f"leaves {frozen[:3]} are not parameters; build the tree with "
                            "models.llama.as_parameters")
        return named


def make_llama_pipeline_loss(stage: LlamaStage, n_micro: int,
                             vocab_chunks: int = 0) -> Callable:
    """The trainer's ``loss_fn(batch, seed)`` of a Llama stage (JAX
    :95-190), marked ``_runs_backward`` (and ``_vocab_chunked``)."""
    cfg, params = stage.cfg, stage.params

    def head_loss(h, tokens):
        if vocab_chunks > 0:
            return chunked_clm_loss_and_metrics(h, params["lm_head"], tokens, vocab_chunks,
                                                emb_layout="dv")
        return clm_loss_and_metrics(matmul_f32(h, params["lm_head"].to(h.dtype)), tokens)

    def head_partials(h, labels, mask):
        return masked_local_nll(h, params["lm_head"], labels, mask, vocab_chunks,
                                emb_layout="dv")

    def loss_fn(batch, seed):
        del seed   # Llama has no dropout
        if isinstance(batch, dict):
            raise NotImplementedError("the pipelined Llama loss takes token batches")
        T = batch.shape[1]
        if stage.seq.size == 1 and T > cfg.n_ctx:
            raise ValueError(f"sequence length {T} exceeds n_ctx {cfg.n_ctx}")
        cos, sin = rope_angles(T, cfg.head_dim, cfg.rope_theta, batch.device,
                               offset=stage.seq.rank * T)

        def run_blocks(x):
            for p in params["blocks"]:
                x = remat(_block, cfg, x, p, cfg, cos, sin, stage.tp, stage.seq)
            return x

        return stage_loss(batch, pipe=stage.pipe, seq=stage.seq, n_micro=n_micro,
                          embed=lambda t: lora_embed(params["wte"], t, cfg.compute_dtype),
                          run_blocks=run_blocks,
                          final=lambda a: rms_norm(a, params["ln_f"], cfg.rms_eps),
                          head_loss=head_loss, head_partials=head_partials,
                          width=cfg.d_model, dtype=cfg.compute_dtype)

    loss_fn._runs_backward = True
    if vocab_chunks > 0:
        loss_fn._vocab_chunked = True
    return loss_fn
