"""GPT-2-class decoder as an ``nn.Module``: port of ``distributed_lion_tpu/models/gpt2.py``.

Pre-LN residual blocks, learned positions, tanh-GELU MLP, head tied to
``wte``; with ``moe_experts`` > 0 every ``moe_every``-th block's MLP is a
Switch-MoE FFN (``parallel/expert.py``, JAX gpt2.py:62-81, 143-183, 334-376). Parameter names keep the
JAX pytree paths (``wte``, ``blocks.0.attn.qkv``, …) and the JAX layouts
(``qkv`` is ``[d, 3, d]``), so weights carry over one to one
(``utils.serialization.params_from_jax``).

Rounding follows the JAX package: float32 layer norm, compute-dtype
matmuls accumulated in float32 and rounded to the compute dtype, the tanh
GELU. The attention scores and the tied-head logits are compute-dtype
products with a float32 result (``ops.products.matmul_f32``), never rounded
to the compute dtype before their float32 softmax. Dropout masks come from
``torch.Generator``s seeded per call site from an integer ``dropout_seed``,
so a rematerialized block (``torch.utils.checkpoint``) draws the same mask
again.

Under a tensor axis (``tp``, a ``parallel.mesh.TensorAxis`` of size > 1,
JAX gpt2.py:230-302, 378-396) each rank holds its slices of the leaves
``parallel.tensor_parallel.gpt2_shard_dim`` splits, cut from the same seeded
init as the unsplit model: ``qkv [d, 3, d/tp]``, ``qkv_b [3, d/tp]`` and
``proj [d/tp, d]`` run ``n_head/tp`` heads through the same attention
dispatch, ``fc [d, 4d/tp]``, ``fc_b [4d/tp]`` and ``proj [4d/tp, d]`` the MLP,
each region entered through *f* (``copy_to_tp_region``) and left through *g*
(``reduce_from_tp_region``), the replicated ``proj_b`` added after the
reduction. With ``vocab_parallel`` (``--tp_vocab``) ``wte`` is split by rows:
:func:`vocab_parallel_embed` looks up the rank's rows and sums the partial
embeddings, and the loss takes the rank's rows as its head
(``ops.xent.tp_vocab_clm_loss_and_metrics``). The residual and embedding
dropout seeds fold the step and the data rank only, so a replicated
activation gets one mask on every tensor rank; the attention-probability
masks, one per head, also fold the tensor rank.

Under a seq axis (``seq``, a ``parallel.mesh.SeqAxis`` of size > 1, JAX
gpt2.py:230-275, 428-440) the tokens are this rank's chunk: positions start
at ``s·T``, every attention (eval's too) is ``cfg.seq_impl``'s
(``parallel.ring_attention``: ring or Ulysses) whatever ``attn_impl`` says,
attention-probability dropout is skipped (the scores never exist in one
place), and the dropout seed folds the seq index.

Under an expert axis (``expert``, a ``parallel.mesh.ExpertAxis`` of size >
1, JAX gpt2.py:334-376, 530-560) each rank holds its ``E/ep`` experts of
every MoE block (``parallel.expert.expert_shard_dim``, cut from the unsplit
model's init like the tensor slices; under both axes each expert's FFN is
also split over tensor), the tokens of its own batch rows reach their
experts over the expert group, and the rest of the model is replicated. An
MoE block's FFN runs over the ``[B·T, d]`` tokens, capacity from that local
count; :meth:`GPT2.hidden` and :meth:`GPT2.forward` return the blocks'
summed aux loss with ``return_aux`` and the stacked ``[n_moe, E+1]`` tallies
with ``return_tallies``; ``moe_balance`` feeds each MoE block its row of a
fed load tally and ``moe_balance_axis`` sums the tallies over that axis in
the forward (``parallel.expert.moe_ffn``).

**Decoding** (JAX gpt2.py:566-714): :func:`gpt2_decode` runs the next S
tokens of a batch over a weight tree in the JAX package's layout (the
module's leaves through ``utils.serialization.tree_from_state_dict``, a
``model.npz``, an HF import; dense, NF4 or LoRA leaves through
``models.lora``) against a static per-layer KV cache (:func:`gpt2_init_cache`,
``[B, H, max_len, hd]`` in the compute dtype) written in place at a
position index. Attention is over materialized scores (a float32-result
product, the mask, a float32 softmax), as the JAX package's
``_decode_attention`` computes it outside any Pallas kernel. ``offset``
(``[B]``, a left-padded batch's pad widths) masks each row's pad slots out
of attention and of MoE routing and shifts its position ids, so each row
decodes as its solo run. MoE blocks decode with no drop (capacity ``B·S``).

``remat_policy`` says what a rematerialized block keeps (JAX
gpt2.py:321-331): ``full`` nothing (``torch.utils.checkpoint`` of the whole
block), ``dots`` the outputs of the products without batch dims (JAX's
``dots_with_no_batch_dims_saveable``; here selective checkpointing that
saves ``aten.mm`` and ``aten.addmm`` and recomputes everything else:
``bmm``, the elementwise work, the flash kernels' calls and the NF4
dequantization). :func:`remat` runs a block under either.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from distributed_lion_tpu_torch.ops.attention import attention
from distributed_lion_tpu_torch.ops.products import matmul_f32
from distributed_lion_tpu_torch.ops.quant import maybe_dequant
from distributed_lion_tpu_torch.parallel.expert import expert_shard_dim, moe_ffn, moe_init
from distributed_lion_tpu_torch.parallel.mesh import (
    ExpertAxis,
    SeqAxis,
    TensorAxis,
    resolve_device,
)
from distributed_lion_tpu_torch.parallel.ring_attention import seq_attention
from distributed_lion_tpu_torch.parallel.tensor_parallel import (
    copy_to_tp_region,
    gpt2_shard_dim,
    reduce_from_tp_region,
    shard,
)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    n_ctx: int = 1024
    dropout: float = 0.0
    attn_impl: str = "auto"   # ops.attention: auto | xla | flash | splash
    seq_impl: str = "ring"    # under a seq axis: ring | ulysses (n_head % sp == 0)
    remat: bool = True        # recompute each block in backward
    remat_policy: str = "full"  # what a remat block keeps: full (nothing) | dots
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    vocab_pad_multiple: int = 0  # > 0: round the embedding rows up to a
    # multiple (zero rows); logits are sliced back to vocab_size
    moe_experts: int = 0  # > 0: a Switch-MoE FFN in every moe_every-th block
    moe_every: int = 2    # MoE in the blocks i with i % moe_every == moe_every - 1
    moe_capacity_factor: float = 1.25

    def __post_init__(self):
        if self.moe_experts > 0 and self.moe_every < 1:
            raise ValueError(
                f"moe_every must be >= 1 when moe_experts is set, got {self.moe_every}")
        if self.vocab_pad_multiple < 0:
            raise ValueError(
                f"vocab_pad_multiple must be >= 0, got {self.vocab_pad_multiple}")
        check_remat_policy(self.remat_policy)

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_head == 0
        return self.d_model // self.n_head

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return self.vocab_size if m <= 0 else -(-self.vocab_size // m) * m

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        """A test-sized config."""
        return GPT2Config(**(dict(vocab_size=256, n_layer=2, n_head=4,
                                  d_model=64, n_ctx=128) | kw))

    @staticmethod
    def small(**kw) -> "GPT2Config":
        """The reduced evidence-scale preset (~12.7M params at a 16k vocab)."""
        return GPT2Config(**(dict(vocab_size=16384, n_layer=6, n_head=5,
                                  d_model=320, n_ctx=256) | kw))

    @staticmethod
    def gpt2_124m(**kw) -> "GPT2Config":
        return GPT2Config(**kw)


def is_moe_block(cfg: GPT2Config, i: int) -> bool:
    return cfg.moe_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1


def n_moe_blocks(cfg: GPT2Config) -> int:
    return sum(is_moe_block(cfg, i) for i in range(cfg.n_layer))


REMAT_POLICIES = ("full", "dots")
# the products without batch dims: what the dots policy keeps
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_remat_policy(name: str) -> None:
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r} (full | dots)")


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, cfg, *args):
    """``fn(*args)``, rematerialized in the backward when ``cfg.remat`` and
    grad is on, keeping what ``cfg.remat_policy`` names (module doc)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    if cfg.remat_policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)


def pad_wte(wte: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """Append the zero alignment rows of ``cfg.vocab_pad_multiple``."""
    extra = cfg.padded_vocab - wte.shape[0]
    if extra <= 0:
        return wte
    return torch.cat([wte, wte.new_zeros(extra, wte.shape[1])])


def fold_seed(*xs: int) -> int:
    """A 63-bit seed from integers (splitmix64 chain): the port's
    ``fold_in``. Deterministic across processes and devices."""
    h = 0x9E3779B97F4A7C15
    for x in xs:
        h = (h ^ (x & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return h >> 1


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    if rate == 0.0 or seed is None:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _layer_norm(x: torch.Tensor, ln, eps: float = 1e-5) -> torch.Tensor:
    """In float32, cast back to x's dtype; ``ln`` a :class:`LayerNorm` or a
    tree's ``{"scale", "bias"}``."""
    scale, bias = (ln["scale"], ln["bias"]) if isinstance(ln, dict) else (ln.scale, ln.bias)
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def _param(shape, dtype, device, std=None, gen=None) -> nn.Parameter:
    if std is None:
        t = torch.zeros(shape, dtype=torch.float32)
    else:
        t = torch.randn(shape, generator=gen, dtype=torch.float32) * std
    return nn.Parameter(t.to(dtype=dtype, device=device))


class LayerNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


class Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, device, gen, tp: TensorAxis = TensorAxis(),
                 seq: SeqAxis = SeqAxis()):
        super().__init__()
        self.tp, self.seq = tp, seq
        d, dt = cfg.d_model, cfg.param_dtype
        resid_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        # [d, 3, d]: q/k/v stacked on axis 1, the JAX package's layout
        self.qkv = _param((d, 3, d), dt, device, 0.02, gen)
        self.qkv_b = _param((3, d), dt, device)
        self.proj = _param((d, d), dt, device, resid_std, gen)
        self.proj_b = _param((d,), dt, device)

    def forward(self, x, cfg: GPT2Config, seed: Optional[int]):
        B, T, D = x.shape
        tp = self.tp
        H, hd, Dl = cfg.n_head // tp.size, cfg.head_dim, D // tp.size
        dt = x.dtype
        x = copy_to_tp_region(x, tp.group)
        qkv = (x @ self.qkv.to(dt).reshape(D, 3 * Dl)).view(B, T, 3, Dl)
        qkv = qkv + self.qkv_b.to(dt)
        q, k, v = (qkv[:, :, i].reshape(B, T, H, hd).transpose(1, 2)
                   for i in range(3))
        if self.seq.size > 1:
            # the scores never exist in one place: no attention-prob dropout
            out = seq_attention(q, k, v, self.seq, cfg.seq_impl)
        elif cfg.dropout > 0.0 and seed is not None:
            # attention-prob dropout needs materialized scores, so training
            # with dropout always takes this branch (gpt2.py:253-265); eval
            # and dropout-0 training take ops.attention (flash on the card
            # at GPT-2's shape)
            scores = matmul_f32(q, k.transpose(-1, -2)) / math.sqrt(hd)
            causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~causal, -1e30)
            probs = torch.softmax(scores, dim=-1).to(dt)
            probs = _dropout(probs, cfg.dropout, fold_seed(seed, 0) if tp.size == 1
                             else fold_seed(seed, 0, tp.rank))
            out = torch.matmul(probs, v).to(dt)
        else:
            out = attention(q, k, v, causal=True, impl=cfg.attn_impl)
        out = out.transpose(1, 2).reshape(B, T, H * hd)
        return reduce_from_tp_region(out @ self.proj.to(dt), tp.group) + self.proj_b.to(dt)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device, gen, tp: TensorAxis = TensorAxis()):
        super().__init__()
        self.tp = tp
        d, dt = cfg.d_model, cfg.param_dtype
        resid_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        self.fc = _param((d, 4 * d), dt, device, 0.02, gen)
        self.fc_b = _param((4 * d,), dt, device)
        self.proj = _param((4 * d, d), dt, device, resid_std, gen)
        self.proj_b = _param((d,), dt, device)

    def forward(self, x):
        dt = x.dtype
        x = copy_to_tp_region(x, self.tp.group)
        h = F.gelu(x @ self.fc.to(dt) + self.fc_b.to(dt), approximate="tanh")
        return reduce_from_tp_region(h @ self.proj.to(dt), self.tp.group) + self.proj_b.to(dt)


class MoE(nn.Module):
    """A Switch-MoE FFN's leaves (``parallel.expert.moe_init``): the gate
    ``[d, E]`` and the experts' ``w_in [E, d, 4d]``, ``b_in [E, 4d]``,
    ``w_out [E, 4d, d]``, ``b_out [E, d]``."""

    def __init__(self, cfg: GPT2Config, device, gen):
        super().__init__()
        d = cfg.d_model
        for k, t in moe_init(cfg.moe_experts, d, 4 * d, cfg.param_dtype, gen).items():
            setattr(self, k, nn.Parameter(t.to(device)))


class MoEBlock(nn.Module):
    """A pre-LN block whose FFN is the MoE layer (JAX ``_moe_block``): the
    attention half is :class:`Block`'s, the FFN :func:`moe_ffn` over the
    ``[B·T, d]`` tokens."""

    def __init__(self, cfg: GPT2Config, device, gen, tp: TensorAxis = TensorAxis(),
                 expert: ExpertAxis = ExpertAxis()):
        super().__init__()
        d = cfg.d_model
        self.tp, self.expert = tp, expert
        self.ln_1 = LayerNorm(d, cfg.param_dtype, device)
        self.attn = Attention(cfg, device, gen, tp)
        self.ln_2 = LayerNorm(d, cfg.param_dtype, device)
        self.moe = MoE(cfg, device, gen)

    def forward(self, x, cfg: GPT2Config, seed: Optional[int], balance=None,
                balance_axis=None, return_tallies: bool = False):
        s = (None, None, None) if seed is None else tuple(fold_seed(seed, i) for i in (1, 2, 3))
        x = x + _dropout(self.attn(_layer_norm(x, self.ln_1), cfg, s[0]), cfg.dropout, s[1])
        B, T, D = x.shape
        h = _layer_norm(x, self.ln_2).reshape(B * T, D)
        out = moe_ffn(dict(self.moe.named_parameters()), h,
                      capacity_factor=cfg.moe_capacity_factor,
                      expert=self.expert if self.expert.size > 1 else None,
                      tp=self.tp if self.tp.size > 1 else None, balance_tokens=balance,
                      balance_axis=balance_axis, return_tallies=return_tallies)
        y, aux = out[0], out[1]
        x = x + _dropout(y.reshape(B, T, D), cfg.dropout, s[2])
        return x, aux, (out[2] if return_tallies else None)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device, gen, tp: TensorAxis = TensorAxis(),
                 seq: SeqAxis = SeqAxis()):
        super().__init__()
        d = cfg.d_model
        self.ln_1 = LayerNorm(d, cfg.param_dtype, device)
        self.attn = Attention(cfg, device, gen, tp, seq)
        self.ln_2 = LayerNorm(d, cfg.param_dtype, device)
        self.mlp = MLP(cfg, device, gen, tp)

    def forward(self, x, cfg: GPT2Config, seed: Optional[int]):
        s = (None, None, None) if seed is None else tuple(fold_seed(seed, i) for i in (1, 2, 3))
        x = x + _dropout(self.attn(_layer_norm(x, self.ln_1), cfg, s[0]),
                         cfg.dropout, s[1])
        return x + _dropout(self.mlp(_layer_norm(x, self.ln_2)), cfg.dropout, s[2])


class GPT2(nn.Module):
    """The model; ``forward(tokens, dropout_seed)`` returns float32 logits
    ``[B, T, vocab_size]``. ``dropout_seed=None`` disables dropout (eval).
    ``tp`` (size > 1) holds this rank's slices (module doc); a
    ``vocab_parallel`` model holds a slice of the head, so its :meth:`head`
    (and :meth:`forward`) raise: its loss runs over :meth:`hidden` and
    ``wte``. ``seq`` (size > 1): the tokens are this rank's chunk (module
    doc). ``expert`` (size > 1): this rank's experts of the MoE blocks."""

    def __init__(self, cfg: GPT2Config, *, device="cuda", seed: int = 0,
                 tp: Optional[TensorAxis] = None, vocab_parallel: bool = False,
                 seq: Optional[SeqAxis] = None, expert: Optional[ExpertAxis] = None):
        super().__init__()
        device = resolve_device(device)
        tp = tp or TensorAxis()
        self.seq = seq or SeqAxis()
        self.expert = expert or ExpertAxis()
        if vocab_parallel and tp.size == 1:
            raise ValueError("vocab_parallel needs a tensor axis of size > 1")
        gen = torch.Generator().manual_seed(seed)  # CPU draws: same weights on any device
        self.cfg, self.tp, self.vocab_parallel = cfg, tp, vocab_parallel
        d, dt = cfg.d_model, cfg.param_dtype
        # drawn whole on the CPU in the unsplit model's order, then sliced
        cpu = torch.device("cpu")
        self.wte = nn.Parameter(pad_wte(_param((cfg.vocab_size, d), dt, cpu, 0.02, gen).data,
                                        cfg))
        self.wpe = _param((cfg.n_ctx, d), dt, cpu, 0.02, gen)
        self.ln_f = LayerNorm(d, dt, cpu)
        self.blocks = nn.ModuleList(
            MoEBlock(cfg, cpu, gen, tp, self.expert) if is_moe_block(cfg, i)
            else Block(cfg, cpu, gen, tp, self.seq) for i in range(cfg.n_layer))
        ep = self.expert
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.data = shard(shard(p.data, self.shard_dim(name), tp.size, tp.rank),
                               self.expert_dim(name), ep.size, ep.rank).to(device)

    def shard_dim(self, name: str) -> Optional[int]:
        """The dim of parameter ``name`` split over the tensor axis, or None."""
        return gpt2_shard_dim(name, self.vocab_parallel) if self.tp.size > 1 else None

    def expert_dim(self, name: str) -> Optional[int]:
        """The dim of parameter ``name`` split over the expert axis, or None."""
        return expert_shard_dim(name) if self.expert.size > 1 else None

    def hidden(self, tokens: torch.Tensor, dropout_seed: Optional[int] = None, *,
               moe_balance: Optional[torch.Tensor] = None,
               moe_balance_axis: Optional[ExpertAxis] = None, return_aux: bool = False,
               return_tallies: bool = False):
        """Backbone: tokens [B, T] → final hidden [B, T, d] after ln_f; with
        ``return_aux`` also the MoE blocks' summed aux loss, with
        ``return_tallies`` also their stacked ``[n_moe, E+1]`` tallies
        (``(hidden, aux, tallies)``)."""
        cfg = self.cfg
        T = tokens.shape[1]
        start = self.seq.rank * T   # this chunk's first position
        if self.seq.size == 1 and T > cfg.n_ctx:
            raise ValueError(f"sequence length {T} exceeds n_ctx {cfg.n_ctx}")
        if self.seq.size > 1 and dropout_seed is not None:
            dropout_seed = fold_seed(dropout_seed, self.seq.rank)
        cd = cfg.compute_dtype
        if self.vocab_parallel:
            x = vocab_parallel_embed(self.wte, tokens, self.tp, cd)
        else:
            x = F.embedding(tokens, self.wte).to(cd)
        x = x + self.wpe[start:start + T].to(cd)
        x = _dropout(x, cfg.dropout,
                     None if dropout_seed is None else fold_seed(dropout_seed, cfg.n_layer))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        tallies = []
        for i, block in enumerate(self.blocks):
            seed = None if dropout_seed is None else fold_seed(dropout_seed, i)
            if isinstance(block, MoEBlock):
                bt = None if moe_balance is None else moe_balance[len(tallies)]
                x, a, tally = remat(block, cfg, x, cfg, seed, bt, moe_balance_axis,
                                    return_tallies)
                aux = aux + a
                tallies.append(tally)
            else:
                x = remat(block, cfg, x, cfg, seed)
        x = _layer_norm(x, self.ln_f)
        if not (return_aux or return_tallies):
            return x
        out = (x, aux)
        if return_tallies:
            out += (torch.stack(tallies) if tallies
                    else torch.zeros(0, 1, dtype=torch.float32, device=x.device),)
        return out

    def forward(self, tokens: torch.Tensor, dropout_seed: Optional[int] = None, **moe):
        """Float32 logits ``[B, T, vocab_size]``; with :meth:`hidden`'s MoE
        options the logits in the hidden state's place of its tuple."""
        out = self.hidden(tokens, dropout_seed, **moe)
        if isinstance(out, tuple):
            return (self.head(out[0]), *out[1:])
        return self.head(out)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Tied head: hidden [B, T, d] → float32 logits [B, T, vocab_size]."""
        if self.vocab_parallel:
            raise NotImplementedError(
                "a vocab-parallel GPT-2 holds a slice of the head: its loss is "
                "ops.xent.tp_vocab_clm_loss_and_metrics over hidden() and wte")
        logits = matmul_f32(x, self.wte.to(x.dtype).t())
        return logits[..., : self.cfg.vocab_size]

    def jax_named_parameters(self) -> list[tuple[str, nn.Parameter]]:
        """Named parameters in ``jax.tree.leaves`` order of the JAX pytree:
        the flat layout."""
        return jax_leaf_order(self.named_parameters())


def vocab_parallel_embed(wte_shard: torch.Tensor, tokens: torch.Tensor, tp: TensorAxis,
                         out_dtype=None) -> torch.Tensor:
    """Megatron's VocabParallelEmbedding (JAX gpt2.py:378-396): ``wte_shard``
    ``[V/tp, d]`` is the rank's contiguous rows; a token outside them
    contributes zero and the partial embeddings are summed over the tensor
    group (*g*). ``out_dtype`` casts before the sum: one rank contributes a
    nonzero row per token, so the sum is exact in the narrower dtype at half
    the bytes."""
    vshard = wte_shard.shape[0]
    start = tp.rank * vshard
    in_range = (tokens >= start) & (tokens < start + vshard)
    idx = torch.clamp(tokens - start, 0, vshard - 1)
    part = F.embedding(idx, wte_shard) * in_range[..., None].to(wte_shard.dtype)
    if out_dtype is not None:
        part = part.to(out_dtype)
    return reduce_from_tp_region(part, tp.group)


def jax_leaf_order(named) -> list:
    """``(dotted name, value)`` pairs sorted as ``jax.tree.leaves`` orders
    the leaves of the nested tree the names spell: dict keys sorted, list
    entries (the numeric parts) by index."""
    def key(name):
        return [(0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split(".")]

    return sorted(named, key=lambda kv: key(kv[0]))


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# ------------------------------------------------------------------ decoding
def gpt2_init_cache(cfg: GPT2Config, batch: int, max_len: int, device=None) -> list:
    """Per-layer KV cache ``[B, H, max_len, hd]`` in the compute dtype (JAX
    ``gpt2_init_cache``): static, written at a position index."""
    shape = (batch, cfg.n_head, max_len, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
            for _ in range(cfg.n_layer)]


def decode_mask(t: int, pos: int, s: int, offset: Optional[torch.Tensor],
                device) -> torch.Tensor:
    """Which of ``t`` cache slots each of ``s`` new tokens at ``pos`` attends
    (``[S, T]``, or ``[B, 1, S, T]`` with ``offset``): causal over the
    written slots, and with ``offset`` no slot below a row's pad width."""
    slots = torch.arange(t, device=device)
    valid = slots[None, :] <= (pos + torch.arange(s, device=device))[:, None]
    if offset is None:
        return valid
    return (valid[None] & (slots[None, None, :] >= offset[:, None, None]))[:, None]


def _qkv_project(x: torch.Tensor, w) -> torch.Tensor:
    """``[B, S, d]`` times the stacked ``[d, 3, d]`` qkv (JAX ``_qkv_project``),
    dense, quantized or LoRA-adapted, as ``[B, S, 3d]``."""
    from distributed_lion_tpu_torch.models.lora import LoraTensor

    d, dt = x.shape[-1], x.dtype
    if isinstance(w, LoraTensor):
        base = x @ maybe_dequant(w.base, dt).to(dt).reshape(d, -1)
        delta = (x @ w.A.to(dt)) @ w.B.to(dt).reshape(w.B.shape[0], -1)
        return base + w.scaling * delta
    return x @ maybe_dequant(w, dt).to(dt).reshape(d, -1)


def _decode_attention(x, p, cfg: GPT2Config, c: dict, pos: int, offset=None):
    """Attention of S new tokens at cache slots ``[pos, pos+S)`` (JAX
    :579-607): project q, k, v, write k and v into the cache in place,
    attend q over the masked cache."""
    from distributed_lion_tpu_torch.models.lora import lora_matmul   # lora imports this module

    B, S, D = x.shape
    H, hd, dt = cfg.n_head, cfg.head_dim, x.dtype
    qkv = _qkv_project(x, p["qkv"]).view(B, S, 3, D) + p["qkv_b"].to(dt)
    q, k, v = (qkv[:, :, i].reshape(B, S, H, hd).transpose(1, 2) for i in range(3))
    c["k"][:, :, pos:pos + S] = k.to(c["k"].dtype)
    c["v"][:, :, pos:pos + S] = v.to(c["v"].dtype)
    scores = matmul_f32(q, c["k"].to(dt).transpose(-1, -2)) / math.sqrt(hd)
    scores = scores.masked_fill(~decode_mask(c["k"].shape[2], pos, S, offset, x.device), -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = matmul_f32(probs, c["v"].to(dt)).to(dt).transpose(1, 2).reshape(B, S, H * hd)
    return lora_matmul(out, p["proj"]) + p["proj_b"].to(dt)


def _decode_mlp(x, p, cfg: GPT2Config, valid=None):
    """The block's second half (JAX :610-656): the dense MLP, or the MoE FFN
    with no drop (capacity ``B·S``) and ``valid`` ``[B, S]`` masking dead
    lanes out of routing."""
    from distributed_lion_tpu_torch.models.lora import lora_matmul

    h = _layer_norm(x, p["ln_2"])
    dt = x.dtype
    if "moe" in p:
        B, S, D = x.shape
        y, _ = moe_ffn(p["moe"], h.reshape(B * S, D), capacity_factor=cfg.moe_capacity_factor,
                       capacity_override=B * S,
                       valid=None if valid is None else valid.reshape(B * S))
        return x + y.reshape(B, S, D)
    m = p["mlp"]
    h = F.gelu(lora_matmul(h, m["fc"]) + m["fc_b"].to(dt), approximate="tanh")
    return x + lora_matmul(h, m["proj"]) + m["proj_b"].to(dt)


def _decode_embed(params, tokens, cfg: GPT2Config, pos: int, offset=None):
    """Token and position embeddings of a decode chunk (JAX :658-676): the
    slots' positions, or with ``offset`` each row's shifted positions
    (clamped at 0: a pad slot is masked out of attention anyway), both
    through ``lora_embed``/``maybe_dequant``."""
    from distributed_lion_tpu_torch.models.lora import lora_embed

    cd = cfg.compute_dtype
    S = tokens.shape[1]
    x = lora_embed(params["wte"], tokens, cd)
    if offset is None:
        return x + maybe_dequant(params["wpe"], cd)[pos:pos + S].to(cd)
    ids = pos + torch.arange(S, device=tokens.device)[None, :] - offset[:, None]
    return x + lora_embed(params["wpe"], torch.clamp(ids, 0, cfg.n_ctx - 1), cd)


def _tied_logits(x, params, cfg: GPT2Config):
    """Float32 logits ``[B, S, vocab_size]`` of the tied head."""
    logits = matmul_f32(x, maybe_dequant(params["wte"], x.dtype).to(x.dtype).t())
    return logits[..., :cfg.vocab_size]


@torch.no_grad()
def gpt2_decode(params: dict, tokens: torch.Tensor, cfg: GPT2Config, cache: list, pos: int,
                offset: Optional[torch.Tensor] = None):
    """The next S tokens ``[B, S]`` at cache slots ``[pos, pos+S)`` (JAX
    :687-714): returns ``(float32 logits [B, S, vocab_size], cache)``, the
    cache written in place. ``pos`` 0 with the prompt is the prefill,
    single tokens the decode loop; position for position the logits are
    :meth:`GPT2.forward`'s. ``offset`` ``[B]``: each row's left-pad width."""
    valid = None
    if offset is not None:
        # lane (b, s) sits at slot pos + s: below the row's pad width it is dead
        valid = (pos + torch.arange(tokens.shape[1], device=tokens.device))[None, :] \
            >= offset[:, None]
    x = _decode_embed(params, tokens, cfg, pos, offset)
    for p, c in zip(params["blocks"], cache):
        x = x + _decode_attention(_layer_norm(x, p["ln_1"]), p["attn"], cfg, c, pos, offset)
        x = _decode_mlp(x, p, cfg, valid)
    return _tied_logits(_layer_norm(x, params["ln_f"]), params, cfg), cache
