"""Megatron-style tensor parallelism: port of ``distributed_lion_tpu/parallel/tensor_parallel.py``.

Attention's qkv and the MLP's up-projections are column-parallel (split on
their output dim), attention's proj and the MLP's down-projection
row-parallel (split on their input dim), and the partial products of a
row-parallel layer are summed over the tensor group inside the model
(``models/gpt2.py``, ``models/llama.py``). Layer norms, positions, biases
added after a reduction, and the embeddings and head (unless
``vocab_parallel``) stay replicated. The optimizer does not know: each data
group's vote runs on its own tensor shard, so a rank's flat buffer holds its
own coordinates (``optim.lion.FlatParams``), as each JAX rank's ballot
covers its local shards.

A shard rule says which dim of which leaf is split over the tensor axis: an
``int``, or None for a replicated leaf (:func:`gpt2_shard_dim`,
:func:`llama_shard_dim`, by the leaf's dotted or ``/``-joined path: the JAX
package's ``PartitionSpec`` trees ``gpt2_param_specs`` and
``llama_param_specs``, :91-149, leaf by leaf). Rank ``t`` holds
the ``t``-th of ``tp`` equal slices (:func:`shard`), and :func:`gather`
reassembles a leaf from the slices of every rank.

:func:`copy_to_tp_region` is Megatron's *f* (identity forward, ``all_reduce``
of the cotangent over the tensor group backward), put where a replicated
activation enters a column-parallel region; :func:`reduce_from_tp_region` is
*g* (``all_reduce`` forward, identity backward), the exit of a row-parallel
one. The pairing makes the TP gradients exact, as the JAX docstring says
(:22-33): the cotangent reaching a reduced output is already the one true
dL/dy on every rank, so a raw ``all_reduce`` exit, whose adjoint is another
``all_reduce``, would multiply it by tp at every crossing, and residual
paths crossing different numbers of regions would mix different powers of
tp into one leaf's gradient. Without the *f* entries the replicated leaves
upstream (layer norms, embeddings) would get per-rank partial gradients,
and per-rank momenta and votes would drift them apart.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.ops.quant import QuantizedTensor
from distributed_lion_tpu_torch.parallel import collectives
from distributed_lion_tpu_torch.parallel.mesh import TensorAxis

ShardRule = Callable[[str], Optional[int]]


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp_region(x: torch.Tensor, group) -> torch.Tensor:
    """*f*: identity forward; backward sums the cotangent over ``group``
    (None: identity both ways)."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp_region(x: torch.Tensor, group) -> torch.Tensor:
    """*g*: sums ``x`` over ``group`` forward; identity backward (None:
    identity both ways)."""
    return x if group is None else _ReduceFromTP.apply(x, group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The element-wise maximum over ``group``, outside autograd."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_min(x: torch.Tensor, group) -> torch.Tensor:
    """The element-wise minimum over ``group``, outside autograd."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


# ------------------------------------------------------------ shard rules
# (the block leaf, the dim split over the tensor axis): column-parallel
# projections on their output dim, row-parallel ones on their input dim
# (a MoE FFN's, JAX expert.py:43-65: each expert's w_in column-parallel, w_out
# row-parallel; the gate and b_out, added after the reduction, replicated)
GPT2_BLOCK_RULES = {"attn.qkv": 2, "attn.qkv_b": 1, "attn.proj": 0,
                    "mlp.fc": 1, "mlp.fc_b": 0, "mlp.proj": 0,
                    "moe.w_in": 2, "moe.b_in": 1, "moe.w_out": 1}
LLAMA_BLOCK_RULES = {"attn.wq": 1, "attn.wk": 1, "attn.wv": 1, "attn.wo": 0,
                     "mlp.w_gate": 1, "mlp.w_up": 1, "mlp.w_down": 0}


def _block_rule(rules: dict, name: str) -> Optional[int]:
    parts = name.replace("/", ".").split(".")
    if parts[0] != "blocks":
        return None
    return rules.get(".".join(parts[-2:]))


def gpt2_shard_dim(name: str, vocab_parallel: bool = False) -> Optional[int]:
    """The dim of GPT-2 leaf ``name`` (dotted or ``/``-joined) split over
    the tensor axis, None if replicated (JAX ``gpt2_param_specs``:
    ``vocab_parallel`` splits the tied ``wte``'s rows)."""
    if name == "wte":
        return 0 if vocab_parallel else None
    return _block_rule(GPT2_BLOCK_RULES, name)


def llama_shard_dim(name: str, vocab_parallel: bool = False) -> Optional[int]:
    """The dim of Llama leaf ``name`` split over the tensor axis, None if
    replicated (JAX ``llama_param_specs``: ``vocab_parallel`` splits the
    untied ``lm_head``'s vocab columns)."""
    if name == "lm_head":
        return 1 if vocab_parallel else None
    return _block_rule(LLAMA_BLOCK_RULES, name)


def spec_uses_axis(dim: Optional[int]) -> bool:
    """True if a leaf's shard rule for an axis (the tensor rule, or the
    expert rule ``parallel.expert.expert_shard_dim``) splits it over that
    axis (JAX ``spec_uses_axis`` on a ``PartitionSpec``)."""
    return dim is not None


def validate_tp(cfg, tp: int, model: str = "gpt2") -> None:
    """Refuse a model whose heads or MLP width do not divide over tp (JAX
    tensor_parallel.py:155-168, same words)."""
    if model == "gpt2":
        if cfg.n_head % tp:
            raise ValueError(f"n_head {cfg.n_head} not divisible by tensor axis {tp}")
        if (4 * cfg.d_model) % tp:
            raise ValueError(f"d_ff {4 * cfg.d_model} not divisible by tensor axis {tp}")
    else:
        if cfg.n_head % tp or cfg.n_kv_head % tp:
            raise ValueError(
                f"heads ({cfg.n_head}/{cfg.n_kv_head}kv) not divisible by tensor axis {tp}")
        if cfg.d_ff % tp:
            raise ValueError(f"d_ff {cfg.d_ff} not divisible by tensor axis {tp}")


# ------------------------------------------------------ slicing, gathering
def shard(t, dim: Optional[int], tp: int, rank: int):
    """Rank ``rank``'s slice of leaf ``t`` (a tensor or a shaped
    :class:`QuantizedTensor`, whose codes and absmax are sliced along the
    same dims: ``ops.quant.validate_quant_tp`` says where that is exact),
    contiguous; ``t`` itself where ``dim`` is None or tp is 1."""
    if dim is None or tp == 1:
        return t
    if isinstance(t, QuantizedTensor):
        if t.layout != "shaped":
            raise ValueError("a flat-layout quantized leaf cannot shard "
                             "(ops.quant.validate_quant_tp)")
        shape = list(t.shape)
        shape[dim] //= tp
        return QuantizedTensor(shard(t.codes, dim, tp, rank), shard(t.absmax, dim, tp, rank),
                               tuple(shape), t.fmt, t.block, t.layout)
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of a {tuple(t.shape)} leaf does not divide over "
                         f"tensor axis {tp}")
    return t.narrow(dim, rank * (n // tp), n // tp).contiguous()


def gather(t, dim: Optional[int], tensor: TensorAxis):
    """The whole leaf from every rank's slice ``t`` of it (a collective
    over the tensor group; every rank gets it)."""
    if dim is None or tensor.size == 1:
        return t
    if isinstance(t, QuantizedTensor):
        shape = list(t.shape)
        shape[dim] *= tensor.size
        return QuantizedTensor(gather(t.codes, dim, tensor), gather(t.absmax, dim, tensor),
                               tuple(shape), t.fmt, t.block, t.layout)
    t = t.detach().contiguous()
    out = t.new_empty((tensor.size * t.numel(),))
    collectives._all_gather(out, t.reshape(-1), group=tensor.group)
    return torch.cat([p.view(t.shape) for p in out.chunk(tensor.size)], dim)


def shard_named(named: dict, rule: ShardRule, tp: int, rank: int) -> dict:
    """Rank ``rank``'s slices of a ``{name: leaf}`` dict."""
    return {k: shard(v, rule(k), tp, rank) for k, v in named.items()}


def shard_tree(tree, rule: ShardRule, tp: int, rank: int, prefix: str = ""):
    """Rank ``rank``'s slices of a nested dict/list weight tree, each leaf
    ruled by its dotted path."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, rule, tp, rank, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, rule, tp, rank, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return shard(tree, rule(prefix[:-1]), tp, rank)


def gather_tree(tree, rule: ShardRule, tensor: TensorAxis, prefix: str = ""):
    """The whole tree from every rank's slices (collective; leaves in the
    tree's order on every rank)."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, rule, tensor, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, rule, tensor, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return gather(tree, rule(prefix[:-1]), tensor)


def full_shape(shape: tuple, dim: Optional[int], tp: int) -> tuple:
    """A leaf's whole shape from the shape of one rank's slice."""
    if dim is None:
        return tuple(shape)
    return tuple(s * tp if i == dim else s for i, s in enumerate(shape))


def gather_flat(buf: torch.Tensor, shapes: list, dims: list, tensor: TensorAxis) -> torch.Tensor:
    """A flat buffer over the whole leaves (the JAX layout, as a data-parallel
    run holds it) from every rank's flat buffer ``buf`` over its slices of
    leaves of local ``shapes`` split on ``dims``: one all-gather over the
    tensor group."""
    if tensor.size == 1:
        return buf
    stacked = buf.new_empty((tensor.size * buf.numel(),))
    collectives._all_gather(stacked, buf.contiguous(), group=tensor.group)
    rows = stacked.view(tensor.size, buf.numel())
    out, off = [], 0
    for shape, dim in zip(shapes, dims):
        n = 1
        for s in shape:
            n *= s
        if dim is None:
            out.append(rows[0, off:off + n])
        else:
            out.append(torch.cat([rows[t, off:off + n].view(shape)
                                  for t in range(tensor.size)], dim).reshape(-1))
        off += n
    return torch.cat(out)


def shard_flat(full: torch.Tensor, shapes: list, dims: list, tp: int, rank: int) -> torch.Tensor:
    """The inverse of :func:`gather_flat` on one rank: its flat buffer from
    the whole-leaf flat buffer ``full`` (``shapes`` are the local ones)."""
    if tp == 1:
        return full
    out, off = [], 0
    for shape, dim in zip(shapes, dims):
        whole = full_shape(shape, dim, tp)
        n = 1
        for s in whole:
            n *= s
        out.append(shard(full[off:off + n].view(whole), dim, tp, rank).reshape(-1))
        off += n
    if off != full.numel():
        raise ValueError(f"a flat buffer of {full.numel()} whole-leaf coordinates, expected {off}")
    return torch.cat(out)
