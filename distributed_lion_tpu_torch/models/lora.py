"""LoRA adapters over frozen (optionally quantized) base weights: port of ``distributed_lion_tpu/models/lora.py``.

The reference applies PEFT LoRA to Llama-2's q/v projections with r 8,
α 16 and dropout 0.05, and merges the adapters into the base on save.
Adapters live in a dict of their own keyed by the adapted leaf's
``'/'``-joined path, each ``{"A": [d_in, r], "B": [r, *out_dims]}``. An
adapted leaf is swapped for a :class:`LoraTensor` and every projection of
the model goes through :func:`lora_matmul`, which computes the factored
form ``x @ W + (α/r)·(x @ A) @ B`` (``W + ΔW`` is never formed). Only the
adapters train; the base takes no gradient.

Adapter dropout follows PEFT: inverted dropout on the input of the A
product only, scale 1/(1−p); the base path is never dropped. The JAX
package draws each site's mask from a key split over the sorted adapter
paths; here site ``i`` of the sorted paths draws from a ``torch.Generator``
seeded ``fold_seed(seed, i)``, so a rematerialized block draws the same mask
again. The two frameworks' masks differ; their statistics agree.

:data:`DPO_TARGET_PATTERNS` is the reference's wider DPO target set, and
:func:`lora_apply_fn` wraps a model over a closed-over frozen base into a
function of the adapters (the DPO policy).

Under tensor parallelism (JAX lora.py:214-286) the base holds this rank's
slices and the adapters shard with their targets
(:func:`lora_adapter_specs`): ``A`` takes the base's dim-0 split, ``B`` its
output-dim split. The factor that is replicated while its partner is split
(``A`` of a column-parallel target, ``B`` of a row-parallel one) enters
through *f* (``copy_to_tp_region``, :func:`apply_adapters`): its backward
carries only the local slice's share, which the tensor group sums. A target
split nowhere computes the whole gradient on every rank and is not wrapped.
:func:`lora_init` cuts each rank's slices from the unsplit draws.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Optional, Sequence

import torch

from distributed_lion_tpu_torch.models.gpt2 import fold_seed
from distributed_lion_tpu_torch.ops.quant import QuantizedTensor, maybe_dequant
from distributed_lion_tpu_torch.parallel.mesh import TensorAxis
from distributed_lion_tpu_torch.parallel.tensor_parallel import copy_to_tp_region, shard


@dataclasses.dataclass
class LoraTensor:
    """A frozen base weight (dense or :class:`QuantizedTensor`) with its
    low-rank adapter, consumed by :func:`lora_matmul` in factored form.
    ``dropout_seed`` (set by :func:`apply_adapters` in training) arms
    ``dropout_rate`` on the adapter branch; None is eval."""

    base: Any
    A: torch.Tensor
    B: torch.Tensor
    scaling: float
    dropout_rate: float = 0.0
    dropout_seed: Optional[int] = None


def _branch_dropout(x: torch.Tensor, w: LoraTensor) -> torch.Tensor:
    """Inverted dropout on the adapter-branch input; identity without a
    seed or at rate 0."""
    if w.dropout_seed is None or w.dropout_rate <= 0.0:
        return x
    keep = 1.0 - w.dropout_rate
    gen = torch.Generator(device=x.device)
    gen.manual_seed(w.dropout_seed)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def lora_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a dense, quantized or LoRA-adapted 2-D weight: the one
    hook every projection of the models goes through."""
    if isinstance(w, LoraTensor):
        dt = x.dtype
        base = maybe_dequant(w.base, dt)
        delta = (_branch_dropout(x, w) @ w.A.to(dt)) @ w.B.to(dt)
        return x @ base.to(dt) + w.scaling * delta
    return x @ maybe_dequant(w, x.dtype).to(x.dtype)


def lora_embed(w, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding lookup for a dense, quantized or adapted table: for a
    LoraTensor ``base[tokens] + (α/r)·(A[tokens] @ B)``, with no dropout
    (PEFT has none on embeddings)."""
    if isinstance(w, LoraTensor):
        base = maybe_dequant(w.base, dtype)[tokens].to(dtype)
        a_rows = w.A[tokens].to(dtype)
        return base + (w.scaling * (a_rows @ w.B.to(dtype))).to(dtype)
    return maybe_dequant(w, dtype)[tokens].to(dtype)


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """r 8, α 16, targets the q/v projections; ``dropout`` applies on the
    adapter branch in training only."""

    r: int = 8
    alpha: int = 16
    dropout: float = 0.0
    target_patterns: Sequence[str] = ("wq", "wv", "q_proj", "v_proj", "qkv")

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


# the reference's DPO target set (dpo_llama2.py:192-207: q/v/k/out_proj +
# fc_in/fc_out/wte) in this repo's Llama leaf names: all four attention
# projections, the whole SwiGLU MLP and the token embedding (a gather-side
# adapter, :func:`lora_embed`). Patterns match a leaf's last path component
# whole, so "wo" does not match "w_down".
DPO_TARGET_PATTERNS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                       "wte", "q_proj", "k_proj", "v_proj", "out_proj")


def _is_weight_leaf(x) -> bool:
    return isinstance(x, QuantizedTensor) or (isinstance(x, torch.Tensor) and x.dim() in (2, 3))


def iter_paths(tree, prefix=()):
    """``(path tuple, leaf)`` of a nested dict/list tree, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def lora_init(base_params: Any, cfg: LoraConfig, *, seed: int = 0,
              dtype=torch.float32, device=None, tp: Optional[TensorAxis] = None,
              base_rule: Optional[Callable] = None) -> dict:
    """``{path: {"A", "B"}}`` for every weight leaf whose last path
    component matches a target pattern: A ~ N(0, 1/r), B = 0 (the adapter
    starts as the identity). Draws are made on the CPU from ``seed``, one
    generator per site in the tree's order. Over a base of ``tp`` slices
    (``base_rule(path) -> dim or None``) A is drawn whole and sliced."""
    tp = tp or TensorAxis()
    paths = [(path, leaf) for path, leaf in iter_paths(base_params)
             if _is_weight_leaf(leaf)
             and any(re.fullmatch(p, path[-1]) for p in cfg.target_patterns)]
    if not paths:
        raise ValueError(f"no base weights matched LoRA targets {tuple(cfg.target_patterns)}")
    adapters = {}
    for i, (path, leaf) in enumerate(paths):
        d_in, out_dims = leaf.shape[0], tuple(leaf.shape[1:])
        split_in = tp.size > 1 and base_rule("/".join(path)) == 0
        dev = device if device is not None else leaf.device
        gen = torch.Generator().manual_seed(fold_seed(seed, i))
        rows = d_in * (tp.size if split_in else 1)
        a = torch.randn(rows, cfg.r, generator=gen) / math.sqrt(cfg.r)
        if split_in:
            a = shard(a, 0, tp.size, tp.rank)
        adapters["/".join(path)] = {"A": a.to(dtype=dtype, device=dev),
                                    "B": torch.zeros((cfg.r, *out_dims), dtype=dtype, device=dev)}
    return adapters


def lora_adapter_specs(adapters: dict, base_rule: Callable) -> dict:
    """``{path: {"A": dim or None, "B": dim or None}}``, the dims of each
    adapter factor split over the tensor axis (JAX lora.py:270-286): ``A
    [d_in, r]`` inherits the base's dim-0 split, ``B [r, *out_dims]`` its
    output-dim split."""
    specs = {}
    for path in adapters:
        dim = base_rule(path)
        specs[path] = {"A": 0 if dim == 0 else None,
                       "B": dim if dim is not None and dim >= 1 else None}
    return specs


def adapter_shard_rule(specs: dict) -> Callable:
    """The shard rule of the adapters' flat names (``path/A``, ``path/B``)."""
    return lambda name: specs[name.rsplit("/", 1)[0]][name.rsplit("/", 1)[1]]


def adapter_named_parameters(adapters: dict) -> list:
    """``("path/A", A), ("path/B", B)`` over the sorted paths: the JAX
    package's leaf order of the adapter dict (``blocks/0``, ``blocks/1``,
    ``blocks/10``, …; A before B), which is the flat buffer's layout."""
    return [(f"{path}/{k}", adapters[path][k]) for path in sorted(adapters) for k in ("A", "B")]


def _tree_get(tree, path):
    node = tree
    for p in path:
        node = node[int(p)] if isinstance(node, (list, tuple)) else node[p]
    return node


def _tree_set(tree, path, value):
    node = _tree_get(tree, path[:-1])
    if isinstance(node, (list, tuple)):
        node[int(path[-1])] = value
    else:
        node[path[-1]] = value


def _copy_tree(tree):
    """The dict/list structure copied, leaves shared."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


@torch.no_grad()
def merge_lora(base_params: Any, adapters: dict, cfg: LoraConfig,
               dequant_dtype=torch.float32) -> Any:
    """``W' = W + (α/r)·A@B`` per adapted leaf (PEFT ``merge_and_unload``);
    quantized bases are dequantized first."""
    merged = _copy_tree(base_params)
    for path_str, ab in adapters.items():
        path = tuple(path_str.split("/"))
        w = maybe_dequant(_tree_get(base_params, path), dequant_dtype)
        b = ab["B"].reshape(ab["B"].shape[0], -1)
        delta = ((ab["A"] @ b) * cfg.scaling).reshape(w.shape)
        _tree_set(merged, path, w + delta.to(w.dtype))
    return merged


def apply_adapters(base_params: Any, adapters: dict, cfg: LoraConfig,
                   dropout_seed: Optional[int] = None, tp: Optional[TensorAxis] = None,
                   base_rule: Optional[Callable] = None) -> Any:
    """The base tree with each adapted leaf swapped for a :class:`LoraTensor`
    (factored form). ``dropout_seed`` (training only) arms ``cfg.dropout``
    on every adapter branch, site ``i`` of the sorted paths seeded
    ``fold_seed(dropout_seed, i)``. Under ``tp`` (size > 1, the base split by
    ``base_rule``) the replicated factor of a split target enters through
    *f* (module doc)."""
    effective = _copy_tree(base_params)
    rate = cfg.dropout if dropout_seed is not None else 0.0
    site = {p: i for i, p in enumerate(sorted(adapters))}
    group = tp.group if tp is not None and tp.size > 1 else None
    for path_str, ab in adapters.items():
        path = tuple(path_str.split("/"))
        seed = fold_seed(dropout_seed, site[path_str]) if rate > 0.0 else None
        a, b = ab["A"], ab["B"]
        if group is not None:
            dim = base_rule(path_str)
            if dim is not None and dim >= 1:   # column-parallel: A replicated
                a = copy_to_tp_region(a, group)
            elif dim == 0:                     # row-parallel: B replicated
                b = copy_to_tp_region(b, group)
        _tree_set(effective, path, LoraTensor(_tree_get(base_params, path), a, b,
                                              cfg.scaling, rate, seed))
    return effective


def lora_apply_fn(base_apply: Callable, base_params: Any, cfg: LoraConfig,
                  tp: Optional[TensorAxis] = None, base_rule: Optional[Callable] = None
                  ) -> Callable:
    """Wrap ``base_apply(params, tokens, *args, **kw)`` into ``apply(adapters,
    tokens, *args, dropout_seed=None, **kw)`` over the closed-over frozen
    ``base_params``: the adapted leaves are swapped in per call
    (:func:`apply_adapters`, with ``tp`` and ``base_rule``), so only the
    adapters take gradients."""

    def apply(adapters, tokens, *args, dropout_seed: Optional[int] = None, **kwargs):
        return base_apply(apply_adapters(base_params, adapters, cfg, dropout_seed=dropout_seed,
                                         tp=tp, base_rule=base_rule),
                          tokens, *args, **kwargs)

    return apply
