"""Flat ``.npz`` pytree files and the weight carry-over from the JAX package.

Port of ``distributed_lion_tpu/utils/serialization.py``: nested dicts and
lists flatten to ``a/b/#i/c`` keys (``#i`` is a list index), the format of
the JAX package's ``model.npz``. On top of it:

- :func:`params_from_jax` turns the JAX package's GPT-2 params (a numpy
  pytree or a ``model.npz``) into the port's state dict
  (``blocks/#0/attn/qkv`` → ``blocks.0.attn.qkv``), and
  :func:`params_to_jax` goes back; :func:`state_dict_from_tree` and
  :func:`tree_from_state_dict` do the same between tensor trees (the HF
  import and export's weight trees) and state dicts;
- :func:`momentum_from_jax` takes rank ``rank``'s row of the JAX package's
  stacked ``[world, ...]`` momentum;
- :func:`llama_params_from_jax` turns the JAX package's Llama params (a
  numpy pytree whose quantized leaves carry numpy ``codes`` and ``absmax``)
  into the port's weight tree, :class:`ops.quant.QuantizedTensor` leaves
  included, and :func:`llama_params_to_jax` writes a dense tree back (the
  tree ``run_clm --model_family llama`` saves); :func:`adapters_from_jax` does the same for LoRA adapters, and
  :func:`adapter_momentum_from_jax` takes one rank's row of the adapters'
  stacked momentum.

Under pipeline parallelism :func:`pipeline_params_from_jax` and
:func:`pipeline_momentum_from_jax` read the JAX package's pipeline layout
(``pipeline_params`` / ``llama_pipeline_params``: the blocks' leaves stacked
``[pp, L/pp, ...]`` under ``stages``; its momentum stacked ``[world, ...]``
over that) into pipeline stage ``p``'s named leaves (its blocks under the
unsplit model's names, and the replicated ones), and
:func:`pipeline_params_to_jax` writes every stage's leaves back into it.

Under expert parallelism the GPT-2 converters also take ``(ep, e)`` and
return expert rank ``e``'s experts of every MoE FFN
(``parallel.expert.expert_shard_dim``), the tensor slices of them under
both axes. Under tensor parallelism each converter takes ``(tp, t)`` and returns the
slices of tensor rank ``t`` (``parallel.tensor_parallel.shard`` by the
family's shard rule, ``vocab_parallel`` for ``--tp_vocab``; the adapters by
their base's rule): the JAX package's arrays are whole, and its stacked
momentum ``[world, ...]`` is sliced along the same dims as its leaf.

bfloat16 tensors are written as float32 (numpy has no bfloat16 without
extra packages); every value stays exact.
"""

from __future__ import annotations

import pathlib
from typing import Any, Union

import numpy as np
import torch

from distributed_lion_tpu_torch.ops.quant import QuantizedTensor, map_tree
from distributed_lion_tpu_torch.parallel.expert import expert_shard_dim
from distributed_lion_tpu_torch.parallel.pipeline import (
    stack_stage_params,
    stage_layers,
    unstack_stage_params,
)
from distributed_lion_tpu_torch.parallel.mesh import PipeAxis
from distributed_lion_tpu_torch.parallel.tensor_parallel import (
    gpt2_shard_dim,
    llama_shard_dim,
    shard,
    shard_named,
    shard_tree,
)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (f"#{i}",))
    else:
        yield "/".join(prefix), tree


def save_pytree(path, tree: Any) -> None:
    flat = {k: _to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in _flatten(tree)}
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_pytree(path) -> Any:
    """Rebuild the nested dict/list structure from flat keys."""
    with np.load(path) as data:
        root: dict = {}
        for key in data.files:
            parts = key.split("/")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return _listify(root)


def _listify(node):
    if isinstance(node, dict):
        if node and all(k.startswith("#") for k in node):
            return [_listify(node[f"#{i}"]) for i in range(len(node))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def state_dict_from_tree(tree: Any) -> dict:
    """A nested dict/list tree as a state dict of the same leaves, keyed like
    the port's modules (``blocks/#0/attn/qkv`` → ``blocks.0.attn.qkv``)."""
    return {key.replace("/#", ".").replace("/", "."): v for key, v in _flatten(tree)}


def tree_from_state_dict(state: Union[dict, torch.nn.Module]) -> Any:
    """The inverse of :func:`state_dict_from_tree`: a state dict (or a
    module's parameters) as the nested tree of the same tensors, list
    indices restored."""
    if isinstance(state, torch.nn.Module):
        state = dict(state.named_parameters())
    root: dict = {}
    for name, t in state.items():
        parts = name.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(f"#{p}" if p.isdigit() else p, {})
        node[parts[-1]] = t
    return _listify(root)


def params_from_jax(tree_or_npz: Union[dict, str, pathlib.Path], tp: int = 1, t: int = 0,
                    vocab_parallel: bool = False, ep: int = 1,
                    e: int = 0) -> dict[str, torch.Tensor]:
    """The JAX package's GPT-2 params (numpy pytree or ``model.npz`` path) as
    the port's state dict of CPU tensors: tensor rank ``t``'s slices of
    ``tp``, expert rank ``e``'s experts of ``ep``."""
    tree = (load_pytree(tree_or_npz) if isinstance(tree_or_npz, (str, pathlib.Path))
            else tree_or_npz)
    state = {k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_tree(tree).items()}
    return shard_named(shard_named(state, lambda k: gpt2_shard_dim(k, vocab_parallel), tp, t),
                       expert_shard_dim, ep, e)


def params_to_jax(state: Union[dict, torch.nn.Module]) -> dict:
    """The port's state dict (or module) as the JAX package's nested numpy
    pytree, list indices restored."""
    return map_tree(_to_numpy, tree_from_state_dict(state))


def momentum_from_jax(exp_avg: dict, rank: int, tp: int = 1, t: int = 0,
                      vocab_parallel: bool = False, family: str = "gpt2", ep: int = 1,
                      e: int = 0) -> dict:
    """Row ``rank`` of the JAX package's stacked ``[world, ...]`` momentum
    pytree, as a state dict keyed like the params: tensor rank ``t``'s
    slices of ``tp`` by ``family``'s shard rule, expert rank ``e``'s experts
    of ``ep``."""
    rule = gpt2_shard_dim if family == "gpt2" else llama_shard_dim
    return {name: shard(shard(m[rank], rule(name, vocab_parallel), tp, t),
                        expert_shard_dim(name), ep, e)
            for name, m in params_from_jax(exp_avg).items()}


def _leaf_from_jax(leaf, device) -> Any:
    """A numpy array, or a JAX ``QuantizedTensor`` (read by its fields: its
    numpy ``codes`` and ``absmax`` and its static ``shape``, ``fmt``,
    ``block`` and ``layout``), as the port's leaf."""
    if hasattr(leaf, "codes") and hasattr(leaf, "absmax"):
        return QuantizedTensor(torch.from_numpy(np.array(leaf.codes, np.uint8)).to(device),
                               torch.from_numpy(np.array(leaf.absmax, np.float32)).to(device),
                               tuple(int(d) for d in leaf.shape), leaf.fmt, int(leaf.block),
                               leaf.layout)
    return torch.from_numpy(np.array(leaf)).to(device)


def llama_params_from_jax(tree: Any, device="cpu", tp: int = 1, t: int = 0,
                          vocab_parallel: bool = False) -> Any:
    """The JAX package's Llama params (nested dicts and lists of numpy
    arrays and quantized leaves) as the port's weight tree on ``device``:
    tensor rank ``t``'s slices of ``tp``."""
    return shard_tree(map_tree(lambda leaf: _leaf_from_jax(leaf, device), tree),
                      lambda k: llama_shard_dim(k, vocab_parallel), tp, t)


def llama_params_to_jax(tree: Any) -> Any:
    """The port's dense Llama weight tree (tensors or parameters) as the
    JAX package's nested numpy tree: ``model.npz`` of ``run_clm
    --model_family llama`` through :func:`save_pytree`."""
    return map_tree(_to_numpy, tree)


def _adapter_dim(base_rule, path: str, factor: str):
    """The split dim of an adapter factor over a base split by
    ``base_rule`` (``models.lora.lora_adapter_specs``)."""
    dim = None if base_rule is None else base_rule(path)
    if factor == "A":
        return 0 if dim == 0 else None
    return dim if dim is not None and dim >= 1 else None


def adapters_from_jax(adapters: dict, device="cpu", tp: int = 1, t: int = 0,
                      base_rule=None) -> dict:
    """The JAX package's ``{path: {"A", "B"}}`` adapters as float tensors:
    tensor rank ``t``'s slices of ``tp`` over a base split by
    ``base_rule``."""
    return {path: {k: shard(torch.from_numpy(np.array(ab[k])), _adapter_dim(base_rule, path, k),
                            tp, t).to(device) for k in ("A", "B")}
            for path, ab in adapters.items()}


def adapter_momentum_from_jax(exp_avg: dict, rank: int, device="cpu", tp: int = 1, t: int = 0,
                              base_rule=None) -> dict:
    """Row ``rank`` of the JAX package's stacked ``[world, ...]`` adapter
    momentum, keyed like :func:`models.lora.adapter_named_parameters`
    (``"path/A"``, ``"path/B"``): tensor rank ``t``'s slices of ``tp``."""
    return {f"{path}/{k}": shard(torch.from_numpy(np.array(ab[k][rank])),
                                 _adapter_dim(base_rule, path, k), tp, t).to(device)
            for path, ab in exp_avg.items() for k in ("A", "B")}


def pipeline_params_from_jax(tree: Any, n_layer: int, pp: int, stage: int, tp: int = 1,
                             t: int = 0, family: str = "gpt2") -> dict:
    """The JAX package's pipeline-layout params (numpy) as stage ``stage``
    of ``pp``'s ``{name: CPU tensor}``: its blocks (under the unsplit
    model's names) and the replicated leaves, tensor rank ``t``'s slices of
    ``tp`` by ``family``'s shard rule."""
    whole = {k: v for k, v in tree.items() if k != "stages"}
    whole["blocks"] = unstack_stage_params(tree["stages"], n_layer)
    mine = stage_layers(n_layer, PipeAxis(None, pp, stage))
    rule = gpt2_shard_dim if family == "gpt2" else llama_shard_dim
    return {k: shard(torch.from_numpy(np.array(v)), rule(k), tp, t)
            for k, v in state_dict_from_tree(whole).items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) in mine}


def pipeline_momentum_from_jax(exp_avg: Any, rank: int, n_layer: int, pp: int, stage: int,
                               tp: int = 1, t: int = 0, family: str = "gpt2") -> dict:
    """Row ``rank`` of the JAX package's stacked ``[world, ...]``
    pipeline-layout momentum as :func:`pipeline_params_from_jax` gives the
    params."""
    return pipeline_params_from_jax(map_tree(lambda m: np.asarray(m)[rank], exp_avg), n_layer,
                                    pp, stage, tp, t, family)


def pipeline_params_to_jax(whole: dict, pp: int) -> dict:
    """Whole leaves of every stage (``{name: tensor}``, such as
    ``Trainer.full_named`` gathers) in the JAX package's pipeline layout:
    the blocks stacked ``[pp, L/pp, ...]`` under ``stages``."""
    tree = params_to_jax(whole)
    tree["stages"] = stack_stage_params(tree.pop("blocks"), pp)
    return tree
