"""Frozen-weight quantization, NF4 and int8 blockwise: port of ``distributed_lion_tpu/ops/quant.py``.

The reference loads its 7B base in 4-bit NF4 with bf16 compute (QLoRA). A
:class:`QuantizedTensor` holds packed codes and per-block float32 absmax
scales and stands in any weight slot; the models call :func:`maybe_dequant`
on every weight, which dequantizes on the fly (no persistent dense copy).

- NF4: the 16-level normal-quantile codebook, two 4-bit codes to a byte,
  low nibble first (``c[0::2] | c[1::2] << 4``); a code is the left-sided
  ``searchsorted`` of the scaled value over the 15 midpoints of the levels.
- int8: blockwise absmax, ``round(x / absmax * 127)``, one byte a value.

Two layouts, as in the JAX package: ``shaped`` when the last dim is a
multiple of the block (codes and absmax keep the weight's leading dims,
blocks run along the last dim), else ``flat`` (codes over the row-major
flattened weight, zero-padded to whole blocks). Codes and absmax are
byte-identical to the JAX package's on the same weights, and dequantized
values bit-identical: ``levels × absmax`` in float32, cast once.

Under tensor parallelism a ``shaped`` leaf shards along the dense weight's
dims (``parallel.tensor_parallel.shard``): its codes and absmax are sliced on
the same dims, and each rank dequantizes only its slice, which is the slice
of the dequantized weight wherever :func:`validate_quant_tp` lets it through
(block-aligned on the last dim, whole bytes of NF4's two codes).

Plain PyTorch: the JAX package computes this in XLA, outside any Pallas
kernel. A fused dequantize-and-multiply kernel is later work (ROADMAP
Queue 2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

# The 16 NF4 levels: quantiles of N(0, 1) rescaled to [-1, 1] (the QLoRA
# codebook), the JAX package's values.
NF4_LEVELS = np.asarray(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    np.float32,
)
NF4_MIDS = (NF4_LEVELS[1:] + NF4_LEVELS[:-1]) / np.float32(2.0)
DEFAULT_BLOCK = {"nf4": 64, "int8": 256}


@dataclasses.dataclass
class QuantizedTensor:
    """Packed codes (uint8) and per-block absmax (float32) of a dense weight
    of ``shape``; ``fmt`` is ``'nf4'`` or ``'int8'``, ``block`` the block
    size in elements, ``layout`` ``'shaped'`` or ``'flat'``."""

    codes: torch.Tensor
    absmax: torch.Tensor
    shape: tuple
    fmt: str
    block: int
    layout: str = "shaped"

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def nbytes(self) -> int:
        return self.codes.numel() + 4 * self.absmax.numel()


def _use_shaped(shape: tuple, block: int, fmt: str) -> bool:
    # nf4 packs two codes a byte along the last dim, so it needs an even block
    return (len(shape) >= 2 and shape[-1] % block == 0
            and (fmt != "nf4" or block % 2 == 0))


def _blocks(w: torch.Tensor, block: int, shaped: bool) -> torch.Tensor:
    """float32 ``[..., n_blocks, block]`` (shaped) or ``[n_blocks, block]``
    (flat, zero-padded)."""
    w32 = w.to(torch.float32)
    if shaped:
        return w32.reshape(*w.shape[:-1], w.shape[-1] // block, block)
    flat = w32.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def _scaled(blocks: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    return blocks / torch.clamp_min(absmax, 1e-12)[..., None]


def quantize_nf4(w: torch.Tensor, block: int = 64) -> QuantizedTensor:
    """Blockwise absmax NF4 (nearest codebook level)."""
    shape = tuple(w.shape)
    shaped = _use_shaped(shape, block, "nf4")
    blocks = _blocks(w, block, shaped)
    absmax = blocks.abs().amax(dim=-1)
    mids = torch.from_numpy(NF4_MIDS).to(w.device)
    codes4 = torch.searchsorted(mids, _scaled(blocks, absmax).contiguous()).to(torch.uint8)
    codes4 = codes4.reshape(shape) if shaped else codes4.reshape(-1)
    packed = codes4[..., 0::2] | (codes4[..., 1::2] << 4)
    return QuantizedTensor(packed, absmax, shape, "nf4", block,
                           "shaped" if shaped else "flat")


def quantize_int8(w: torch.Tensor, block: int = 256) -> QuantizedTensor:
    """Blockwise absmax int8: ``round(x / absmax * 127)`` (half to even)."""
    shape = tuple(w.shape)
    shaped = _use_shaped(shape, block, "int8")
    blocks = _blocks(w, block, shaped)
    absmax = blocks.abs().amax(dim=-1)
    q = torch.round(_scaled(blocks, absmax) * 127.0)
    codes = q.to(torch.int8).view(torch.uint8)
    codes = codes.reshape(shape) if shaped else codes.reshape(-1)
    return QuantizedTensor(codes, absmax, shape, "int8", block,
                           "shaped" if shaped else "flat")


def _levels(qt: QuantizedTensor) -> torch.Tensor:
    """float32 code values, blocked like ``absmax`` with a trailing block
    axis: NF4 levels, or int8 codes."""
    lead = tuple(qt.codes.shape[:-1])
    if qt.fmt == "nf4":
        codes4 = torch.stack([qt.codes & 0x0F, qt.codes >> 4], dim=-1)
        codes4 = codes4.reshape(*lead, 2 * qt.codes.shape[-1])
        levels = torch.from_numpy(NF4_LEVELS).to(qt.codes.device)[codes4.long()]
    elif qt.fmt == "int8":
        levels = qt.codes.view(torch.int8).to(torch.float32)
    else:
        raise ValueError(f"unknown quant format {qt.fmt!r}")
    return levels.reshape(*lead, -1, qt.block)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The dense weight: ``levels × absmax`` (int8: ``codes × (absmax /
    127)``) in float32, cast once to ``dtype``."""
    scale = qt.absmax if qt.fmt == "nf4" else qt.absmax / 127.0
    vals = _levels(qt) * scale[..., None]
    if qt.layout == "shaped":
        return vals.reshape(qt.shape).to(dtype)
    return vals.reshape(-1)[: qt.size].reshape(qt.shape).to(dtype)


def maybe_dequant(w: Any, dtype=torch.bfloat16):
    """Models call this on every weight: dense tensors pass through."""
    if isinstance(w, QuantizedTensor):
        return dequantize(w, dtype)
    return w


def quantize_leaf(w: Any, fmt: str = "nf4", min_size: int = 4096,
                  block: int | None = None) -> Any:
    """One leaf of :func:`quantize_tree`: a weight of rank ≥ 2 and at least
    ``min_size`` elements is quantized, anything else kept."""
    quant = {"nf4": quantize_nf4, "int8": quantize_int8}[fmt]
    if isinstance(w, torch.Tensor) and w.dim() >= 2 and w.numel() >= min_size:
        return quant(w, block or DEFAULT_BLOCK[fmt])
    return w


def map_tree(fn, tree):
    """``fn`` over the leaves of a nested dict/list tree (a
    :class:`QuantizedTensor` is a leaf); the structure is copied."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def quantize_tree(params: Any, fmt: str = "nf4", min_size: int = 4096,
                  block: int | None = None) -> Any:
    """Quantize every large weight of rank ≥ 2 in a nested dict/list tree
    (norm scales and biases stay dense, as bitsandbytes leaves them)."""
    return map_tree(lambda w: quantize_leaf(w, fmt, min_size, block), params)


def dequantize_tree(params: Any, dtype=torch.float32) -> Any:
    """A dense copy of a tree with quantized leaves (for the merged save)."""
    return map_tree(lambda w: maybe_dequant(w, dtype), params)


def validate_quant_tp(params: Any, rule, tp: int) -> None:
    """Refuse, with the leaf's path, a quantized leaf that cannot shard
    under the shard rule ``rule(dotted path) -> dim or None`` (JAX
    quant.py:208-245, same words): a flat-layout leaf cannot shard at all;
    a shaped one needs each split dim divisible, on the last dim both
    ``last / (2 for nf4, else 1)`` and ``last / block``."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, prefix + (str(k),))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, prefix + (str(i),))
        elif isinstance(tree, QuantizedTensor):
            check("/".join(prefix), tree, rule(".".join(prefix)))

    def check(path, leaf, dim):
        if dim is None or tp == 1:
            return
        if leaf.layout != "shaped":
            raise ValueError(
                f"quantized leaf {path!r} has the flat layout (block {leaf.block} does not "
                f"divide last dim {leaf.shape[-1]}"
                + (", or is odd for nf4's 2-codes/byte packing"
                   if leaf.fmt == "nf4" and leaf.block % 2 else "")
                + ") and cannot shard over 'tensor'; pick a block size that divides the "
                "last dim (--quant_block)")
        if dim < len(leaf.shape) - 1:
            if leaf.shape[dim] % tp:
                raise ValueError(f"quantized leaf {path!r} dim {dim} ({leaf.shape[dim]}) not "
                                 f"divisible by tensor axis {tp}")
            return
        last = leaf.shape[-1]
        pack = 2 if leaf.fmt == "nf4" else 1
        if (last // pack) % tp or (last // leaf.block) % tp:
            raise ValueError(
                f"quantized leaf {path!r} last dim {last} cannot shard {tp}-way: needs "
                f"last/{pack} and last/block ({last}/{leaf.block}={last // leaf.block}) both "
                f"divisible by {tp}; shrink --quant_block")

    walk(params, ())
