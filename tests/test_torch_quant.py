"""The port's NF4 and int8 quantization vs the JAX package's, on the CPU.

Tolerance: none. Codes and absmax are byte-identical (the same float32
division, the same left-sided search over the same 15 midpoints, the same
round-half-to-even), and dequantized values bit-identical (``levels ×
absmax`` in float32, cast once), in both layouts: ``shaped`` (the last dim
a multiple of the block) and ``flat`` (a [64, 259] leaf, as Llama's
``lm_head`` is [4096, 259] at the byte vocabulary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.ops import quant as jq
from distributed_lion_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

SHAPES = {"shaped": (48, 256), "flat": (64, 259), "shaped3d": (4, 6, 128)}


def _weight(shape, seed):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.02
    w.reshape(-1)[:5] = 0.0   # an all-zero-start block edge and exact zeros
    return w


def _same(jqt, tqt, dtype_pairs=((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16))):
    assert tqt.layout == jqt.layout and tqt.fmt == jqt.fmt and tqt.block == jqt.block
    assert tuple(tqt.shape) == tuple(jqt.shape)
    assert tqt.codes.dtype == torch.uint8 and tqt.absmax.dtype == torch.float32
    np.testing.assert_array_equal(tqt.codes.numpy(), np.asarray(jqt.codes))
    np.testing.assert_array_equal(tqt.absmax.numpy().view(np.uint32),
                                  np.asarray(jqt.absmax).view(np.uint32))
    for jdt, tdt in dtype_pairs:
        want = np.asarray(jq.dequantize(jqt, jdt).astype(jnp.float32))
        got = tq.dequantize(tqt, tdt)
        assert got.dtype == tdt and tuple(got.shape) == tuple(jqt.shape)
        np.testing.assert_array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fmt", ["nf4", "int8"])
@pytest.mark.parametrize("layout", list(SHAPES))
def test_codes_absmax_and_dequantize_match_jax(fmt, layout):
    w = _weight(SHAPES[layout], seed=len(layout) + len(fmt))
    block = {"nf4": 64, "int8": 128}[fmt]
    jfn = jq.quantize_nf4 if fmt == "nf4" else jq.quantize_int8
    tfn = tq.quantize_nf4 if fmt == "nf4" else tq.quantize_int8
    jqt = jfn(jnp.asarray(w), block=block)
    tqt = tfn(torch.from_numpy(w), block=block)
    assert tqt.layout == ("flat" if layout == "flat" else "shaped")
    _same(jqt, tqt)


def test_nf4_ties_and_extremes_match_jax():
    """Values on the midpoints between levels (the search's ties), at ±absmax
    and at 0, with a block whose absmax is 0: the same codes."""
    mids = (jq.NF4_LEVELS[1:] + jq.NF4_LEVELS[:-1]) / 2.0
    row = np.concatenate([mids, -mids, [1.0, -1.0, 0.0, 0.5, -0.5],
                          np.linspace(-1, 1, 64 - 2 * len(mids) - 5)]).astype(np.float32)
    w = np.stack([row, np.zeros(64, np.float32), row * 3.0, -row]).astype(np.float32)
    _same(jq.quantize_nf4(jnp.asarray(w)), tq.quantize_nf4(torch.from_numpy(w)))


def test_quantize_tree_picks_the_same_leaves():
    rng = np.random.default_rng(0)
    tree = {"wte": rng.normal(size=(259, 64)).astype(np.float32),
            "lm_head": rng.normal(size=(64, 259)).astype(np.float32),
            "ln_f": {"scale": np.ones(64, np.float32)},
            "blocks": [{"attn": {"wq": rng.normal(size=(64, 64)).astype(np.float32),
                                 "small": rng.normal(size=(8, 64)).astype(np.float32)}}]}
    for fmt in ("nf4", "int8"):
        jt = jq.quantize_tree(jax.tree.map(jnp.asarray, tree), fmt)
        tt = tq.quantize_tree(jax.tree.map(torch.from_numpy, tree), fmt)
        jflat = jax.tree.leaves(jt, is_leaf=lambda x: isinstance(x, jq.QuantizedTensor))
        tflat = jax.tree.leaves(tt, is_leaf=lambda x: isinstance(x, tq.QuantizedTensor))
        assert len(jflat) == len(tflat) == 5
        for j, t in zip(jflat, tflat):
            assert isinstance(j, jq.QuantizedTensor) == isinstance(t, tq.QuantizedTensor)
            if isinstance(t, tq.QuantizedTensor):
                _same(j, t, dtype_pairs=((jnp.float32, torch.float32),))
            else:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        dense = tq.dequantize_tree(tt)
        want = jq.dequantize_tree(jt)
        for j, t in zip(jax.tree.leaves(want), jax.tree.leaves(dense)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_maybe_dequant_passes_dense_through():
    w = torch.ones(3, 4)
    assert tq.maybe_dequant(w) is w
    with pytest.raises(ValueError, match="unknown quant format"):
        tq.dequantize(tq.QuantizedTensor(torch.zeros(2, 2, dtype=torch.uint8),
                                         torch.ones(2, 1), (2, 2), "fp8", 2))
