"""The port's LoRA adapters vs the JAX package's, on the CPU.

Tolerances: leaf order, paths and shapes exact; ``merge_lora`` and the
adapted forward at float32 ``atol=1e-6`` (a rank-r product summed in
another order). The branch dropout draws its masks from another generator
than JAX's, so it is held statistically: over 2**16 inputs the keep rate
is within 5 standard deviations of 1 − p in both packages, every kept
value is scaled by exactly 1/(1 − p), and the base path is never dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.models.llama import LlamaConfig as JConfig
from distributed_lion_tpu.models.llama import llama_init as j_init
from distributed_lion_tpu.models.lora import LoraConfig as JLoraConfig
from distributed_lion_tpu.models.lora import LoraTensor as JLoraTensor
from distributed_lion_tpu.models.lora import lora_init as j_lora_init
from distributed_lion_tpu.models.lora import lora_matmul as j_lora_matmul
from distributed_lion_tpu.models.lora import merge_lora as j_merge_lora
from distributed_lion_tpu.ops.quant import quantize_tree as j_quantize_tree
from distributed_lion_tpu_torch.models.llama import LlamaConfig, llama_init
from distributed_lion_tpu_torch.models.lora import (
    LoraConfig,
    LoraTensor,
    adapter_named_parameters,
    apply_adapters,
    lora_init,
    lora_matmul,
    merge_lora,
)
from distributed_lion_tpu_torch.utils.serialization import (
    adapter_momentum_from_jax,
    adapters_from_jax,
    llama_params_from_jax,
)

torch.set_num_threads(2)


def _jax_base(n_layer=12, quant=None):
    jcfg = JConfig.tiny(n_layer=n_layer)
    jparams = j_init(jax.random.key(0), jcfg)
    if quant:
        jparams = j_quantize_tree(jparams, quant, block=32)
    return jax.tree.map(np.asarray, jparams)


def test_lora_init_leaf_order_and_shapes_match_jax():
    """Twelve layers, so the paths sort as strings (blocks/0, blocks/1,
    blocks/10, blocks/11, blocks/2, …): the flat buffer follows JAX's leaf
    order, A before B."""
    jbase = _jax_base()
    jad = j_lora_init(jax.random.key(1), jbase, JLoraConfig())
    ad = lora_init(llama_params_from_jax(jbase), LoraConfig(), seed=1)
    assert sorted(ad) == sorted(jad)
    for path in jad:
        for k in ("A", "B"):
            assert tuple(ad[path][k].shape) == tuple(jad[path][k].shape), (path, k)
            assert ad[path][k].dtype == torch.float32
        assert not ad[path]["B"].any()
    flat, _ = jax.tree_util.tree_flatten_with_path(jad)
    jax_order = ["/".join(str(p.key) for p in path) for path, _ in flat]
    names = [name for name, _ in adapter_named_parameters(ad)]
    assert names == jax_order
    assert names[:6] == ["blocks/0/attn/wq/A", "blocks/0/attn/wq/B", "blocks/0/attn/wv/A",
                         "blocks/0/attn/wv/B", "blocks/1/attn/wq/A", "blocks/1/attn/wq/B"]
    assert names[8].startswith("blocks/10/")
    # A ~ N(0, 1/r): the standard deviation of all the A draws
    a = torch.cat([ad[p]["A"].reshape(-1) for p in ad])
    assert abs(a.std().item() * np.sqrt(8) - 1.0) < 0.05
    with pytest.raises(ValueError, match="no base weights matched"):
        lora_init({"w": torch.zeros(4, 4)}, LoraConfig())


@pytest.mark.parametrize("quant", [None, "nf4"])
def test_merge_and_apply_adapters_match_jax(quant):
    jbase = _jax_base(n_layer=2, quant=quant)
    lcfg = JLoraConfig(r=4, alpha=8)
    jad = jax.tree.map(np.asarray, j_lora_init(jax.random.key(1), jbase, lcfg))
    rng = np.random.default_rng(3)
    for ab in jad.values():
        ab["B"] = rng.normal(size=ab["B"].shape).astype(np.float32)
    base, ad = llama_params_from_jax(jbase), adapters_from_jax(jad)
    tcfg = LoraConfig(r=4, alpha=8)
    want = j_merge_lora(jbase, jad, lcfg)
    got = merge_lora(base, ad, tcfg)
    for layer in range(2):
        for name in ("wq", "wv"):
            np.testing.assert_allclose(got["blocks"][layer]["attn"][name].numpy(),
                                       np.asarray(want["blocks"][layer]["attn"][name]),
                                       atol=1e-6, rtol=0)
    assert got["blocks"][0]["attn"]["wk"] is base["blocks"][0]["attn"]["wk"]
    eff = apply_adapters(base, ad, tcfg)
    w = eff["blocks"][1]["attn"]["wv"]
    assert isinstance(w, LoraTensor) and w.scaling == 2.0 and w.dropout_seed is None
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    jw = JLoraTensor(jbase["blocks"][1]["attn"]["wv"], jad["blocks/1/attn/wv"]["A"],
                     jad["blocks/1/attn/wv"]["B"], lcfg.scaling)
    np.testing.assert_allclose(lora_matmul(torch.from_numpy(x), w).numpy(),
                               np.asarray(j_lora_matmul(jnp.asarray(x), jw)), atol=1e-5, rtol=1e-5)


def _dropout_stats(out, x):
    """(keep rate, the outputs where the branch was kept) of
    ``out = x + dropout(x)``."""
    kept = out != x
    return kept.mean(), out[kept]


def test_branch_dropout_statistics():
    """Base W = I, A = I, B = I, scaling 1, inputs all 1: the output is
    ``1 + dropout(1)``, so an entry is 1 (dropped) or 1 + 1/(1−p) (kept),
    that sum rounded to float32."""
    d, n, p = 16, 4096, 0.25
    keep = 1.0 - p
    eye = np.eye(d, dtype=np.float32)
    x = np.ones((n, d), np.float32)
    sigma = np.sqrt(keep * p / (n * d))

    t_w = LoraTensor(torch.from_numpy(eye), torch.from_numpy(eye), torch.from_numpy(eye), 1.0,
                     p, 12345)
    out = lora_matmul(torch.from_numpy(x), t_w).numpy()
    rate, vals = _dropout_stats(out, x)
    assert abs(rate - keep) < 5 * sigma
    np.testing.assert_array_equal(vals, np.float32(1.0) + np.float32(1.0 / keep))
    assert (out >= 1.0).all()  # the base path is never dropped

    again = lora_matmul(torch.from_numpy(x), t_w).numpy()
    other = lora_matmul(torch.from_numpy(x), LoraTensor(*[torch.from_numpy(eye)] * 3, 1.0,
                                                          p, 54321)).numpy()
    assert np.array_equal(out, again) and not np.array_equal(out, other)
    evalw = LoraTensor(*[torch.from_numpy(eye)] * 3, 1.0, p, None)
    np.testing.assert_array_equal(lora_matmul(torch.from_numpy(x), evalw).numpy(), 2 * x)

    j_w = JLoraTensor(jnp.asarray(eye), jnp.asarray(eye), jnp.asarray(eye), 1.0, p,
                      jax.random.key(7))
    j_out = np.asarray(j_lora_matmul(jnp.asarray(x), j_w))
    j_rate, j_vals = _dropout_stats(j_out, x)
    assert abs(j_rate - keep) < 5 * sigma and abs(rate - j_rate) < 7 * sigma
    np.testing.assert_allclose(j_vals, 1.0 + 1.0 / keep, rtol=1e-6)


def test_apply_adapters_seeds_each_site_and_disarms_in_eval():
    cfg = LlamaConfig.tiny()
    base = llama_init(cfg, seed=0, device="cpu")
    ad = lora_init(base, LoraConfig(dropout=0.1), seed=1)
    train = apply_adapters(base, ad, LoraConfig(dropout=0.1), dropout_seed=9)
    seeds = [train["blocks"][i]["attn"][n].dropout_seed for i in range(2) for n in ("wq", "wv")]
    assert len(set(seeds)) == 4 and all(s is not None for s in seeds)
    assert train["blocks"][0]["attn"]["wq"].dropout_rate == 0.1
    ev = apply_adapters(base, ad, LoraConfig(dropout=0.1))
    assert ev["blocks"][0]["attn"]["wq"].dropout_rate == 0.0
    assert base["blocks"][0]["attn"]["wq"] is ev["blocks"][0]["attn"]["wq"].base


def test_adapter_momentum_row_from_jax():
    jad = jax.tree.map(np.asarray, j_lora_init(jax.random.key(1), _jax_base(n_layer=2),
                                              JLoraConfig()))
    stacked = jax.tree.map(lambda a: np.stack([a, 3 * a]), jad)
    row = adapter_momentum_from_jax(stacked, 1)
    assert list(row) == [n for n, _ in adapter_named_parameters(adapters_from_jax(jad))]
    np.testing.assert_array_equal(row["blocks/1/attn/wq/A"].numpy(),
                                  3 * jad["blocks/1/attn/wq"]["A"])
