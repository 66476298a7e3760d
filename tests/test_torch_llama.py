"""The port's Llama vs the JAX package's, on the CPU at ``LlamaConfig.tiny``
(2 layers, d 64, 4 query heads over 2 KV heads: GQA), from carried weights.

Tolerances: float32 compute, logits and grads ``atol=1e-5, rtol=1e-4``
(the frameworks sum matmuls and softmaxes in other orders); rope and
RMSNorm at float32 ``1e-6`` (``cos``/``sin``/``pow`` of the two libraries
differ by float32 ulps). bfloat16 compute: logits ``atol=2e-2`` (as GPT-2's
test), grads within 4 bfloat16 ulps of each tensor's largest magnitude
(2**-6 of it): the two packages round the compute-dtype activations and
cotangents at other points of their sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.models.llama import LlamaConfig as JConfig
from distributed_lion_tpu.models.llama import _rms_norm as j_rms_norm
from distributed_lion_tpu.models.llama import apply_rope as j_apply_rope
from distributed_lion_tpu.models.llama import llama_apply as j_apply
from distributed_lion_tpu.models.llama import llama_init as j_init
from distributed_lion_tpu.models.llama import rope_angles as j_rope_angles
from distributed_lion_tpu.models.lora import LoraConfig as JLoraConfig
from distributed_lion_tpu.models.lora import apply_adapters as j_apply_adapters
from distributed_lion_tpu.models.lora import lora_init as j_lora_init
from distributed_lion_tpu.models.loss import clm_loss_and_metrics as j_loss
from distributed_lion_tpu.ops.quant import quantize_tree as j_quantize_tree
from distributed_lion_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    apply_rope,
    llama_init,
    rms_norm,
    rope_angles,
)
from distributed_lion_tpu_torch.models.lora import LoraConfig, apply_adapters
from distributed_lion_tpu_torch.models.loss import clm_loss_and_metrics
from distributed_lion_tpu_torch.ops.quant import QuantizedTensor
from distributed_lion_tpu_torch.utils.serialization import (
    adapters_from_jax,
    llama_params_from_jax,
)

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-4)


def _tokens(T=48):
    return np.random.default_rng(0).integers(0, 256, size=(2, T)).astype(np.int32)


def _carried(compute: str, quant: str | None = None):
    jcfg = JConfig.tiny(compute_dtype=getattr(jnp, compute))
    jparams = j_init(jax.random.key(0), jcfg)
    if quant:
        jparams = j_quantize_tree(jparams, quant, block=32)
    jparams = jax.tree.map(np.asarray, jparams)
    cfg = LlamaConfig.tiny(compute_dtype=getattr(torch, compute))
    return jcfg, jparams, cfg, llama_params_from_jax(jparams)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _jax_grads_by_path(jg):
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in flat}


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_carried_weights_logits_and_grads(compute):
    jcfg, jparams, cfg, params = _carried(compute)
    tokens = _tokens()

    def loss_fn(p):
        return j_loss(j_apply(p, jnp.asarray(tokens), jcfg), jnp.asarray(tokens))[0]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    want_logits = np.asarray(jax.jit(lambda p: j_apply(p, jnp.asarray(tokens), jcfg))(jparams))
    for _, t in _leaves(params):
        t.requires_grad_()
    model = Llama(cfg, params)
    logits = model(torch.from_numpy(tokens))
    assert logits.dtype == torch.float32 and logits.shape == (2, 48, 256)
    loss, _ = clm_loss_and_metrics(logits, torch.from_numpy(tokens))
    loss.backward()
    want = _jax_grads_by_path(jg)
    if compute == "float32":
        np.testing.assert_allclose(logits.detach().numpy(), want_logits, **TOL)
        np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    else:
        np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=2e-2, rtol=0)
        np.testing.assert_allclose(loss.item(), float(jl), atol=2e-3, rtol=0)
    assert len(want) == len(list(_leaves(params))) == 2 + 1 + 9 * 2
    for path, t in _leaves(params):
        w = want[path]
        if compute == "float32":
            np.testing.assert_allclose(t.grad.numpy(), w, err_msg=path, **TOL)
        else:
            np.testing.assert_allclose(t.grad.numpy(), w, err_msg=path,
                                       atol=2.0 ** -6 * np.abs(w).max(), rtol=0)


def test_rope_and_rms_norm_match_jax():
    rng = np.random.default_rng(1)
    cos, sin = rope_angles(100, 16, 10000.0)
    jcos, jsin = j_rope_angles(100, 16, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6, rtol=0)
    x = rng.normal(size=(2, 3, 100, 16)).astype(np.float32)
    got = apply_rope(torch.from_numpy(x), cos, sin)
    want = j_apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # interleaved, not rotate-half: columns (0, 1) rotate together
    np.testing.assert_allclose(got[..., 0].numpy(), x[..., 0] * cos[:, 0].numpy()
                               - x[..., 1] * sin[:, 0].numpy(), atol=1e-6)
    h = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=64).astype(np.float32)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-6), (torch.bfloat16, jnp.bfloat16, 0)):
        got = rms_norm(torch.from_numpy(h).to(dt), {"scale": torch.from_numpy(scale)}, 1e-5)
        want = j_rms_norm(jnp.asarray(h, jdt), {"scale": jnp.asarray(scale)}, 1e-5)
        assert got.dtype == dt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol * 10, rtol=tol)


def test_quantized_base_with_adapters_matches_jax():
    """An NF4 base (block 32: the tiny leaves are shaped, ``lm_head`` [64,
    256] too) with LoRA on wq/wv whose B is non-zero: logits and the
    adapters' grads, float32 compute."""
    jcfg, jparams, cfg, params = _carried("float32", quant="nf4")
    assert isinstance(params["blocks"][0]["attn"]["wq"], QuantizedTensor)
    lcfg = JLoraConfig(r=4, alpha=8)
    jad = jax.tree.map(np.asarray, j_lora_init(jax.random.key(1), jparams, lcfg))
    rng = np.random.default_rng(2)
    for ab in jad.values():
        ab["B"] = rng.normal(size=ab["B"].shape).astype(np.float32) * 0.1
    tokens = _tokens(40)

    def loss_fn(ad):
        eff = j_apply_adapters(jparams, ad, lcfg)
        return j_loss(j_apply(eff, jnp.asarray(tokens), jcfg), jnp.asarray(tokens))[0]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jad)
    ad = {p: {k: t.requires_grad_() for k, t in ab.items()}
          for p, ab in adapters_from_jax(jad).items()}
    model = Llama(cfg, params)
    logits = model(torch.from_numpy(tokens), apply_adapters(params, ad, LoraConfig(r=4, alpha=8)))
    loss, _ = clm_loss_and_metrics(logits, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    assert sorted(ad) == sorted(jad) == ["blocks/0/attn/wq", "blocks/0/attn/wv",
                                         "blocks/1/attn/wq", "blocks/1/attn/wv"]
    for path, ab in ad.items():
        for k in ("A", "B"):
            np.testing.assert_allclose(ab[k].grad.numpy(), np.asarray(jg[path][k]),
                                       err_msg=f"{path}/{k}", **TOL)


def test_init_on_the_fly_quantization_and_shapes():
    """``llama_init`` with ``quant`` quantizes each large leaf as it is made
    (the leaves ``quantize_tree`` picks), keeps the norm scales dense, and
    is the same from the same seed."""
    cfg = LlamaConfig.tiny(vocab_size=259)
    a = llama_init(cfg, seed=3, device="cpu", quant="nf4")
    b = llama_init(cfg, seed=3, device="cpu", quant="nf4")
    dense = llama_init(cfg, seed=3, device="cpu")
    assert a["lm_head"].layout == "flat" and a["wte"].layout == "shaped"
    assert isinstance(a["ln_f"]["scale"], torch.Tensor)
    assert [p for p, _ in _leaves(a)] == [p for p, _ in _leaves(dense)]
    for (pa, la), (_, lb) in zip(_leaves(a), _leaves(b)):
        if isinstance(la, QuantizedTensor):
            assert torch.equal(la.codes, lb.codes) and torch.equal(la.absmax, lb.absmax), pa
            assert la.shape == tuple(dict(_leaves(dense))[pa].shape)
    with pytest.raises(ValueError, match="unknown llama model_name"):
        LlamaConfig.named("llama9")
    with pytest.raises(ValueError, match="exceeds n_ctx"):
        Llama(cfg, dense)(torch.zeros(1, 129, dtype=torch.long))
