"""The backward of the port's float32-result products (``ops/products.py``)
against ``jax.vjp`` of the JAX package's ``jnp.einsum(...,
preferred_element_type=jnp.float32)``, on the CPU.

Two call sites, each at a small size: the tied head, ``h [2, 16, 64] ·
wᵀ`` with ``w [512, 64]`` (``models/gpt2.py:509`` in the JAX package), and
the attention scores, ``q·kᵀ`` of ``[2, 2, 16, 16]`` operands
(``ops/attention.py:59``). Operands and the float32 cotangent come from a
numpy seed.

At bfloat16 compute the port rounds the float32 cotangent to bfloat16 and
runs the two transposed products in bfloat16 with float32 sums. XLA:CPU
keeps the float32 cotangent (``_dot_general_transpose_lhs`` calls
``dot_general(g, y, preferred_element_type=...)``). On a TPU the reference
runs at DEFAULT precision, which computes float32 products in bfloat16
(``jax.lax.Precision``), so there it rounds the cotangent as the port does.
The tests state that one difference and its size:

- a cotangent that bfloat16 represents exactly: the rounding is a no-op, and
  the grads agree to one bfloat16 ulp of each element (float32 sums in
  another order, then one rounding to bfloat16);
- a general float32 cotangent: ``|port − JAX| ≤ 2⁻⁸·Σ|g||b|`` (one
  bfloat16 rounding of each cotangent element, at most half an ulp or
  ``2⁻⁸`` of it, carried through the product) plus one bfloat16 ulp of the
  result (each side rounds its float32 sum to bfloat16 once);
- at float32 compute nothing is rounded: ``rtol 1e-6`` plus the float32
  summation-order bound ``2·K·2⁻²⁴·Σ|g||b|`` of two length-K dot products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu_torch.ops.products import matmul_f32

torch.set_num_threads(2)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (to nearest even), as float32."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp of each element of x (8 significant bits)."""
    ax = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(ax)) - 7)


def _site(site: str, rng):
    """(a, b, cotangent, the JAX einsum, the port's product, sums): the
    head's h and w, or the scores' q and k, as bfloat16-exact float32
    values. ``sums(|g|)`` gives ``(Σ|g||b|, K)`` for a's grad and for b's,
    K the length of the sum."""
    if site == "head":
        a = _bf16(rng.normal(size=(2, 16, 64)).astype(np.float32))
        b = _bf16(rng.normal(size=(512, 64)).astype(np.float32) * 0.1)
        g = (rng.normal(size=(2, 16, 512)) * 1e-3).astype(np.float32)
        return (a, b, g,
                lambda x, y: jnp.einsum("btd,vd->btv", x, y, preferred_element_type=jnp.float32),
                lambda x, y: matmul_f32(x, y.t()),
                lambda ag: ((ag @ np.abs(b), 512),
                            (np.einsum("btv,btd->vd", ag, np.abs(a)), 2 * 16)))
    a = _bf16(rng.normal(size=(2, 2, 16, 16)).astype(np.float32) * 2)
    b = _bf16(rng.normal(size=(2, 2, 16, 16)).astype(np.float32) * 2)
    g = (rng.normal(size=(2, 2, 16, 16)) * 1e-2).astype(np.float32)
    return (a, b, g,
            lambda x, y: jnp.einsum("bhqd,bhkd->bhqk", x, y, preferred_element_type=jnp.float32),
            lambda x, y: matmul_f32(x, y.transpose(-1, -2)),
            lambda ag: ((ag @ np.abs(b), 16), (np.swapaxes(ag, -1, -2) @ np.abs(a), 16)))


def _grads(a, b, g, jax_fn, port_fn, dtype):
    """(JAX's grads, the port's grads) of (a, b) at cotangent g, as float32
    numpy; operands in ``dtype`` (a name: bfloat16 or float32)."""
    _, vjp = jax.vjp(jax_fn, jnp.asarray(a, getattr(jnp, dtype)),
                     jnp.asarray(b, getattr(jnp, dtype)))
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g))]
    ta, tb = (torch.tensor(x).to(getattr(torch, dtype)).requires_grad_() for x in (a, b))
    out = port_fn(ta, tb)
    assert out.dtype == torch.float32
    out.backward(torch.tensor(g))
    got = [t.grad.float().numpy() for t in (ta, tb)]
    assert ta.grad.dtype == ta.dtype and tb.grad.dtype == tb.dtype
    return want, got


@pytest.mark.parametrize("site", ["head", "scores"])
@pytest.mark.parametrize("case", ["bf16_exact_cotangent", "float32_cotangent",
                                  "float32_compute"])
def test_matmul_f32_backward_matches_jax(site, case):
    rng = np.random.default_rng(11)
    a, b, g, jax_fn, port_fn, sums = _site(site, rng)
    if case == "bf16_exact_cotangent":
        g = _bf16(g)
    dtype = "float32" if case == "float32_compute" else "bfloat16"
    want, got = _grads(a, b, g, jax_fn, port_fn, dtype)
    for name, w, p, (s, k) in zip(("da", "db"), want, got, sums(np.abs(g))):
        assert w.shape == p.shape and np.isfinite(p).all()
        diff = np.abs(p - w)
        if case == "bf16_exact_cotangent":
            limit = _ulp_bf16(w)
        elif case == "float32_cotangent":
            limit = 2.0 ** -8 * s + _ulp_bf16(w)
        else:
            limit = 1e-6 * np.abs(w) + 2 * k * 2.0 ** -24 * s
        worst = float((diff / limit).max())
        assert worst <= 1.0, f"{site} {case} {name}: |port - JAX| reaches {worst:.3f} of its bound"
    if case == "float32_cotangent":
        # the rounding of the cotangent is what the general case shows
        assert any((np.abs(p - w) > 0).any() for w, p in zip(want, got))
