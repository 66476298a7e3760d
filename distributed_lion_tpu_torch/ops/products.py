"""Products with a float32 result: the port's ``preferred_element_type=jnp.float32``.

The JAX package computes the attention scores (``ops/attention.py:59``,
``models/gpt2.py:258``) and the tied-head logits (``models/gpt2.py:509``)
as compute-dtype products with a float32 result, so at bfloat16 compute
the values that reach the float32 softmax are never rounded to bfloat16.
A ``torch.matmul`` of bfloat16 operands returns bfloat16, and PyTorch's
bfloat16 product with a float32 output (``torch.mm(..., out_dtype=)``) runs
only on CUDA and has no autograd formula. :func:`matmul_f32` gives it one:

- forward: on CUDA, cuBLAS's bfloat16 product with a float32 output; on the
  CPU, the float32 product of the upcast operands. A product of two
  bfloat16 values is exact in float32, so both sum the same products in
  float32.
- backward: the float32 cotangent is rounded to the operands' dtype and the
  two transposed products run in that dtype with float32 accumulation, as
  every other product of the model's backward does.

The JAX package's transposed products take the float32 cotangent, and what
they do with it depends on the backend. The package sets no matmul
precision, so on a TPU they run at DEFAULT precision, which computes
float32 products in bfloat16 (``jax.lax.Precision``): the reference rounds
the cotangent to bfloat16 there just as this backward does. Only XLA:CPU
keeps it in float32. So on the CPU, at bfloat16 compute, the two differ by
one bfloat16 rounding of the cotangent carried through the product, at most
``2⁻⁸·Σ|g||b|`` an element, and agree to a bfloat16 ulp where the cotangent
is bfloat16-exact; at float32 compute they agree to float32 summation order
(``tests/test_torch_products.py``).
"""

from __future__ import annotations

import torch


def product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The forward product of :func:`matmul_f32` alone, outside autograd."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.view(*a.shape[:-1], b.shape[-1])
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.view(*a.shape[:-1], b.shape[-1])


class _MatmulF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return product_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:  # one shared right operand: fold every leading dim
                gb = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
            else:
                gb = torch.matmul(a.transpose(-1, -2), g)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result, for ``a`` ``[..., M, K]`` and ``b``
    either ``[K, N]`` or ``[..., K, N]`` with ``a``'s leading dims; both in
    one dtype (float32 or the compute dtype)."""
    return _MatmulF32.apply(a, b)
