"""Causal flash attention: the port's counterpart of jax's bundled Pallas TPU kernel.

The JAX package's ``attention_flash`` (``distributed_lion_tpu/ops/attention.py:70``)
wraps ``jax.experimental.pallas.ops.tpu.flash_attention``, whose three
``pallas_call``s are ported by hand to CUDA C++ for Hopper in
``csrc/flash_attention.cu``:

- :func:`flash_attention_fwd` (forward, ``_flash_attention_impl``):
  ``(q, k, v) -> (o, lse)``;
- :func:`flash_attention_bwd_dkv` (``_flash_attention_bwd_dkv``):
  ``(q, k, v, do, lse, di) -> (dk, dv)``;
- :func:`flash_attention_bwd_dq` (``_flash_attention_bwd_dq``):
  ``(q, k, v, do, lse, di) -> dq``.

``di = Σ o·do`` (float32) is plain PyTorch between the forward and the two
backward kernels, as jax computes it outside its kernels. Tensors are
``[B, H, T, head_dim]``; scores are ``q·kᵀ / sqrt(head_dim)`` under a causal
mask; ``lse`` is the float32 log-sum-exp of each row's scores, ``[B, H, T]``.

Each wrapper launches its kernel for a CUDA tensor and counts the launch in
``.launches``; for a CPU tensor it computes its plain PyTorch version
below. On CUDA the kernels take bfloat16 with head_dim 64 only, and
``q``, ``k``, ``v`` and ``do`` through their strides, with only head_dim
contiguous (the model's q/k/v are transposed views of one projection): the
forward and dK/dV kernels load them by TMA through tensor maps over those
strides, under the rule of :func:`strided_ok`; anything else raises. The library is built with ``nvcc`` at the first
launch (``ops/cuda_build.py``); a missing ``nvcc`` or a failed build
raises.

Rounding (plain versions and kernels alike): scores and softmax in
float32; the probabilities are rounded to the input dtype before the value
product, and so are ``P`` and ``dS`` before the backward products, which
sum in float32. The kernels' forward normalizes after ``P·V`` (online
softmax) where the plain version normalizes before, and the forward and
dK/dV kernels exponentiate in base 2 with ``log2(e)`` folded into the
scale; the two differ by bfloat16 rounding and float32 ulps only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from distributed_lion_tpu_torch.ops import cuda_build
from distributed_lion_tpu_torch.ops.products import matmul_f32

KERNEL_HEAD_DIMS = (64,)
UNPORTED_DTYPE = ("flash attention on CUDA runs in bfloat16 only; float32 flash is "
                  "not ported (ROADMAP Queue 2 item 4, PERF.md kernel table row 4)")
UNPORTED_HEAD_DIM = ("flash attention on CUDA is built for head_dim 64 only; head_dim "
                     "128 comes with the Llama slice (ROADMAP Queue 2 item 4)")

_LIB = None
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("flash_attention")
        i, f = ctypes.c_int, ctypes.c_float
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_fwd_bf16_hd64.argtypes = [_P] * 5 + [i, i, i, strides, f, i, _P]
        lib.flash_attention_bwd_dkv_bf16_hd64.argtypes = [_P] * 8 + [i, i, i, strides, f, i, _P]
        lib.flash_attention_bwd_dq_bf16_hd64.argtypes = [_P] * 7 + [i, i, i, strides, f, i, _P]
        for fn in ("fwd", "bwd_dkv", "bwd_dq"):
            getattr(lib, f"flash_attention_{fn}_bf16_hd64").restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _scale(q: torch.Tensor) -> float:
    return 1.0 / math.sqrt(q.shape[-1])


def _causal(T: int, device) -> torch.Tensor:
    return torch.ones(T, T, dtype=torch.bool, device=device).tril()


# ------------------------------------------------------------ plain versions
def flash_attention_fwd_plain(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """Float32 scores scaled by ``1/sqrt(hd)``, the causal mask, a float32
    softmax; ``o`` in q's dtype (probabilities rounded to it before the
    value product) and ``lse`` float32 ``[B, H, T]``."""
    s = matmul_f32(q, k.transpose(-1, -2)) * _scale(q)
    s = s.masked_fill(~_causal(q.shape[2], q.device), -1e30)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(probs, v).to(q.dtype), torch.logsumexp(s, dim=-1)


def _probs_ds(q, k, v, do, lse, di) -> tuple[torch.Tensor, torch.Tensor]:
    """P recomputed from ``lse`` (float32, zero above the diagonal) and
    ``dS = P∘(dP − di)`` (float32)."""
    s = matmul_f32(q, k.transpose(-1, -2)) * _scale(q)
    s = s.masked_fill(~_causal(q.shape[2], q.device), -math.inf)
    p = torch.exp(s - lse[..., None])
    dp = matmul_f32(do, v.transpose(-1, -2))
    return p, p * (dp - di[..., None])


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, di) -> tuple[torch.Tensor, torch.Tensor]:
    """``dk = dSᵀ·Q·scale`` and ``dv = Pᵀ·dO``, in q's dtype."""
    p, ds = _probs_ds(q, k, v, do, lse, di)
    dt = q.dtype
    dk = (matmul_f32(ds.to(dt).transpose(-1, -2), q) * _scale(q)).to(dt)
    dv = matmul_f32(p.to(dt).transpose(-1, -2), do).to(dt)
    return dk, dv


def flash_attention_bwd_dq_plain(q, k, v, do, lse, di) -> torch.Tensor:
    """``dq = dS·K·scale``, in q's dtype."""
    _, ds = _probs_ds(q, k, v, do, lse, di)
    return (matmul_f32(ds.to(q.dtype), k) * _scale(q)).to(q.dtype)


def attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = Σ o·do`` over head_dim in float32 (jax ``flash_attention.py:273``)."""
    return (o.to(torch.float32) * do.to(torch.float32)).sum(-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """``(dq, dk, dv)`` from the forward's ``o`` and ``lse``."""
    di = attention_di(o, do)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, di)
    return flash_attention_bwd_dq_plain(q, k, v, do, lse, di), dk, dv


# ------------------------------------------------------------ kernel wrappers
TMA_STRIDE_LIMIT = 1 << 40   # bytes: a tensor map's strides are below it


def strided_ok(t: torch.Tensor) -> bool:
    """The kernels' operand layout, which the tensor maps of their TMA loads
    (``csrc/hopper.cuh``) take as it is: head_dim contiguous, a 16-byte
    aligned base, and batch, head and time strides that are positive
    multiples of 16 bytes below 2**40 bytes."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and (s * size) % 16 == 0 and s * size < TMA_STRIDE_LIMIT
                    for s in t.stride()[:-1]))


def _check(name: str, ts: tuple, rows: tuple = ()) -> None:
    """``ts``: the [B, H, T, hd] operands; ``rows``: the float32 [B, H, T]
    per-row operands (``lse``, ``di``)."""
    q = ts[0]
    if q.dim() != 4:
        raise ValueError(f"{name}: expects [B, H, T, head_dim], got {tuple(q.shape)}")
    for t in ts + rows:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    for t in ts:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: operands {tuple(t.shape)} {t.dtype} against "
                             f"{tuple(q.shape)} {q.dtype}")
    for t in rows:
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name}: row operand {tuple(t.shape)} {t.dtype}, expected "
                             f"float32 {tuple(q.shape[:3])}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"{name}: {UNPORTED_DTYPE}; got {q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"{name}: {UNPORTED_HEAD_DIM}; got {q.shape[-1]}")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"{name}: B*H = {q.shape[0] * q.shape[1]} exceeds the grid's 65535")
    for t in ts:
        if not strided_ok(t):
            raise ValueError(f"{name}: operand strides {t.stride()} are not the kernels' "
                             "layout (head_dim contiguous, 16-byte aligned base, other "
                             "strides positive multiples of 16 bytes)")
    for t in rows:
        if not t.is_contiguous():
            raise ValueError(f"{name}: lse and di must be contiguous")


def _strides(*ts: torch.Tensor):
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch(fn: str, *args) -> None:
    lib = _lib()
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch "
                           f"({lib.flash_attention_error_string(err).decode()})")


def _tail(q: torch.Tensor) -> tuple:
    return (_scale(q), q.device.index, torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: ``(o, lse)``; ``o`` contiguous in q's dtype."""
    _check("flash_attention_fwd", (q, k, v))
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v)
    B, H, T, D = q.shape
    o = torch.empty((B, H, T, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if o.numel():
        _launch("flash_attention_fwd_bf16_hd64", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), lse.data_ptr(), B, H, T, _strides(q, k, v), *_tail(q))
        flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, di) -> tuple[torch.Tensor, torch.Tensor]:
    """dK/dV kernel: ``(dk, dv)``, contiguous in q's dtype."""
    _check("flash_attention_bwd_dkv", (q, k, v, do), (lse, di))
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, di)
    B, H, T, _ = q.shape
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dk.numel():
        _launch("flash_attention_bwd_dkv_bf16_hd64", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, H, T, _strides(q, k, v, do), *_tail(q))
        flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, di) -> torch.Tensor:
    """dQ kernel: ``dq``, contiguous in q's dtype."""
    _check("flash_attention_bwd_dq", (q, k, v, do), (lse, di))
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, di)
    B, H, T, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        _launch("flash_attention_bwd_dq_bf16_hd64", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                B, H, T, _strides(q, k, v, do), *_tail(q))
        flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


class FlashAttention(torch.autograd.Function):
    """Causal attention through the three wrappers: the forward saves
    ``(q, k, v, o, lse)``; the backward computes ``di`` in plain PyTorch
    and calls the dK/dV and dQ kernels. Under ``torch.utils.checkpoint``
    the forward runs again in the backward pass."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cuda" and not strided_ok(do):
            do = do.contiguous()
        di = attention_di(o, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di)
        return flash_attention_bwd_dq(q, k, v, do, lse, di), dk, dv


def flash_attention(q, k, v) -> torch.Tensor:
    """Differentiable causal flash attention, ``[B, H, T, hd]`` in and out."""
    return FlashAttention.apply(q, k, v)
