"""Fused Lion passes for NVIDIA Hopper, written by hand in Triton.

Port of ``distributed_lion_tpu/ops/pallas_lion.py``. The optimizer's whole
per-step work over the flat parameter vector is two elementwise passes:

- :func:`fused_ballots` replaces ``pallas_lion.fused_ballots``
  (``_ballot_kernel``, pallas_lion.py:79-102; per-bucket entry
  ``fused_ballots_window`` :155): int8 ballot = +1 where
  ``b1*m + (1-b1)*g > 0`` in float32, else −1 (zero votes −1).
- :func:`fused_apply` replaces ``pallas_lion.fused_apply``
  (``_apply_kernel``, :105-152; ``fused_apply_window`` :176):
  ``p' = p*(1 - lr*wd) - lr*(tot > 0 ? 1 : -1)`` and
  ``m' = b2*m + (1-b2)*g``, each computed in float32 and rounded once to
  its storage dtype.

**Bound.** Both are pure HBM streams with no data reuse and a few flops
per byte: the ballot pass moves 9 B per coordinate at float32 (g and m in,
int8 out), the apply pass 21 B (p, g, m in, an int8 tally in, p and m
out). At GPT-2 124M that is 1.12 GB and 2.61 GB per step, so on an H100
SXM (3.35 TB/s) the bounds are about 0.33 ms and 0.78 ms.

**Design.** One Triton program per ``BLOCK`` contiguous coordinates (a
power of two), with the ragged tail masked in the kernel: no padded copy,
where the TPU version pads to ``[rows, 128]`` (pallas_lion.py:59-76). The
caller passes windows (views) of its flat buffers, so a vote bucket is one
launch over one window. The apply pass writes p and m in place, which
saves the two output buffers a functional version would allocate. ``lr``
is a float32 device tensor the kernel loads, like the Pallas SMEM scalar,
so an LR schedule costs no host sync and no recompile. The constants
``1-b1``, ``1-b2`` and ``wd`` are Python doubles passed as float32
scalars, rounded once, as the JAX weak-typed literals are. The kernels are
launched with ``enable_fp_fusion=False``: every multiply and add rounds on
its own, exactly as the plain versions below, so the card's elections are
bit-identical to theirs.

Each wrapper runs its kernel for a CUDA tensor and its plain PyTorch
version for a CPU tensor, counts its launches in ``.launches``, and raises
on anything else. Triton is imported at the first launch, never at module
import, and caches its builds under ``build/triton/`` of the checkout
unless ``TRITON_CACHE_DIR`` is set.
"""

import os
import pathlib

import torch

os.environ.setdefault(
    "TRITON_CACHE_DIR",
    str(pathlib.Path(__file__).resolve().parents[2] / "build" / "triton"))

BLOCK = 4096      # coordinates per program: 16 per thread at 8 warps
NUM_WARPS = 8

# Bound at the first launch by _kernels(): this module must import where
# triton is absent (the CPU tests take the plain versions).
triton = tl = None
_KERNELS: dict = {}

_MOMENTUM_DTYPES = (torch.float32, torch.bfloat16)
_TALLY_DTYPES = (torch.int8, torch.int32)


def fused_ballots_plain(g: torch.Tensor, m: torch.Tensor, b1: float) -> torch.Tensor:
    """Plain version of the ballot kernel, op by op in the Pallas body's
    order (pallas_lion.py:79-81)."""
    u = m.to(torch.float32) * b1 + g.to(torch.float32) * (1.0 - b1)
    return torch.where(u > 0, 1, -1).to(torch.int8)


def fused_apply_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      tot: torch.Tensor, lr: torch.Tensor, wd: float,
                      b2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the apply kernel, op by op in the Pallas body's
    order (pallas_lion.py:105-115). Returns new ``(p, m)`` tensors."""
    s = torch.where(tot > 0, 1.0, -1.0)
    p32 = p.to(torch.float32)
    p_new = (p32 * (1.0 - lr * wd) - lr * s).to(p.dtype)
    m_new = (m.to(torch.float32) * b2 + g.to(torch.float32) * (1.0 - b2)).to(m.dtype)
    return p_new, m_new


def _kernels() -> dict:
    global triton, tl
    if _KERNELS:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def _ballot_kernel(g_ptr, m_ptr, out_ptr, n, b1, c1, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask).to(tl.float32)
        m = tl.load(m_ptr + offs, mask=mask).to(tl.float32)
        u = m * b1 + g * c1
        tl.store(out_ptr + offs, tl.where(u > 0, 1, -1).to(tl.int8), mask=mask)

    @triton.jit
    def _apply_kernel(p_ptr, g_ptr, m_ptr, tot_ptr, lr_ptr, n, wd, b2, c2,
                      BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        lr = tl.load(lr_ptr)
        s = tl.where(tl.load(tot_ptr + offs, mask=mask) > 0, 1.0, -1.0)
        p32 = tl.load(p_ptr + offs, mask=mask).to(tl.float32)
        p_new = p32 * (1.0 - lr * wd) - lr * s
        tl.store(p_ptr + offs, p_new.to(p_ptr.dtype.element_ty), mask=mask)
        m32 = tl.load(m_ptr + offs, mask=mask).to(tl.float32)
        g32 = tl.load(g_ptr + offs, mask=mask).to(tl.float32)
        m_new = m32 * b2 + g32 * c2
        tl.store(m_ptr + offs, m_new.to(m_ptr.dtype.element_ty), mask=mask)

    _KERNELS.update(ballot=_ballot_kernel, apply=_apply_kernel)
    return _KERNELS


def _check_window(name: str, *ts: torch.Tensor) -> None:
    dev, n = ts[0].device, ts[0].numel()
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dim() != 1 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous 1-D windows of one "
                             f"length, got {tuple(t.shape)} (contiguous="
                             f"{t.is_contiguous()}) against n={n}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")


def fused_ballots(g: torch.Tensor, m: torch.Tensor, b1: float) -> torch.Tensor:
    """[n] grads + momentum (momentum dtype) → [n] int8 ±1 ballots."""
    _check_window("fused_ballots", g, m)
    if g.dtype != m.dtype or m.dtype not in _MOMENTUM_DTYPES:
        raise ValueError(f"fused_ballots: g and m must share float32 or "
                         f"bfloat16, got {g.dtype} and {m.dtype}")
    if g.device.type == "cpu":
        return fused_ballots_plain(g, m, b1)
    out = torch.empty(g.numel(), dtype=torch.int8, device=g.device)
    if g.numel():
        _kernels()["ballot"][(triton.cdiv(g.numel(), BLOCK),)](
            g, m, out, g.numel(), b1, 1.0 - b1, BLOCK=BLOCK,
            num_warps=NUM_WARPS, enable_fp_fusion=False)
        fused_ballots.launches += 1
    return out


fused_ballots.launches = 0


def fused_apply(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                tot: torch.Tensor, lr: torch.Tensor, wd: float,
                b2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Decay, elected ±lr step and momentum update over one window, written
    in place into ``p`` and ``m`` (returned). ``tot`` is the wire's int8 or
    int32 tally (elect +1 where > 0); ``lr`` a float32 device scalar."""
    _check_window("fused_apply", p, g, m, tot)
    if g.dtype != m.dtype or m.dtype not in _MOMENTUM_DTYPES:
        raise ValueError(f"fused_apply: g and m must share float32 or "
                         f"bfloat16, got {g.dtype} and {m.dtype}")
    if p.dtype not in _MOMENTUM_DTYPES or tot.dtype not in _TALLY_DTYPES:
        raise ValueError(f"fused_apply: params {p.dtype} / tally {tot.dtype} "
                         "not in float32|bfloat16 / int8|int32")
    if lr.dtype != torch.float32 or lr.numel() != 1 or lr.device != p.device:
        raise ValueError("fused_apply: lr must be one float32 element on "
                         f"{p.device}, got {lr.dtype} {tuple(lr.shape)} on "
                         f"{lr.device}")
    if p.device.type == "cpu":
        p_new, m_new = fused_apply_plain(p, g, m, tot, lr, wd, b2)
        p.copy_(p_new)
        m.copy_(m_new)
        return p, m
    if p.numel():
        _kernels()["apply"][(triton.cdiv(p.numel(), BLOCK),)](
            p, g, m, tot, lr, p.numel(), wd, b2, 1.0 - b2, BLOCK=BLOCK,
            num_warps=NUM_WARPS, enable_fp_fusion=False)
        fused_apply.launches += 1
    return p, m


fused_apply.launches = 0
