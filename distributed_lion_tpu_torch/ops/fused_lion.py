"""Fused Lion passes for NVIDIA Hopper, written by hand in Triton.

Port of ``distributed_lion_tpu/ops/pallas_lion.py``. The optimizer's whole
per-step work over the flat parameter vector is two elementwise passes,
plus one reduction under ``--telemetry``:

- :func:`fused_ballots` replaces ``pallas_lion.fused_ballots``
  (``_ballot_kernel``, pallas_lion.py:79-102; per-bucket entry
  ``fused_ballots_window`` :155): int8 ballot = +1 where
  ``b1*m + (1-b1)*g > 0`` in float32, else −1 (zero votes −1).
- :func:`fused_apply` replaces ``pallas_lion.fused_apply``
  (``_apply_kernel``, :105-152; ``fused_apply_window`` :176):
  ``p' = p*(1 - lr*wd) - lr*(tot > 0 ? 1 : -1)`` and
  ``m' = b2*m + (1-b2)*g``, each computed in float32 and rounded once to
  its storage dtype.
- :func:`bucket_vote_stats` replaces ``pallas_lion.bucket_vote_stats``
  (``_stats_kernel``, :206-264): the margin histogram of one bucket's
  tally, ``bin = min(|total|*nbins // world, nbins - 1)``, and the count of
  coordinates whose local ballot lost, ``(ballot > 0) != (total > 0)``.

**Bound.** Both are pure HBM streams with no data reuse and a few flops
per byte: the ballot pass moves 9 B per coordinate at float32 (g and m in,
int8 out), the apply pass 21 B (p, g, m in, an int8 tally in, p and m
out). At GPT-2 124M that is 1.12 GB and 2.61 GB per step, so on an H100
SXM (3.35 TB/s) the bounds are about 0.33 ms and 0.78 ms. The stats pass
reads 2 B per coordinate with an int8 tally (0.074 ms at GPT-2 124M) and
5 B with an int32 one.

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
bit-identical to theirs. The stats kernel reduces each program's block to
per-bin counts in registers and adds them with one atomic per bin into an
``int32[nbins + 1]`` output (the last slot is the disagreement count), the
masked tail included in no bin: the TPU kernel's resident VMEM tile across
a sequential grid becomes atomics across parallel programs. The counts are
exact integers, so the result does not depend on the order.

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
STATS_BLOCK = 16384  # stats: 64 int8 coordinates per thread, 9 atomics per program

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


def margin_bins(total: torch.Tensor, world: int, nbins: int) -> torch.Tensor:
    """The margin bin of each coordinate, ``min(|total|*nbins // world,
    nbins - 1)``, as int32: the rule the stats kernel applies."""
    return torch.clamp_max(total.to(torch.int32).abs() * nbins // world, nbins - 1)


def bucket_vote_stats_plain(ballots: torch.Tensor, total: torch.Tensor, world: int,
                            nbins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the stats kernel (pallas_lion.py:206-230): int32
    ``[nbins]`` margin bincount and the int32 disagreement count."""
    hist = torch.bincount(margin_bins(total, world, nbins), minlength=nbins).to(torch.int32)
    return hist, ((ballots > 0) != (total > 0)).sum(dtype=torch.int32)


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

    # world is not specialized: Triton turns an integer argument equal to 1
    # into a constant, and at world == 1 that build counted half the
    # coordinates on the card (torch 2.11, triton 3.6.0)
    @triton.jit(do_not_specialize=["world"])
    def _stats_kernel(ballot_ptr, tot_ptr, out_ptr, n, world, NBINS: tl.constexpr,
                      BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        t = tl.load(tot_ptr + offs, mask=mask, other=0).to(tl.int32)
        b = tl.load(ballot_ptr + offs, mask=mask, other=0)
        binidx = tl.minimum((tl.abs(t) * NBINS) // world, NBINS - 1)
        for k in tl.static_range(NBINS):
            tl.atomic_add(out_ptr + k, tl.sum(tl.where(mask & (binidx == k), 1, 0)))
        dis = tl.where(mask & ((b > 0) != (t > 0)), 1, 0)
        tl.atomic_add(out_ptr + NBINS, tl.sum(dis))

    _KERNELS.update(ballot=_ballot_kernel, apply=_apply_kernel, stats=_stats_kernel)
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


def bucket_vote_stats(ballots: torch.Tensor, total: torch.Tensor, world: int,
                      nbins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One bucket's vote-health counts from its int8 ballots and its int8 or
    int32 tally: ``(hist int32[nbins], disagree int32)``, both on the
    ballots' device."""
    _check_window("bucket_vote_stats", ballots, total)
    if ballots.dtype != torch.int8 or total.dtype not in _TALLY_DTYPES:
        raise ValueError(f"bucket_vote_stats: ballots {ballots.dtype} / tally "
                         f"{total.dtype} not int8 / int8|int32")
    if world < 1 or nbins < 1:
        raise ValueError(f"bucket_vote_stats: world {world} and nbins {nbins} must be >= 1")
    if ballots.device.type == "cpu":
        return bucket_vote_stats_plain(ballots, total, world, nbins)
    out = torch.zeros(nbins + 1, dtype=torch.int32, device=ballots.device)
    if ballots.numel():
        n = ballots.numel()
        _kernels()["stats"][(triton.cdiv(n, STATS_BLOCK),)](
            ballots, total, out, n, world, NBINS=nbins, BLOCK=STATS_BLOCK,
            num_warps=NUM_WARPS)
        bucket_vote_stats.launches += 1
    return out[:nbins], out[nbins]


bucket_vote_stats.launches = 0
