"""Fused Lion passes for NVIDIA Hopper, written by hand in Triton and CUDA C++.

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

**Bound.** All three are pure HBM streams with no data reuse and a few
operations per byte: the ballot pass moves 9 B per coordinate at float32
(g and m in, int8 out), the apply pass 21 B (p, g, m in, an int8 tally in,
p and m out), the stats pass 2 B with an int8 tally (ballots and tally in,
nine counts out) and 5 B with an int32 one. At GPT-2 124M that is 1.12 GB,
2.61 GB and 0.25 GB per step, so on an H100 SXM (3.35 TB/s) the bounds are
about 0.33 ms, 0.78 ms and 0.074 ms.

**Design.** The ballot and apply passes are Triton: one program per
``BLOCK`` contiguous coordinates (a power of two), with the ragged tail
masked in the kernel: no padded copy, where the TPU version pads to
``[rows, 128]`` (pallas_lion.py:59-76). The caller passes windows (views)
of its flat buffers, so a vote bucket is one launch over one window. The
apply pass writes p and m in place, which saves the two output buffers a
functional version would allocate. ``lr`` is a float32 device tensor the
kernel loads, like the Pallas SMEM scalar, so an LR schedule costs no host
sync and no recompile. The constants ``1-b1``, ``1-b2`` and ``wd`` are
Python doubles passed as float32 scalars, rounded once, as the JAX
weak-typed literals are. The kernels are launched with
``enable_fp_fusion=False``: every multiply and add rounds on its own,
exactly as the plain versions below, so the card's elections are
bit-identical to theirs.

The stats pass is CUDA C++ (``csrc/vote_stats.cu``): per coordinate it is
one comparison into a small fixed set of bins, which registers and
integer warp reductions do at memory speed. A grid-stride loop over a few
blocks per SM loads 16-byte vectors (a scalar head and tail, since a
bucket's window may start at any byte offset), counts into 8-bit lanes in
registers through a shared-memory table from the tally to its bin's
increment, and each block adds one atomic per bin into an
``int32[nbins + 1]`` output (the last slot is the disagreement count). The
TPU kernel's resident VMEM tile across a sequential grid becomes atomics
across parallel blocks; the counts are exact integers, so the result does
not depend on the order. The library is instantiated for ``nbins`` 8
(``train.telemetry.NBINS``, the only caller's) and raises on another.

Each wrapper runs its kernel for a CUDA tensor and its plain PyTorch
version for a CPU tensor, counts its launches in ``.launches`` (the ballot
and apply wrappers also by the momentum dtype they ran on, in
``.by_dtype``), and raises on anything else. Triton is imported at the first launch, never at module
import, and caches its builds under ``build/triton/`` of the checkout
unless ``TRITON_CACHE_DIR`` is set; the stats library is built by ``nvcc``
at its first launch (``ops/cuda_build.py``), and a missing ``nvcc`` or a
failed build raises.
"""

import ctypes
import os
import pathlib

import torch

from distributed_lion_tpu_torch.ops import cuda_build

os.environ.setdefault(
    "TRITON_CACHE_DIR",
    str(pathlib.Path(__file__).resolve().parents[2] / "build" / "triton"))

BLOCK = 4096      # coordinates per program: 16 per thread at 8 warps
NUM_WARPS = 8
STATS_NBINS = (8,)   # the bin counts csrc/vote_stats.cu is instantiated for
STATS_MAX_WORLD = 1 << 28  # csrc/vote_stats.cu MAX_WORLD

# Bound at the first launch by _kernels(): this module must import where
# triton is absent (the CPU tests take the plain versions).
triton = tl = None
_KERNELS: dict = {}
_STATS_LIB = None

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

    _KERNELS.update(ballot=_ballot_kernel, apply=_apply_kernel)
    return _KERNELS


def _stats_lib() -> ctypes.CDLL:
    global _STATS_LIB
    if _STATS_LIB is None:
        lib = cuda_build.load("vote_stats")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.vote_stats_int8, lib.vote_stats_int32):
            fn.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, p]
            fn.restype = i
        lib.vote_stats_error_string.argtypes = [i]
        lib.vote_stats_error_string.restype = ctypes.c_char_p
        _STATS_LIB = lib
    return _STATS_LIB


def _count(wrapper, m: torch.Tensor) -> None:
    """One launch of ``wrapper``'s kernel over momentum ``m``."""
    wrapper.launches += 1
    key = str(m.dtype).removeprefix("torch.")
    wrapper.by_dtype[key] = wrapper.by_dtype.get(key, 0) + 1


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
        _count(fused_ballots, m)
    return out


fused_ballots.launches = 0
fused_ballots.by_dtype = {}


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
        _count(fused_apply, m)
    return p, m


fused_apply.launches = 0
fused_apply.by_dtype = {}


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
    if nbins not in STATS_NBINS:
        raise NotImplementedError(
            f"bucket_vote_stats: the CUDA kernel is built for nbins in {STATS_NBINS}, got "
            f"{nbins} (csrc/vote_stats.cu; ROADMAP Queue 2)")
    if world > STATS_MAX_WORLD:
        raise ValueError(f"bucket_vote_stats: world {world} above the CUDA kernel's "
                         f"{STATS_MAX_WORLD} (|tally| * nbins must fit int32, as in margin_bins)")
    out = torch.zeros(nbins + 1, dtype=torch.int32, device=ballots.device)
    if ballots.numel():
        lib = _stats_lib()
        fn = lib.vote_stats_int8 if total.dtype == torch.int8 else lib.vote_stats_int32
        err = fn(ballots.data_ptr(), total.data_ptr(), out.data_ptr(), ballots.numel(), world,
                 nbins, ballots.device.index,
                 torch.cuda.current_stream(ballots.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"bucket_vote_stats: CUDA error {err} at launch "
                               f"({lib.vote_stats_error_string(err).decode()})")
        bucket_vote_stats.launches += 1
    return out[:nbins], out[nbins]


bucket_vote_stats.launches = 0
