"""Probe: each ``wgmma`` operand form of the flash kernels against ``torch.matmul``.

    python -m distributed_lion_tpu_torch.probes.wgmma_forms

Builds ``csrc/wgmma_probe.cu`` (one warpgroup, the building blocks of
``csrc/hopper.cuh``: TMA loads with the 128-byte swizzle, an mbarrier, the
shared-memory descriptors and the accumulator-to-A-fragment repack) and
checks on the card, on seeded bfloat16 matrices:

- ``c1 = a·bkᵀ``: A and B K-major, m64n128k16 (the forward's ``S = Q·Kᵀ``);
- ``c2 = a·bk[:64]ᵀ``: the same at m64n64k16 (dK/dV's ``Sᵀ = K·Qᵀ``);
- ``c3 = bf16(c1)·v``: A from registers, B MN-major over 8 k-steps (``P·V``,
  ``Pᵀ·dO``, ``dSᵀ·Q``);
- ``c4 = a·v[:64]``: B MN-major from shared memory, once for each candidate
  (LBO, SBO) of the MN-major descriptor, the first being hopper.cuh's.

and the head_dim 128 forms (``wgmma_probe128``), on tiles loaded as two TMA
boxes of 64 columns (``hopper::tma_load_rows<128>``):

- ``e1``, ``e2``, ``e3 = a·bk[:n]ᵀ`` for n = 128, 16, 64: K-major k-steps
  across both column blocks (``S = Q·Kᵀ`` of the forward, ``Sᵀ = K·Qᵀ`` of
  dK/dV at a query tile of 16, ``S = Q·Kᵀ`` of dQ);
- ``e4 = bf16(e1)·v``, ``e5 = bf16(e2)·v[:16]``, ``e6 = bf16(e3)·bk[:64]``:
  ``m64n128k16`` with A from registers and B MN-major at N = 128, LBO the
  column-block stride (``P·V``; ``Pᵀ·dO`` and ``dSᵀ·Q``; ``dS·K``);
- ``e7 = a[:, :64]·v[:64]``: B MN-major from shared memory at N = 128, once
  for each candidate (LBO, SBO), the first being hopper.cuh's.

and the forms of the head_dim 128 backward kernels (``wgmma_probe_bwd128``),
``a`` a 64-row query tile and ``bk`` a block's 128 keys:

- ``f1 = bk[64:]·aᵀ``: ``m64n64k16`` across both column blocks, A the
  second consumer's 64 rows of the 128-row tile, B the 64-row tile (dK/dV's
  ``Sᵀ = K·Qᵀ``);
- ``f2 = bf16(f1)·a``: ``m64n128k16`` with A and B from shared memory, A the
  threads' own swizzled bf16 store of ``f1`` (``hopper::store_sw128_tile``,
  the proxy fence, a named barrier), B the 64-row tile MN-major (``dV +=
  Pᵀ·dO``, ``dK += dSᵀ·Q``);
- ``f3 = bk[:64]·aᵀ`` and ``f4 = bf16(f1)·a`` issued as two groups in
  flight: ``wgmma_wait<1>`` completes ``f3``'s alone (the overlapped loops'
  order).

Each is held to float64 products of the same bfloat16 operands within 1e-5
of the largest magnitude (float32 sums of 16 to 128 terms). Prints one line
per form and exits 1 if a form with hopper.cuh's constants disagrees.
"""

import ctypes
import sys

import torch

from distributed_lion_tpu_torch.ops import cuda_build

# (LBO, SBO) of the MN-major descriptor: hopper.cuh's first, then the
# alternatives a misread of the layout would need
MN_CANDIDATES = ((0, 1024), (1024, 0), (8192, 1024), (1024, 8192))
# the same at N = 128 over a tile of 128 rows: its column blocks are 16384
# bytes apart
MN128_CANDIDATES = ((16384, 1024), (1024, 16384), (0, 1024), (8192, 1024))


def _lib():
    lib = cuda_build.load("wgmma_probe")
    p = ctypes.c_void_p
    lib.wgmma_probe.argtypes = [p] * 7 + [ctypes.c_uint, ctypes.c_uint, p]
    lib.wgmma_probe.restype = ctypes.c_int
    lib.wgmma_probe128.argtypes = [p] * 10 + [ctypes.c_uint, ctypes.c_uint, p]
    lib.wgmma_probe128.restype = ctypes.c_int
    lib.wgmma_probe_bwd128.argtypes = [p] * 7
    lib.wgmma_probe_bwd128.restype = ctypes.c_int
    lib.wgmma_probe_error_string.argtypes = [ctypes.c_int]
    lib.wgmma_probe_error_string.restype = ctypes.c_char_p
    return lib


def _err(got, want) -> float:
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wgmma_forms: CUDA is not available")
    lib = _lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(64, 64, generator=gen, device="cuda").bfloat16()
    bk = torch.randn(128, 64, generator=gen, device="cuda").bfloat16()
    v = torch.randn(128, 64, generator=gen, device="cuda").bfloat16()
    ad, bd, vd = a.double(), bk.double(), v.double()
    bad = False
    for i, (lbo, sbo) in enumerate(MN_CANDIDATES):
        c1 = torch.full((64, 128), float("nan"), device="cuda")
        c2, c3, c4 = (torch.full((64, 64), float("nan"), device="cuda") for _ in range(3))
        err = lib.wgmma_probe(a.data_ptr(), bk.data_ptr(), v.data_ptr(), c1.data_ptr(),
                              c2.data_ptr(), c3.data_ptr(), c4.data_ptr(), lbo, sbo,
                              torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"wgmma_probe: CUDA error {err} at launch "
                               f"({lib.wgmma_probe_error_string(err).decode()})")
        torch.cuda.synchronize()
        errs = {"c4 (B MN-major, shared)": _err(c4, ad @ vd[:64])}
        if i == 0:
            errs = {"c1 (K-major, n128)": _err(c1, ad @ bd.T),
                    "c2 (K-major, n64)": _err(c2, ad @ bd[:64].T),
                    "c3 (A registers, B MN-major)": _err(c3, c1.bfloat16().double() @ vd),
                    **errs}
        for name, e in errs.items():
            ok = e <= 1e-5
            bad |= i == 0 and not ok
            print(f"[wgmma] {name} MN (LBO, SBO) = ({lbo}, {sbo}): max err {e:.3e} of max "
                  f"|value| -> {'ok' if ok else 'WRONG'}", flush=True)
    bad |= _forms128(lib, gen)
    bad |= _forms_bwd128(lib, gen)
    print(f"wgmma forms with hopper.cuh's descriptors: {'WRONG' if bad else 'all right'}",
          flush=True)
    return 1 if bad else 0


def _forms128(lib, gen) -> bool:
    """The head_dim 128 forms; True if one with hopper.cuh's constants
    disagrees."""
    a = torch.randn(64, 128, generator=gen, device="cuda").bfloat16()
    bk = torch.randn(128, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(128, 128, generator=gen, device="cuda").bfloat16()
    ad, bd, vd = a.double(), bk.double(), v.double()
    bad = False
    for i, (lbo, sbo) in enumerate(MN128_CANDIDATES):
        shapes = ((64, 128), (64, 16), (64, 64), (64, 128), (64, 128), (64, 128), (64, 128))
        e = [torch.full(s, float("nan"), device="cuda") for s in shapes]
        err = lib.wgmma_probe128(a.data_ptr(), bk.data_ptr(), v.data_ptr(),
                                 *(t.data_ptr() for t in e), lbo, sbo,
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"wgmma_probe128: CUDA error {err} at launch "
                               f"({lib.wgmma_probe_error_string(err).decode()})")
        torch.cuda.synchronize()
        e1, e2, e3, e4, e5, e6, e7 = e
        errs = {"e7 (N 128, B MN-major, shared)": _err(e7, ad[:, :64] @ vd[:64])}
        if i == 0:
            errs = {"e1 (hd128 K-major, n128)": _err(e1, ad @ bd.T),
                    "e2 (hd128 K-major, n16)": _err(e2, ad @ bd[:16].T),
                    "e3 (hd128 K-major, n64)": _err(e3, ad @ bd[:64].T),
                    "e4 (A registers, B MN-major n128, 8 k-steps)":
                        _err(e4, e1.bfloat16().double() @ vd),
                    "e5 (A registers, B MN-major n128, 1 k-step)":
                        _err(e5, e2.bfloat16().double() @ vd[:16]),
                    "e6 (A registers, B MN-major n128, 4 k-steps)":
                        _err(e6, e3.bfloat16().double() @ bd[:64]),
                    **errs}
        for name, err_ in errs.items():
            ok = err_ <= 1e-5
            bad |= i == 0 and not ok
            print(f"[wgmma] {name} MN (LBO, SBO) = ({lbo}, {sbo}): max err {err_:.3e} of max "
                  f"|value| -> {'ok' if ok else 'WRONG'}", flush=True)
    return bad


def _forms_bwd128(lib, gen) -> bool:
    """The head_dim 128 backward forms; True if one disagrees."""
    a = torch.randn(64, 128, generator=gen, device="cuda").bfloat16()
    bk = torch.randn(128, 128, generator=gen, device="cuda").bfloat16()
    ad, bd = a.double(), bk.double()
    f = [torch.full(s, float("nan"), device="cuda") for s in ((64, 64), (64, 128), (64, 64),
                                                               (64, 128))]
    err = lib.wgmma_probe_bwd128(a.data_ptr(), bk.data_ptr(), *(t.data_ptr() for t in f),
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgmma_probe_bwd128: CUDA error {err} at launch "
                           f"({lib.wgmma_probe_error_string(err).decode()})")
    torch.cuda.synchronize()
    f1, f2, f3, f4 = f
    p = f1.bfloat16().double()
    errs = {"f1 (hd128 K-major n64, A rows 64-127 of 128)": _err(f1, bd[64:] @ ad.T),
            "f2 (A and B shared, A a thread-written tile, B MN-major n128)": _err(f2, p @ ad),
            "f3 (first of two groups in flight, wait<1>)": _err(f3, bd[:64] @ ad.T),
            "f4 (second of two groups in flight, wait<0>)": _err(f4, p @ ad)}
    bad = False
    for name, e in errs.items():
        ok = e <= 1e-5
        bad |= not ok
        print(f"[wgmma] {name}: max err {e:.3e} of max |value| -> {'ok' if ok else 'WRONG'}",
              flush=True)
    return bad


if __name__ == "__main__":
    sys.exit(main())
