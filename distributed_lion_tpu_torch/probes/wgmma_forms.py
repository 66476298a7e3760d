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

Each is held to float64 products of the same bfloat16 operands within 1e-5
of the largest magnitude (float32 sums of 64 or 128 terms). Prints one line
per form and exits 1 if a form with hopper.cuh's constants disagrees.
"""

import ctypes
import sys

import torch

from distributed_lion_tpu_torch.ops import cuda_build

# (LBO, SBO) of the MN-major descriptor: hopper.cuh's first, then the
# alternatives a misread of the layout would need
MN_CANDIDATES = ((0, 1024), (1024, 0), (8192, 1024), (1024, 8192))


def _lib():
    lib = cuda_build.load("wgmma_probe")
    p = ctypes.c_void_p
    lib.wgmma_probe.argtypes = [p] * 7 + [ctypes.c_uint, ctypes.c_uint, p]
    lib.wgmma_probe.restype = ctypes.c_int
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
    print(f"wgmma forms with hopper.cuh's descriptors: {'WRONG' if bad else 'all right'}",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
