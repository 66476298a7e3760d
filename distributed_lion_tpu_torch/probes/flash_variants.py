"""Probe: variants of the flash kernels' source, side by side on one card.

    python -m distributed_lion_tpu_torch.probes.flash_variants DIR [DIR ...]

Each DIR holds a ``flash_attention.cu`` (and, beside it, the ``hopper.cuh``
it includes): the tree's ``csrc/``, a parent's unpacked with ``git
archive``, or a copy edited to try one change (``flash_variant_sources.py``
writes the variants it names). Each is built with the
port's ``nvcc`` flags into ``DIR/flash_attention.so``, all builds started
together. For each it prints the ptxas notes that matter (spill bytes, and
"wgmma serialized" notes with their reasons) and, from ``cuobjdump -sass``,
the registers each flash kernel's code names, its ``setmaxnreg`` counts,
and which kernels' SASS equals the first DIR's (addresses and encodings
aside).
Then, at ``chip_smoke.py``'s timed shapes (hd 64: B 8, H 12, T 1024, q/k/v
views of one projection; hd 128: B 4, H 32, T 1024, v a view), it checks
that each variant's o and lse, and its dk, dv and dq, are the same bits as
the first DIR's, and times the forward, dK/dV, dQ and di entries of every
variant in turns (the DIRs in order, then reversed: parent, change, change,
parent for two), each a median of 25 CUDA-event runs. A source without a
di entry (from before the di kernel) times the plain ``attention_di`` in
its place, marked "(plain)". A variant whose outputs differ is timed all
the same and marked: an ablation that cuts work out is one.
"""

import concurrent.futures
import ctypes
import pathlib
import re
import subprocess
import sys

import torch

from distributed_lion_tpu_torch.ops import cuda_build
from distributed_lion_tpu_torch.ops import flash_attention as fa

SHAPES = ((64, 8, 12, 1024, "qkv"), (128, 4, 32, 1024, "v"))
KERNELS = tuple(f"flash_{k}_kernelILi{d}E" for d in (64, 128)
                for k in ("fwd", "bwd_dkv", "bwd_dq"))


def kernel_sass(sass: str) -> dict:
    """Each flash kernel's instructions, without addresses and encodings."""
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in KERNELS if k in line), None)
            if current:
                out[current] = []
        elif current:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
            if m:
                out[current].append(re.sub(r"0x[0-9a-f]+", "#", m.group(1)))
    return out


def build(src_dir: pathlib.Path) -> tuple:
    """(library, report lines, per-kernel SASS) of ``src_dir/flash_attention.cu``."""
    lib = src_dir / "flash_attention.so"
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
                           str(src_dir / "flash_attention.cu")], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_dir}:\n{log[-4000:]}")
    spills = {f: v for f, v in cuda_build.ptxas_spills(log).items() if v != (0, 0)}
    lines = [f"spill bytes (stores, loads): {spills or 'none'}",
             f"wgmma serialized: {cuda_build.ptxas_serialized(log) or 'none'}"]
    sass = cuda_build.sass_of(lib)
    for kernel, (regs, sets) in cuda_build.sass_registers(sass, KERNELS).items():
        lines.append(f"{kernel}: registers used {regs}, setmaxnreg {sets}")
    return lib, lines, kernel_sass(sass)


def entries(lib_path: pathlib.Path, D: int) -> dict:
    lib = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    out = {}
    for name, pointers in (("fwd", 5), ("bwd_dkv", 8), ("bwd_dq", 7), ("di", 3)):
        entry = f"flash_attention_{name}_bf16_hd{D}"
        if not hasattr(lib, entry):
            continue
        fn = getattr(lib, entry)
        scale = [] if name == "di" else [f]
        fn.argtypes = [p] * pointers + [i, i, i, strides, *scale, i, p]
        fn.restype = i
        out[name] = fn
    return out


def checked(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA error {err} at launch")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: CUDA is not available")
    dirs = [pathlib.Path(a) for a in sys.argv[1:]]
    if not dirs:
        raise SystemExit(__doc__)
    names = [d.name for d in dirs]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(f"[card] {card.splitlines()[0]}", flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        built = list(pool.map(build, dirs))
    for name, (_, lines, sass) in zip(names, built):
        for line in lines:
            print(f"[build] {name}: {line}", flush=True)
        same = [k for k in KERNELS if sass.get(k) == built[0][2].get(k)]
        print(f"[sass] {name}: the same SASS as {names[0]}'s in {same or 'no kernel'}",
              flush=True)
    # chip_smoke's inputs and timing, imported here: it is a script at the
    # checkout's root, on the path when the probe runs from there
    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for D, B, H, T, views in SHAPES:
        q, k, v, do = cs.flash_inputs(gen, T, B, H, D, views)
        o, lse = fa.flash_attention_fwd(q, k, v)
        di = fa.attention_di(o, do)
        o2, lse2, di2 = torch.empty_like(o), torch.empty_like(lse), torch.empty_like(lse)
        dk, dv, dq = (torch.empty_like(o) for _ in range(3))
        s3, s4, s_di = fa._strides(q, k, v), fa._strides(q, k, v, do), fa._strides(o, do)
        tail = (1.0 / D ** 0.5, q.device.index, stream)
        calls, first, first_fwd, label = {}, None, None, {}
        for name, (lib, _, _) in zip(names, built):
            e = entries(lib, D)
            label[name] = name if "di" in e else f"{name} (plain)"
            calls[name] = {
                "fwd": lambda e=e: checked(e["fwd"], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           o2.data_ptr(), lse2.data_ptr(), B, H, T, s3, *tail),
                "dkv": lambda e=e: checked(e["bwd_dkv"], q.data_ptr(), k.data_ptr(),
                                           v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                           di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, T,
                                           s4, *tail),
                "dq": lambda e=e: checked(e["bwd_dq"], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                                          dq.data_ptr(), B, H, T, s4, *tail),
                "di": (lambda e=e: checked(e["di"], o.data_ptr(), do.data_ptr(), di2.data_ptr(),
                                           B, H, T, s_di, *tail[1:]))
                      if "di" in e else (lambda: fa.attention_di(o, do))}
            calls[name]["fwd"]()
            calls[name]["dkv"]()
            calls[name]["dq"]()
            torch.cuda.synchronize()
            got_fwd = (o2.clone(), lse2.clone())
            got = (dk.clone(), dv.clone(), dq.clone())
            first, first_fwd = first or got, first_fwd or got_fwd
            same_fwd = all(torch.equal(a, b) for a, b in zip(got_fwd, first_fwd))
            same = all(torch.equal(a, b) for a, b in zip(got, first))
            d_o, d_lse = ((a.float() - b.float()).abs() for a, b in zip(got_fwd, first_fwd))
            print(f"[bits] hd{D} {name}: o, lse {'==' if same_fwd else 'DIFFER from'} "
                  f"{names[0]}'s (o: {int((d_o > 0).sum())} elements differ, max "
                  f"{d_o.max().item():.3e}; lse: {int((d_lse > 0).sum())}, max "
                  f"{d_lse.max().item():.3e}); dk, dv, dq {'==' if same else 'DIFFER from'} "
                  f"{names[0]}'s", flush=True)
        for kernel in ("fwd", "dkv", "dq", "di"):
            order = names + names[::-1]
            times = [(label[n] if kernel == "di" else n, cs.time_ms(calls[n][kernel]))
                     for n in order]
            print(f"[turns] hd{D} {kernel}: " + ", ".join(f"{n} {ms:.4f}" for n, ms in times)
                  + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
