"""Build a CUDA C++ source with ``nvcc`` at first use and load it with ``ctypes``.

The port's CUDA kernels live under ``distributed_lion_tpu_torch/csrc/`` and
expose a plain C interface: pointers, the CUDA stream and sizes as C
scalars, and a ``cudaError_t`` (as ``int``) returned by every entry point
after its launch. :func:`load` compiles a source into a shared library for
Hopper (``sm_90a``) under ``build/cuda/`` of the checkout, named by a hash
of the source bytes, the headers beside it (``csrc/*.cuh``, ``csrc/*.h``)
and the compiler flags, so an edited source or header rebuilds and an
unchanged one loads at once. The compiler's resource report
(``-Xptxas -v``: registers, shared memory, spills per kernel) is kept
beside the library as ``<name>-<hash>.log``.

A missing ``nvcc`` or a failed build raises; nothing falls back to a plain
version. Nothing is built at import: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = ROOT / "distributed_lion_tpu_torch" / "csrc"
BUILD_DIR = ROOT / "build" / "cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``CUDA_HOME`` or ``/usr/local/cuda``;
    raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use and have no fallback")


def find_cuobjdump() -> str:
    """``cuobjdump`` beside ``nvcc``."""
    tool = pathlib.Path(find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        raise RuntimeError(f"cuobjdump not found beside {find_nvcc()}")
    return str(tool)


def count_sass(sass: str, functions, opcodes) -> dict:
    """``{function: {opcode: lines}}`` over the ``cuobjdump -sass`` text of
    a library: the lines of each function whose (mangled) name contains a
    name of ``functions`` that issue each opcode of ``opcodes`` (with any
    suffix, as ``HGMMA.64x128x16.F32.BF16``)."""
    counts = {f: dict.fromkeys(opcodes, 0) for f in functions}
    pats = {op: re.compile(rf"\b{re.escape(op)}\b") for op in opcodes}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((f for f in functions if f in line), None)
        elif current is not None:
            for op, pat in pats.items():
                if pat.search(line):
                    counts[current][op] += 1
    return counts


def sass_registers(sass: str, functions) -> dict:
    """``{function: (registers, setmaxnreg values)}`` over the ``cuobjdump
    -sass`` text of a library: the highest general register a function's
    code names, counting each ``HGMMA``'s accumulator range from its first
    register, plus one; and the register counts its ``USETMAXREG``
    instructions set (a warp-specialized kernel launches with the count
    ptxas reports, then hands registers between warpgroups)."""
    out = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((f for f in functions if f in line), None)
            if current is not None:
                out[current] = (0, [])
            continue
        if current is None:
            continue
        regs, sets = out[current]
        for r in re.findall(r"\bR(\d+)\b", line):
            regs = max(regs, int(r) + 1)
        m = re.search(r"HGMMA\.64x(\d+)x16\.F32\S*\s+R(\d+)", line)
        if m:
            regs = max(regs, int(m.group(2)) + int(m.group(1)) // 2)
        m = re.search(r"USETMAXREG\.\S+\s+(?:\w+,\s*)?(0x[0-9a-f]+)", line)
        if m:
            sets = sets + [int(m.group(1), 16)]
        out[current] = (regs, sets)
    return out


def ptxas_serialized(log: str) -> dict:
    """``{function: reason}`` for each function whose wgmma ptxas
    serializes (a wait after every product) in the ``-Xptxas -v`` report of
    a build, with the reason the report gives."""
    return {m.group(2): m.group(1) for m in re.finditer(
        r"wgmma\.mma_async instructions are serialized due to (.+?) (?:in|for) the function "
        r"'([^']+)'",
        log)}


def ptxas_spills(log: str) -> dict:
    """``{function: (spill store bytes, spill load bytes)}`` from the
    ``-Xptxas -v`` report of a build."""
    spills, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            spills[current] = (int(m.group(1)), int(m.group(2)))
            current = None
    return spills


def sass_of(library: pathlib.Path) -> str:
    """The ``cuobjdump -sass`` text of a built library."""
    return subprocess.run([find_cuobjdump(), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where :func:`load` puts the library of ``source``: keyed by a hash of
    the source bytes, the bytes of every header beside it (``*.cuh``,
    ``*.h``, which the source may include) and the flags."""
    digest = hashlib.sha256(source.read_bytes())
    headers = sorted(source.parent.glob("*.cuh")) + sorted(source.parent.glob("*.h"))
    for header in headers:
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: pathlib.Path) -> pathlib.Path:
    """Compile ``source`` unless its library exists; returns the library's
    path. The build writes a temporary file and renames it, so concurrent
    builds of one source never load a half-written library."""
    out = library_path(source)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(CSRC / f"{name}.cu")))
        return _LIBS[name]
