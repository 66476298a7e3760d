"""Host C++ runtime of the data path, built with g++ at first use: port of ``distributed_lion_tpu/native/__init__.py``.

Two sources, copies of the JAX package's (the same code; one comment names
the reference's file without a machine path):

- ``dataloader.cc``: mmap'd uint16/uint32 token shards cut into fixed
  blocks, a seeded per-epoch shuffle, and a background thread that
  gathers batches into int32 host buffers (``data/native_loader.py``);
- ``bpe_core.cc``: the GPT-2 BPE merge loop in id space
  (``data/bpe.py``'s native core).

:func:`build` compiles a source with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` (``$CXX`` when set) into ``build/native/`` of the checkout,
named by a hash of the source bytes and the flags, by a temporary file and
a rename, so concurrent builders never load a half-written library. The
libraries are loaded with ``ctypes``. Nothing is built at import: a
missing compiler shows at first use, and :func:`available` says whether
the loader library built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

ROOT = pathlib.Path(__file__).resolve().parents[2]
SRC_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIBS: dict = {}


class NativeBuildError(RuntimeError):
    pass


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where :func:`build` puts the library of ``source``."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``<name>.cc`` unless its library exists; returns its path."""
    source = SRC_DIR / f"{name}.cc"
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"cannot run {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{cmd[0]} failed on {source.name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _typed_loader(lib: ctypes.CDLL) -> None:
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    lib.dl_open.restype = ctypes.c_void_p
    lib.dl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                            ctypes.c_longlong]
    lib.dl_num_blocks.restype = ctypes.c_longlong
    lib.dl_num_blocks.argtypes = [ctypes.c_void_p]
    lib.dl_read_block.restype = ctypes.c_int
    lib.dl_read_block.argtypes = [ctypes.c_void_p, ctypes.c_longlong, c_i32p]
    lib.dl_start.restype = ctypes.c_int
    lib.dl_start.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_longlong, ctypes.c_longlong]
    lib.dl_next.restype = ctypes.c_int
    lib.dl_next.argtypes = [ctypes.c_void_p, c_i32p]
    lib.dl_close.restype = None
    lib.dl_close.argtypes = [ctypes.c_void_p]
    lib.dl_last_error.restype = ctypes.c_char_p
    lib.dl_last_error.argtypes = []


def _typed_bpe(lib: ctypes.CDLL) -> None:
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    lib.bpe_new.restype = ctypes.c_void_p
    lib.bpe_new.argtypes = [c_u8p, c_i64p, ctypes.c_int32, c_i32p, ctypes.c_int32]
    lib.bpe_encode.restype = ctypes.c_int64
    lib.bpe_encode.argtypes = [ctypes.c_void_p, c_u8p, c_i64p, ctypes.c_int64, c_i32p,
                               ctypes.c_int64]
    lib.bpe_cache_size.restype = ctypes.c_int64
    lib.bpe_cache_size.argtypes = [ctypes.c_void_p]
    lib.bpe_free.restype = None
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    lib.bpe_last_error.restype = ctypes.c_char_p
    lib.bpe_last_error.argtypes = []


def _load(name: str, typed) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build(name)))
            typed(lib)
            _LIBS[name] = lib
        return _LIBS[name]


def load() -> ctypes.CDLL:
    """The token loader library (``dataloader.cc``), typed."""
    return _load("dataloader", _typed_loader)


def load_bpe() -> ctypes.CDLL:
    """The BPE merge core (``bpe_core.cc``), typed."""
    return _load("bpe_core", _typed_bpe)


def available() -> bool:
    try:
        load()
        return True
    except (NativeBuildError, OSError):
        return False
