"""Checkpoint integrity and fault injection: port of ``distributed_lion_tpu/train/resilience.py``, the checkpoint half.

Framework-free (stdlib only), copied so the port needs nothing of the JAX
package. Three parts:

- the **on-disk contract** of a committed step: every data file under
  ``<root>/<step>/`` digested into ``manifest.json`` (sha256 and size per
  file, plus the caller's metadata), then a ``COMMITTED`` marker that
  records the manifest's own sha256, written last; a root
  ``MANIFESTS_ENABLED`` stamp says "steps here are committed with
  manifests", so a step without its marker is a torn commit and not a
  legacy checkpoint. The files, keys, JSON and digests are the JAX
  package's, so its ``verify_step_dir`` and ``latest_valid_step_in``
  judge a step the port committed as the port's own do;
- a **fault-injection registry** that ``train/checkpoint.py`` consults
  where real failures strike: ``ckpt_save_raise`` (int: the first N
  writes fail), ``ckpt_crash_before_manifest`` and
  ``ckpt_crash_before_marker`` (bool: the commit dies before that file
  lands), ``ckpt_slow_commit`` (float: seconds the commit stalls);
- **corruption helpers** that damage a committed step as real incidents
  do (a torn write, a bit-flipped manifest, a lost marker).

Not ported yet (ROADMAP Queue 1 item 10): ``PreemptionGuard``, the
poison, membership and serve-fault parsers, and ``dcn_delay``.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import threading
from typing import Any, Optional

_FAULTS: dict[str, Any] = {}
_FAULTS_LOCK = threading.Lock()


def inject_fault(name: str, value: Any = True) -> None:
    with _FAULTS_LOCK:
        _FAULTS[name] = value


def clear_faults() -> None:
    with _FAULTS_LOCK:
        _FAULTS.clear()


def fault(name: str, default: Any = None) -> Any:
    with _FAULTS_LOCK:
        return _FAULTS.get(name, default)


def consume_fault_count(name: str) -> bool:
    """Decrement a counted fault; True while it still has charges (a bool
    fault stays armed)."""
    with _FAULTS_LOCK:
        n = _FAULTS.get(name, 0)
        if isinstance(n, bool):
            return n
        if n and n > 0:
            _FAULTS[name] = n - 1
            return True
        return False


MANIFEST = "manifest.json"
MARKER = "COMMITTED"
MANIFESTS_STAMP = "MANIFESTS_ENABLED"
MANIFEST_FORMAT = 1


def read_json(path: str | os.PathLike) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def sha256_file(path: pathlib.Path | str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def read_manifest(sdir: pathlib.Path | str) -> Optional[dict]:
    """The manifest of a committed step, after checking it against the
    marker's recorded digest (no data file is hashed). None when the step
    is uncommitted or its manifest does not match the marker."""
    sdir = pathlib.Path(sdir)
    marker = read_json(sdir / MARKER)
    if not marker:
        return None
    try:
        raw = (sdir / MANIFEST).read_bytes()
    except OSError:
        return None
    if hashlib.sha256(raw).hexdigest() != marker.get("manifest_sha256"):
        return None
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return None


def verify_step_dir(sdir: pathlib.Path | str) -> bool:
    """Full integrity check of one committed step: marker → manifest digest
    → every data file present with its recorded size and sha256."""
    sdir = pathlib.Path(sdir)
    manifest = read_manifest(sdir)
    if manifest is None:
        return False
    for rel, info in manifest.get("files", {}).items():
        p = sdir / rel
        try:
            if p.stat().st_size != info["bytes"]:
                return False
            if sha256_file(p) != info["sha256"]:
                return False
        except OSError:
            return False
    return True


def step_numbers(root: str | os.PathLike) -> list[int]:
    """The step directories under a checkpoint root, newest first."""
    try:
        return sorted((int(p.name) for p in pathlib.Path(root).iterdir()
                       if p.is_dir() and p.name.isdigit()), reverse=True)
    except OSError:
        return []


def latest_valid_step_in(directory: str | os.PathLike) -> Optional[int]:
    """Verified autodetect over a checkpoint root: the newest step that
    verifies; a marker-less step counts only in an unstamped (legacy)
    root."""
    root = pathlib.Path(directory)
    stamped = (root / MANIFESTS_STAMP).exists()
    for s in step_numbers(root):
        sdir = root / str(s)
        if verify_step_dir(sdir):
            return s
        if not stamped and read_json(sdir / MARKER) is None:
            return s  # legacy pre-manifest checkpoint: assumed good
    return None


def step_dir(directory: str | os.PathLike, step: int) -> pathlib.Path:
    """The directory of ``step`` under a checkpoint root."""
    return pathlib.Path(directory) / str(step)


def tear_leaf_file(directory: str | os.PathLike, step: int) -> pathlib.Path:
    """Truncate the largest data file of a committed step in place, a torn
    write; returns its path. Its digest no longer matches the manifest."""
    sdir = step_dir(directory, step)
    candidates = [p for p in sdir.rglob("*") if p.is_file()
                  and p.name not in (MANIFEST, MARKER) and p.stat().st_size > 0]
    if not candidates:
        raise FileNotFoundError(f"no data files under {sdir}")
    victim = max(candidates, key=lambda p: p.stat().st_size)
    size = victim.stat().st_size
    with open(victim, "r+b") as f:
        f.truncate(max(size // 2, 1) - 1 if size > 1 else 0)
    return victim


def corrupt_manifest(directory: str | os.PathLike, step: int) -> pathlib.Path:
    """Flip one byte in the middle of a committed step's manifest; the
    marker's digest no longer matches it."""
    path = step_dir(directory, step) / MANIFEST
    raw = bytearray(path.read_bytes())
    if not raw:
        raise OSError(f"empty manifest at {path}")
    mid = len(raw) // 2
    raw[mid] = raw[mid] ^ 0xFF
    path.write_bytes(bytes(raw))
    return path


def delete_commit_marker(directory: str | os.PathLike, step: int) -> None:
    """A crash between the manifest and the marker: the step's bytes are
    all present, but it was never committed."""
    (step_dir(directory, step) / MARKER).unlink()
