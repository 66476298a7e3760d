"""Checkpoint integrity, fault injection and preemption: port of
``distributed_lion_tpu/train/resilience.py``.

Framework-free (stdlib only), copied so the port needs nothing of the JAX
package. Four parts:

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
  ``journal_torn_write`` (int: the next N writes of the run journal's
  sink tear mid-line, ``train/journal.py``); ``dcn_delay`` (float: the
  seconds of round trip the hier wire's cross-group leg is emulated to
  take, read at every launch and consume by ``parallel.collectives``: the
  launch stamps the host clock per optimizer step, the consume sleeps until
  stamp + delay, so the steps run between them (the
  ``dcn_pipeline_depth`` window) count toward it and only the unhidden
  rest is paid, recorded in ``collectives.DCN_WAIT``; it changes timing
  only. Arm it before the trainer is built, and call
  ``collectives.dcn_link_reset()`` between measured runs); ``ballot_poison`` (the
  ``(kind, worker, start_step)`` of :func:`parse_poison`, the
  ``--inject_poison`` flag, read by the trainer's step); ``membership``
  (the ``(kind, worker, step)`` list of :func:`parse_membership_specs`,
  the ``--inject_membership`` flag, consumed by the control plane at step
  boundaries, ``train/control_plane.py``); and ``serve`` (the ``(kind,
  replica, tick, arg)`` list of :func:`parse_serve_specs`, the JAX
  package's ``--inject_serve``, parsed here for the serving plane);
  :func:`consume_due` pops a list-valued schedule's due entries;
- **corruption helpers** that damage a committed step as real incidents
  do (a torn write, a bit-flipped manifest, a lost marker);
- :class:`PreemptionGuard`, the SIGTERM flag the trainer checks at every
  step boundary (``--on_preempt save_exit``), which journals the
  ``preempt_drain`` event when the loop first sees it.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import signal
import threading
import time
from typing import Any, Iterable, Optional

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


def consume_due(name: str, through: int, step_of=None) -> list:
    """Atomically pop the due entries of a list-valued schedule fault: the
    entries whose step (``step_of``, default ``entry[2]``) is ``<=
    through``, in schedule order; later entries stay armed."""
    if step_of is None:
        def step_of(e):
            return int(e[2])
    with _FAULTS_LOCK:
        pending = _FAULTS.get(name)
        if not pending:
            return []
        due = [e for e in pending if step_of(e) <= through]
        if due:
            _FAULTS[name] = [e for e in pending if step_of(e) > through]
        return due


POISON_KINDS = ("nan_grads", "frozen_ballot", "flipped_ballot")

MEMBERSHIP_KINDS = ("worker_drop", "worker_rejoin")


def parse_membership(spec: str) -> tuple[str, int, int]:
    """Parse one membership spec, ``worker_drop:<w>[:<step>]`` (step 0 by
    default: departed from the first step) or ``worker_rejoin:<w>:<step>``
    (the step is required: rejoining a worker that never left is
    undefined), into ``(kind, worker, step)``. The control plane consumes
    them at the first boundary at or after ``step``."""
    parts = spec.split(":")
    if len(parts) not in (2, 3) or parts[0] not in MEMBERSHIP_KINDS:
        raise ValueError(
            f"bad membership spec {spec!r}: expected '<kind>:<worker>"
            f"[:<step>]' with kind in {MEMBERSHIP_KINDS}")
    if parts[0] == "worker_rejoin" and len(parts) != 3:
        raise ValueError(
            f"bad membership spec {spec!r}: worker_rejoin requires an "
            "explicit step ('worker_rejoin:<worker>:<step>')")
    try:
        worker = int(parts[1])
        step = int(parts[2]) if len(parts) == 3 else 0
    except ValueError:
        raise ValueError(f"bad membership spec {spec!r}: worker/step must "
                         "be integers")
    if worker < 0 or step < 0:
        raise ValueError(f"bad membership spec {spec!r}: worker/step must "
                         "be >= 0")
    return parts[0], worker, step


def parse_membership_specs(specs: str) -> list:
    """Comma-separated membership specs (``--inject_membership``) as the
    ``membership`` fault's list of ``(kind, worker, step)``."""
    return [parse_membership(s.strip())
            for s in specs.split(",") if s.strip()]


SERVE_FAULT_KINDS = ("replica_crash", "replica_kill", "replica_drain",
                     "slow_tick", "replica_rejoin")


def parse_serve_fault(spec: str) -> tuple[str, int, int, int]:
    """Parse one serving-plane fault spec into ``(kind, replica, tick,
    arg)``, the third field always the due tick: ``replica_crash:<r>:<tick>``,
    ``replica_kill:<r>:<tick>``, ``replica_drain:<r>[:<tick>]`` (tick 0 by
    default), ``slow_tick:<r>:<ms>`` (armed from tick 0, ``arg`` the ms)
    and ``replica_rejoin:<r>:<tick>`` (the tick is required)."""
    parts = spec.split(":")
    if len(parts) not in (2, 3) or parts[0] not in SERVE_FAULT_KINDS:
        raise ValueError(
            f"bad serve fault spec {spec!r}: expected '<kind>:<replica>"
            f"[:<tick|ms>]' with kind in {SERVE_FAULT_KINDS}")
    if parts[0] in ("replica_crash", "replica_kill", "slow_tick",
                    "replica_rejoin") and len(parts) != 3:
        raise ValueError(
            f"bad serve fault spec {spec!r}: {parts[0]} requires an "
            f"explicit third field ('{parts[0]}:<replica>:"
            f"{'<ms>' if parts[0] == 'slow_tick' else '<tick>'}')")
    try:
        replica = int(parts[1])
        val = int(parts[2]) if len(parts) == 3 else 0
    except ValueError:
        raise ValueError(f"bad serve fault spec {spec!r}: replica/"
                         "tick/ms must be integers")
    if replica < 0 or val < 0:
        raise ValueError(f"bad serve fault spec {spec!r}: replica/"
                         "tick/ms must be >= 0")
    if parts[0] == "slow_tick":
        return parts[0], replica, 0, val
    return parts[0], replica, val, 0


def parse_serve_specs(specs: str) -> list:
    """Comma-separated serve fault specs as the ``serve`` fault's list of
    ``(kind, replica, tick, arg)``."""
    return [parse_serve_fault(s.strip())
            for s in specs.split(",") if s.strip()]


def parse_poison(spec: str) -> tuple[str, int, int]:
    """Parse a ballot-poisoning spec ``<kind>:<worker>[:<start_step>]``
    (e.g. ``nan_grads:2`` or ``flipped_ballot:0:100``) into the ``(kind,
    worker, start_step)`` tuple the ``ballot_poison`` fault carries."""
    parts = spec.split(":")
    if len(parts) not in (2, 3) or parts[0] not in POISON_KINDS:
        raise ValueError(
            f"bad poison spec {spec!r}: expected '<kind>:<worker>"
            f"[:<start_step>]' with kind in {POISON_KINDS}")
    try:
        worker = int(parts[1])
        start = int(parts[2]) if len(parts) == 3 else 0
    except ValueError:
        raise ValueError(f"bad poison spec {spec!r}: worker/start_step "
                         "must be integers")
    if worker < 0 or start < 0:
        raise ValueError(f"bad poison spec {spec!r}: worker/start_step "
                         "must be >= 0")
    return parts[0], worker, start


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


class PreemptionGuard:
    """Signal-driven preemption flag, checked at every step boundary.

    Installs handlers for ``signals`` (default SIGTERM: what a scheduler's
    preemption and ``timeout`` deliver) that only set a
    :class:`threading.Event`; draining the in-flight save and writing the
    ``preempt``-tagged checkpoint happen on the train loop's thread at the
    next step boundary, where the state is consistent. A second signal
    before that boundary (a hung collective) restores the previous handler
    and delivers the signal again, so the process can still be killed. Off
    the main thread no handler can be installed; the guard is then a flag
    set by :meth:`trigger`. ``journal`` (``train/journal.py``) records
    the ``preempt_drain`` event, with the seconds from the signal to the
    boundary, the first time :meth:`should_stop` sees the flag: on the
    train loop's thread, never in the handler, which must stay
    async-signal-safe."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,), journal=None):
        self._flag = threading.Event()
        self._prev: dict[int, Any] = {}
        self._journal = journal
        self._drain_logged = False
        self.tripped_mono: Optional[float] = None
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # not the main thread
                pass

    def _on_signal(self, signum, frame) -> None:
        if self._flag.is_set():
            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        # async-signal-safe: a clock read and the flag, nothing else
        self.tripped_mono = time.monotonic()
        self._flag.set()

    def trigger(self) -> None:
        """Preempt without a signal (tests; an agent told of maintenance
        through an API)."""
        if self.tripped_mono is None:
            self.tripped_mono = time.monotonic()
        self._flag.set()

    def should_stop(self) -> bool:
        tripped = self._flag.is_set()
        if tripped and not self._drain_logged:
            self._drain_logged = True
            if self._journal is not None:
                latency = (time.monotonic() - self.tripped_mono
                           if self.tripped_mono is not None else 0.0)
                self._journal.event("preempt_drain",
                                    signal_to_boundary_s=round(latency, 6))
        return tripped

    def close(self) -> None:
        """Restore the previous handlers."""
        for sig, prev in self._prev.items():
            try:
                if signal.getsignal(sig) == self._on_signal:
                    signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev.clear()
