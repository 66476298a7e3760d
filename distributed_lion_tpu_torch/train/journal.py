"""Run journal: port of ``distributed_lion_tpu/train/journal.py`` (stdlib
only, copied so the port needs nothing of the JAX package), with the same
record schema, so ``scripts/validate_metrics.validate_journal_file`` and
both packages' ``cli/run_analyze.py`` read the port's files unchanged.

A host-side span/event recorder for the training loop:

- **No device syncs.** Every span is host wall time (``time.monotonic``)
  around a host region; no span reads a tensor or synchronizes the card.
  The trainer wraps the one sync it already makes at log cadence in the
  ``device_wait`` span.
- **Strict-JSON JSONL sink with atomic rotation.** One record per line,
  ``allow_nan=False``; a newline-terminated record is the durability unit:
  a crash mid-write tears at most the last line, and reopening the file
  truncates the torn tail (the ``journal_recovered`` event names the
  bytes). Rotation renames the live file to ``journal_rank<r>.<seq>.jsonl``
  by ``os.replace`` and writes a fresh meta record, so every file stands
  alone for the analyzer. One file per rank process.
- **Bounded memory.** A ring buffer (``deque(maxlen)``) keeps the last
  records for crash bundles (``journal_tail.jsonl``).
- **A sink failure does not stop training.** The first ``OSError`` of the
  file sink disables it loudly (stderr); the ring keeps recording. The
  ``journal_torn_write`` fault (``train/resilience.py``) tears a write
  mid-line to exercise the recovery.

Record schema: every record has ``kind`` (meta | span | event | log),
``name``, ``t`` (this process's monotonic seconds) and ``rank``;
``meta``/``journal_start`` adds ``wall`` (``time.time()`` at the same
instant), the anchor the analyzer maps each rank's clock onto one wall
timeline with; ``span`` adds ``dur``. A span with a ``thread`` field
(``"committer"``, the checkpoint commit thread) ran off the step thread and
is left out of step-wall attribution. Extra fields are JSON scalars or flat
lists; a non-finite float is written as ``null`` with its repr under
``<k>_repr``.

Span taxonomy (the name's head, before any ``/``, is the analyzer's
bucket): ``data_wait`` (batch fetch and host-to-device copy), ``dispatch``
(issuing the step's work, and in eager PyTorch every collective the host
blocks on inside it), ``device_wait`` (the log-cadence sync), ``logging_drain``
(metric assembly and the JSONL write), ``ckpt/*`` (checkpoint snapshot and
drain on the step thread).
"""

from __future__ import annotations

import collections
import json
import math
import os
import sys
import threading
import time
from typing import Any, Optional

from distributed_lion_tpu_torch.train import resilience

SCHEMA_VERSION = 1
KINDS = ("meta", "span", "event", "log")
DEFAULT_MAX_BYTES = 32 << 20  # rotate the sink at 32 MiB per file
DEFAULT_RING = 512


def journal_filename(rank: int) -> str:
    return f"journal_rank{rank}.jsonl"


def _safe_fields(fields: dict) -> dict:
    """Strict-JSON view of free-form record fields: non-finite floats become
    ``null`` + ``<k>_repr`` (the MetricsLogger convention); non-scalar
    values are repr'd rather than risking a non-serializable record.
    One-level dicts of scalars flatten to dotted keys (``stats.ticks``) —
    the serve metrics drain emits grouped counters and a nested object
    would otherwise collapse to an unqueryable repr string; deeper
    nesting still falls through to repr."""
    out: dict = {}
    for k, v in fields.items():
        if isinstance(v, float) and not math.isfinite(v):
            out[k] = None
            out[f"{k}_repr"] = repr(v)
        elif v is None or isinstance(v, (str, int, float, bool)):
            out[k] = v
        elif isinstance(v, (list, tuple)) and all(
                e is None or isinstance(e, (str, int, bool))
                or (isinstance(e, float) and math.isfinite(e))
                for e in v):
            # flat scalar lists are valid strict JSON and survive as data
            # (the control plane's mask_before/mask_after fields); anything
            # nested or non-finite still falls through to repr
            out[k] = list(v)
        elif isinstance(v, dict) and all(
                isinstance(kk, str) and (
                    e is None or isinstance(e, (str, int, bool))
                    or (isinstance(e, float) and math.isfinite(e)))
                for kk, e in v.items()):
            for kk, e in v.items():
                out[f"{k}.{kk}"] = e
        else:
            out[k] = repr(v)
    return out


class _SpanCtx:
    """Context manager recording one span on exit (monotonic end time +
    duration). Exceptions propagate; the span still records, flagged
    ``error=True``, so a failing region is visible in the timeline."""

    __slots__ = ("_journal", "_name", "_fields", "_t0")

    def __init__(self, journal: "Journal", name: str, fields: dict):
        self._journal = journal
        self._name = name
        self._fields = fields

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.monotonic()
        return self

    def set(self, **fields) -> None:
        """Attach fields computed INSIDE the span; recorded at exit."""
        self._fields.update(fields)

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.monotonic() - self._t0
        fields = self._fields
        if exc_type is not None:
            fields = {**fields, "error": True}
        self._journal.record({"kind": "span", "name": self._name,
                              "dur": round(dur, 9), **fields})
        return False


class Journal:
    """Thread-safe, rank-stamped span/event recorder (see module doc).

    ``directory=None`` runs ring-only (no file sink) — bench harnesses use
    this to compute an attribution summary without touching disk.
    """

    def __init__(self, directory: Optional[str], rank: int = 0, *,
                 max_bytes: int = DEFAULT_MAX_BYTES, ring: int = DEFAULT_RING):
        self.rank = int(rank)
        self.directory = str(directory) if directory else None
        self.max_bytes = int(max_bytes)
        # RLock, not Lock: rotation runs inside record()'s critical section
        # and re-enters record() to anchor the fresh file's meta record
        self._lock = threading.RLock()
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._fh = None
        self._bytes = 0
        self._rotations = 0
        self._sink_failed = False
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
            self._rotations = self._next_rotation_seq()
            self._open_sink()
        self._write_meta()

    # ------------------------------------------------------------------ sink
    def _path(self) -> str:
        return os.path.join(self.directory, journal_filename(self.rank))

    def _next_rotation_seq(self) -> int:
        stem = journal_filename(self.rank)[:-len(".jsonl")]
        seqs = [0]
        try:
            for name in os.listdir(self.directory):
                if name.startswith(stem + ".") and name.endswith(".jsonl"):
                    mid = name[len(stem) + 1:-len(".jsonl")]
                    if mid.isdigit():
                        seqs.append(int(mid) + 1)
        except OSError:
            pass
        return max(seqs)

    def _open_sink(self) -> None:
        """Open (or re-open) the live file, truncating a torn tail left by
        a crash mid-write: newline-terminated records are the durability
        unit, so everything after the last newline was never committed."""
        path = self._path()
        recovered = 0
        if os.path.exists(path):
            with open(path, "rb") as f:
                raw = f.read()
            if raw and not raw.endswith(b"\n"):
                keep = raw.rfind(b"\n") + 1  # 0 when no newline at all
                recovered = len(raw) - keep
                with open(path, "r+b") as f:
                    f.truncate(keep)
        self._fh = open(path, "a", encoding="utf-8")
        self._bytes = os.path.getsize(path)
        if recovered:
            self.event("journal_recovered", torn_bytes=recovered)

    def _rotate(self) -> None:
        """Atomic rotation: flush + close the live file, ``os.replace`` it
        to its sequence name, open a fresh live file and re-anchor a meta
        record so the new file is independently analyzable."""
        self._fh.flush()
        self._fh.close()
        stem = journal_filename(self.rank)[:-len(".jsonl")]
        os.replace(self._path(), os.path.join(
            self.directory, f"{stem}.{self._rotations}.jsonl"))
        self._rotations += 1
        self._fh = open(self._path(), "a", encoding="utf-8")
        self._bytes = 0
        self._write_meta(rotated=self._rotations)

    def _write_meta(self, **extra) -> None:
        self.record({"kind": "meta", "name": "journal_start",
                     "wall": time.time(), "pid": os.getpid(),
                     "version": SCHEMA_VERSION, **extra})

    # ------------------------------------------------------------- recording
    def record(self, rec: dict) -> None:
        """Append one record (``t``/``rank`` stamped here). Sink I/O errors
        disable the file sink loudly; the ring keeps recording."""
        rec = {"kind": rec.get("kind", "event"),
               "name": str(rec.get("name", "")),
               "t": round(time.monotonic(), 9), "rank": self.rank,
               **_safe_fields({k: v for k, v in rec.items()
                               if k not in ("kind", "name")})}
        with self._lock:
            self._ring.append(rec)
            if self._fh is None or self._sink_failed:
                return
            line = json.dumps(rec, allow_nan=False)
            try:
                if resilience.consume_fault_count("journal_torn_write"):
                    # simulated death mid-write: half the record, no
                    # newline, then the failure surfaces like real I/O
                    self._fh.write(line[:max(len(line) // 2, 1)])
                    self._fh.flush()
                    raise OSError("injected torn journal write")
                self._fh.write(line + "\n")
                self._bytes += len(line) + 1
            except OSError as e:
                self._sink_failed = True
                print(f"[journal] sink write failed ({e}); journal file "
                      "DISABLED for the rest of this run — the in-memory "
                      "ring keeps recording", file=sys.stderr, flush=True)
                return
            if self._bytes >= self.max_bytes:
                try:
                    self._rotate()
                except OSError as e:
                    self._sink_failed = True
                    print(f"[journal] rotation failed ({e}); journal file "
                          "DISABLED for the rest of this run",
                          file=sys.stderr, flush=True)

    def event(self, name: str, **fields) -> None:
        self.record({"kind": "event", "name": name, **fields})

    def span(self, name: str, **fields) -> _SpanCtx:
        """``with journal.span("data_wait", step=n): ...`` — records the
        region's host wall time on exit."""
        return _SpanCtx(self, name, fields)

    def log(self, msg: str, stream: str = "stdout") -> None:
        self.record({"kind": "log", "name": "log", "msg": str(msg),
                     "stream": stream})

    # -------------------------------------------------------------- plumbing
    def tail(self) -> list:
        """The ring buffer's records, oldest first — the crash bundle's
        ``journal_tail.jsonl`` payload."""
        with self._lock:
            return list(self._ring)

    def records(self) -> list:
        """Alias of :meth:`tail` for ring-only journals (bench harnesses
        feed this straight to ``run_analyze.attribute``)."""
        return self.tail()

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None and not self._sink_failed:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    self._fh.close()
                except OSError:
                    pass  # a dead sink at teardown has already been
                    # reported by the write path; close must not mask the
                    # run's real exit status
                self._fh = None


class _NullJournal:
    """No-op stand-in with the full :class:`Journal` surface, so call sites
    never branch on whether journaling is enabled."""

    rank = 0
    directory = None

    def record(self, rec: dict) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass

    def span(self, name: str, **fields) -> "_NullSpan":
        return _NULL_SPAN

    def log(self, msg: str, stream: str = "stdout") -> None:
        pass

    def tail(self) -> list:
        return []

    records = tail

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class _NullSpan:
    def __enter__(self):
        return self

    def set(self, **fields):
        pass

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()
NULL = _NullJournal()

# ---------------------------------------------------------------- the emitter
# The stdout/stderr emitter of the train/ and data/ modules: a message goes
# to the console as before AND into the active journal as a `log` record.
_ACTIVE: Optional[Journal] = None


def install(journal: Journal) -> None:
    """Make ``journal`` the process's active journal — module-level
    ``emit``/``event`` route to it. Latest install wins (one Trainer at a
    time owns the stream; tests create/tear down many)."""
    global _ACTIVE
    _ACTIVE = journal


def uninstall(journal: Journal) -> None:
    """Release the active slot if ``journal`` still owns it."""
    global _ACTIVE
    if _ACTIVE is journal:
        _ACTIVE = None


def active() -> Any:
    return _ACTIVE if _ACTIVE is not None else NULL


def emit(msg: str, *, stderr: bool = False, record: bool = True,
         echo: bool = True) -> None:
    """Print ``msg`` (stdout by default, flushed) and record it in the
    active journal. ``record=False`` is for streams that already have their
    own durable sink (the MetricsLogger console line: its record IS
    metrics.jsonl). ``echo=False`` records without printing: a trainer
    rank other than 0 journals what rank 0 prints."""
    if echo:
        print(msg, file=sys.stderr if stderr else sys.stdout, flush=True)
    if record and _ACTIVE is not None:
        _ACTIVE.log(msg, stream="stderr" if stderr else "stdout")


def event(name: str, **fields) -> None:
    """Record an event into the active journal (no console output) — for
    modules that don't hold a journal reference (data/native_loader's
    shard-retry counters)."""
    if _ACTIVE is not None:
        _ACTIVE.event(name, **fields)
