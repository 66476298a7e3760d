"""Checkpoint save and restore: port of ``distributed_lion_tpu/train/checkpoint.py``, without Orbax.

A checkpoint is a step directory ``<root>/<step>/`` of files, each a
``torch.save`` of CPU tensors (and plain ints, strings and lists), read back
with ``torch.load(..., weights_only=True)``; bfloat16 round-trips bit for
bit. Each rank writes its own files (the trainer: every rank its momentum,
rank 0 the params and counters), so no rank gathers the others' state.
The on-disk contract is ``train/resilience.py``'s, which is the JAX
package's: once every file of a step is final, rank 0 writes
``manifest.json`` (sha256 and size of every file, plus the caller's
metadata) and then the ``COMMITTED`` marker, each by a temporary file and a
rename.

- **Async saves** (``async_save=True``): :meth:`save` copies the payload
  into this checkpointer's own host buffers (pinned for CUDA tensors; the
  copy's stream is synchronised) before it returns, so the next step may
  update the live buffers in place; one commit thread
  (``ThreadPoolExecutor(max_workers=1)``) writes the files and commits,
  behind the following steps, with no later save needed. The next save
  boundary, :meth:`finalize` and :meth:`close` drain it and raise what it
  raised. :meth:`pop_stall_s` reports the seconds the calling thread was
  blocked (the ``ckpt_stall_s`` metric).
- **Across ranks**: a step commits only after every rank's files are
  final. At a world of one the commit thread commits right after its own
  write. At W > 1 with async saves, every rank builds one more process
  group at construction, a gloo group of the same ranks that only the
  commit thread uses (``collectives.side_group``, which only the members
  build, in the same order on each). After its own write each rank's commit thread joins a MIN
  ``all_reduce`` of "my files are final" on that group, and rank 0 then
  commits, or raises if a peer's write failed. No collective runs on the
  main thread's group from the commit thread, and a gloo collective
  touches no device stream, so it cannot interleave with the main thread's
  NCCL work. The group's timeout (``commit_timeout_s``) bounds the wait
  for a peer that never arrives: the collective raises on the commit
  thread and the drain reports it. This design was taken over per-rank
  marker files polled on the shared root because a collective needs no
  polling interval and cleans nothing up. Synchronous saves at W > 1 join
  one ``dist.barrier()`` on the main thread before rank 0 commits. Every
  rank's files must land in one directory tree: on more than one node the
  root must be a shared filesystem, as the JAX package assumes.
- **Verified autodetect**: :meth:`valid_steps` re-hashes the candidates
  newest first; a step without its marker is rejected once the root holds
  the ``MANIFESTS_ENABLED`` stamp, and grandfathered before it.
- **Retry and backoff** around each write; **rotation** to
  ``save_total_limit`` committed steps.
- **Journal spans** (``journal``, ``train/journal.py``): on the calling
  thread ``ckpt/serialize`` (the host snapshot, and a synchronous save's
  write and commit) and ``ckpt/drain`` (waiting for an in-flight save), the
  same blocked time ``pop_stall_s`` counts; on the commit thread
  ``ckpt/write``, ``ckpt/peers`` (the W > 1 agreement), ``ckpt/digest`` and
  ``ckpt/commit_marker``, stamped ``thread="committer"`` (they overlap the
  steps, and the analyzer leaves them out of the step wall).
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import time
from datetime import timedelta
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.parallel.collectives import side_group, world_of
from distributed_lion_tpu_torch.parallel.mesh import rank_of
from distributed_lion_tpu_torch.train import journal as run_journal
from distributed_lion_tpu_torch.train import resilience
from distributed_lion_tpu_torch.train.journal import emit
from distributed_lion_tpu_torch.train.resilience import (  # noqa: F401  (the API surface)
    MANIFEST,
    MANIFEST_FORMAT,
    MANIFESTS_STAMP,
    MARKER,
    latest_valid_step_in,
    read_manifest,
    sha256_file,
    step_numbers,
    verify_step_dir,
)


def _atomic_write(path: pathlib.Path, data: bytes) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def write_manifest(sdir: pathlib.Path, step: int, meta: Optional[dict] = None) -> str:
    """Digest every data file under a final step directory into
    ``manifest.json``; returns the manifest's own sha256 (recorded in the
    commit marker)."""
    files = {}
    for p in sorted(sdir.rglob("*")):
        if p.is_file() and p.name not in (MANIFEST, MARKER):
            files[str(p.relative_to(sdir))] = {"sha256": sha256_file(p),
                                               "bytes": p.stat().st_size}
    raw = json.dumps({"format": MANIFEST_FORMAT, "step": int(step), "files": files,
                      "meta": meta or {}}, sort_keys=True, allow_nan=False).encode()
    _atomic_write(sdir / MANIFEST, raw)
    return hashlib.sha256(raw).hexdigest()


class Checkpointer:
    """Save, commit, verify and restore step directories under
    ``directory``; ``group`` is the ranks that save together (None: one).
    Every rank of the default group constructs it at W > 1 with
    ``async_save``: the commit thread's group is made here."""

    def __init__(self, directory: str | pathlib.Path, save_total_limit: Optional[int] = None, *,
                 async_save: bool = False, integrity: bool = True, max_retries: int = 3,
                 retry_backoff_s: float = 0.1, group=None, commit_timeout_s: float = 1800.0,
                 journal=None):
        self._journal = journal if journal is not None else run_journal.NULL
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_total_limit = save_total_limit
        self.integrity = integrity
        self.async_save = async_save
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.group = group
        self.rank, self.world = rank_of(group), world_of(group)
        if integrity and self.rank == 0:
            stamp = self.directory / MANIFESTS_STAMP
            # stamping turns 'no marker' from legacy-good into torn-reject,
            # so it happens only when no existing step lacks a marker
            legacy = any(not (self.directory / str(s) / MARKER).exists()
                         for s in step_numbers(self.directory))
            if not stamp.exists() and not legacy:
                _atomic_write(stamp, b"1\n")
        self._executor = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-commit")
                          if async_save else None)
        self._inflight: list[tuple[int, Future]] = []
        # the commit thread's own group: a gloo collective off the main
        # thread's group, bounded by the timeout (module doc)
        self._commit_group = (
            side_group(group or dist.group.WORLD, timedelta(seconds=commit_timeout_s))
            if async_save and self.world > 1 else None)
        self._host: dict[str, torch.Tensor] = {}
        steps = step_numbers(self.directory)
        self._latest: Optional[int] = steps[0] if steps else None
        self.total_stall_s = 0.0
        self.last_stall_s = 0.0
        self._unread_stall_s = 0.0
        self.last_commit_s: Optional[float] = None  # the last commit's manifest + marker

    # ----------------------------------------------------------------- save
    def save(self, step: int, files: dict[str, Any], meta: Optional[dict] = None) -> None:
        """Save this rank's ``files`` (relative path → a tensor, or a dict or
        list of tensors and plain values) as step ``step``. Returns once the
        tensors are copied to host buffers of its own: with ``async_save``
        the write and the commit run behind the following steps."""
        t0 = time.monotonic()
        drained = 0.0
        try:
            try:
                drained = self._drain()
            except Exception:
                drained = time.monotonic() - t0
                raise
            with self._journal.span("ckpt/serialize", step=int(step)):
                host = self._snapshot(files)
                self._latest = int(step)
                if self._executor is not None:
                    self._inflight.append(
                        (step, self._executor.submit(self._write_and_commit, step, host, meta)))
                else:
                    self._write(step, host)
                    if self.world > 1:
                        dist.barrier(group=self.group)  # every rank's files are final
                    self._commit(step, meta)
        finally:
            self._add_stall(max(time.monotonic() - t0 - drained, 0.0))

    def _snapshot(self, files: dict[str, Any]) -> dict[str, Any]:
        """``files`` with every tensor copied into a host buffer of this
        checkpointer's (one per tensor, reused across saves: the drain that
        opens :meth:`save` has released it), the copies complete."""
        streams = set()

        def copy(key: str, t: torch.Tensor) -> torch.Tensor:
            t = t.detach()
            buf = self._host.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
                self._host[key] = buf
            buf.copy_(t, non_blocking=t.is_cuda)
            if t.is_cuda:
                streams.add(torch.cuda.current_stream(t.device))
            return buf

        def walk(key: str, obj):
            if isinstance(obj, torch.Tensor):
                return copy(key, obj)
            if isinstance(obj, dict):
                return {k: walk(f"{key}/{k}", v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(walk(f"{key}/{i}", v) for i, v in enumerate(obj))
            return obj

        out = {rel: walk(rel, obj) for rel, obj in files.items()}
        for stream in streams:
            stream.synchronize()
        return out

    def _write_and_commit(self, step: int, host: dict[str, Any], meta) -> Optional[int]:
        """The commit thread's work: this rank's files, then, at W > 1, the
        MIN ``all_reduce`` of every rank's success on the commit group, then
        rank 0's commit."""
        if self._commit_group is None:
            self._write(step, host)
            return self._commit(step, meta)
        ok = torch.ones(1, dtype=torch.int32)
        try:
            self._write(step, host)
        except Exception:
            ok.zero_()  # tell the peers, then raise this rank's own error
            dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=self._commit_group)
            raise
        with self._journal.span("ckpt/peers", step=int(step), thread="committer"):
            dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=self._commit_group)
        if not int(ok):
            raise RuntimeError(f"checkpoint step {step}: another rank's write failed; the step "
                               "is not committed")
        return self._commit(step, meta)

    def _write(self, step: int, host: dict[str, Any]) -> None:
        """Write each file by a temporary file and a rename, with the retry
        and backoff budget around the whole set."""
        sdir = self._step_dir(step)
        delay = self.retry_backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                if resilience.consume_fault_count("ckpt_save_raise"):
                    raise OSError("injected save fault")
                with self._journal.span("ckpt/write", step=int(step), thread="committer"):
                    for rel, obj in host.items():
                        path = sdir / rel
                        path.parent.mkdir(parents=True, exist_ok=True)
                        tmp = path.with_name(path.name + ".tmp")
                        torch.save(obj, tmp)
                        os.replace(tmp, path)
                return
            except Exception as e:
                if attempt == self.max_retries:
                    try:
                        wrapped = type(e)(f"checkpoint save(step={step}) under {self.directory} "
                                          f"failed after {attempt + 1} attempts: {e}")
                    except Exception:
                        raise e
                    raise wrapped from e
                emit(f"[ckpt] save({step}) attempt {attempt + 1} failed ({e}); retrying in "
                     f"{delay:.2f}s", stderr=True)
                time.sleep(delay)
                delay *= 2

    def _commit(self, step: int, meta: Optional[dict]) -> Optional[int]:
        """Manifest, then marker (its presence is the commit), then
        rotation; rank 0 only does the writing."""
        t0 = time.monotonic()
        slow = resilience.fault("ckpt_slow_commit")
        if slow:
            time.sleep(float(slow))
        if self.rank != 0:
            return step
        if self.integrity:
            if resilience.fault("ckpt_crash_before_manifest"):
                return None  # a death after the data files, before the commit
            sdir = self._step_dir(step)
            with self._journal.span("ckpt/digest", step=int(step), thread="committer"):
                digest = write_manifest(sdir, step, meta)
            if resilience.fault("ckpt_crash_before_marker"):
                return None
            with self._journal.span("ckpt/commit_marker", step=int(step), thread="committer"):
                _atomic_write(sdir / MARKER, json.dumps(
                    {"manifest_sha256": digest, "step": int(step),
                     "committed_at_unix": time.time()}, allow_nan=False).encode())
        self._rotate(step)
        self.last_commit_s = time.monotonic() - t0
        return step

    def _rotate(self, step: int) -> None:
        """Keep the newest ``save_total_limit`` committed steps up to
        ``step``; delete every step directory older than the oldest kept."""
        if not self.save_total_limit:
            return
        done = [s for s in step_numbers(self.directory) if s <= step
                and (not self.integrity or (self._step_dir(s) / MARKER).exists())]
        keep = done[: self.save_total_limit]
        if len(keep) < self.save_total_limit:
            return
        for s in step_numbers(self.directory):
            if s < keep[-1]:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _drain(self) -> float:
        """Wait for this rank's in-flight writes and commits; raises a
        failure of the commit thread. Returns the seconds this blocked."""
        if not self._inflight:
            return 0.0
        t0 = time.monotonic()
        try:
            while self._inflight:
                step, fut = self._inflight.pop(0)
                try:
                    with self._journal.span("ckpt/drain", step=int(step)):
                        fut.result()
                except Exception as e:
                    raise RuntimeError(
                        f"checkpoint write or commit for step {step} under "
                        f"{self._step_dir(step)} failed on the commit thread; that checkpoint "
                        "was never committed and will not be resumed from") from e
        finally:
            dt = time.monotonic() - t0
            self._add_stall(dt)
        return dt

    def finalize(self) -> float:
        """Drain every in-flight save and commit it; returns the seconds this
        blocked. A failure on the commit thread is raised here."""
        return self._drain()

    def _add_stall(self, dt: float) -> None:
        self.total_stall_s += dt
        self.last_stall_s = dt
        self._unread_stall_s += dt

    def pop_stall_s(self) -> float:
        """Seconds blocked on checkpointing since the last pop."""
        out, self._unread_stall_s = self._unread_stall_s, 0.0
        return out

    # ------------------------------------------------------------- discovery
    def _step_dir(self, step: int) -> pathlib.Path:
        return self.directory / str(step)

    def all_steps(self) -> list[int]:
        """Every step directory, oldest first."""
        return sorted(step_numbers(self.directory))

    def latest_step(self) -> Optional[int]:
        """The newest step saved (or found at construction), unverified;
        used only to skip saving one step twice."""
        return self._latest

    def valid_steps(self) -> list[int]:
        """Committed and verified steps, newest first; in an unstamped root
        a step without a marker is grandfathered."""
        steps = step_numbers(self.directory)
        if not self.integrity:
            return steps
        stamped = (self.directory / MANIFESTS_STAMP).exists()
        out = []
        for s in steps:
            sdir = self._step_dir(s)
            if verify_step_dir(sdir):
                out.append(s)
            elif not stamped and resilience.read_json(sdir / MARKER) is None:
                out.append(s)
        return out

    def latest_valid_step(self) -> Optional[int]:
        steps = self.valid_steps()
        return steps[0] if steps else None

    def purge_steps_after(self, step: int) -> list[int]:
        """Delete every step newer than the resumed one (hash-valid ones
        too: the replay re-creates them); raises if any stays. Every rank
        calls it, rank 0 deletes, and no rank goes on before it has."""
        purged, failures = [], []
        for s in self.all_steps() if self.rank == 0 else []:
            if s > step:
                try:
                    shutil.rmtree(self._step_dir(s))
                except Exception as e:
                    failures.append((s, e))
                    continue
                purged.append(s)
        self._latest = step
        if self.world > 1:
            dist.barrier(group=self.group)
        if failures:
            detail = "; ".join(f"step {s} ({self._step_dir(s)}): {e}" for s, e in failures)
            raise RuntimeError(
                f"could not purge stale checkpoint step(s) {[s for s, _ in failures]} newer "
                f"than the resumed step {step}: {detail}") from failures[0][1]
        return purged

    def manifest_meta(self, step: int) -> Optional[dict]:
        """The caller metadata recorded at commit (world size, tag, ...)."""
        manifest = read_manifest(self._step_dir(step))
        return manifest.get("meta") if manifest else None

    # --------------------------------------------------------------- restore
    def restore(self, step: int, rel: str, map_location=None) -> Any:
        """One file of step ``step``, loaded with ``weights_only=True``."""
        return torch.load(self._step_dir(step) / rel, weights_only=True,
                          map_location=map_location)

    def exists(self, step: int, rel: str) -> bool:
        return (self._step_dir(step) / rel).is_file()

    def close(self) -> None:
        try:
            self.finalize()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None
