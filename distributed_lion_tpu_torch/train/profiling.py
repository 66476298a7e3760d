"""Tracing and step timing for the train loop: port of
``distributed_lion_tpu/train/profiling.py``.

- :class:`StepProfiler` captures a ``torch.profiler`` trace of a window of
  steps (CPU activity, and the card's kernels when the trainer runs on
  one) and exports it as a Chrome trace into ``trace_dir``; a bounded
  window keeps the file small and the traced steps representative. Its
  notice goes through ``train.journal.emit``, so the run journal has it.
- :class:`StepTimer`: a wall-clock EMA of the step cadence with p50/p95
  over a sliding window, always on (no device sync).
- :func:`peak_hbm_per_device` / :func:`peak_hbm_gb`: the device memory
  high-water mark (``torch.cuda.max_memory_allocated``) of each local card.
- :func:`comm_report`: the vote collective's analytic wire bytes
  (``ops.codec.wire_bytes_per_param``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from distributed_lion_tpu_torch.ops.codec import wire_bytes_per_param
from distributed_lion_tpu_torch.train.journal import emit


class StepProfiler:
    """Trace steps ``[start_step, start_step + num_steps)`` into
    ``trace_dir``; inactive when ``trace_dir`` is None. The window opens at
    the first step ``>= start_step`` the loop reaches, so a resumed run
    still captures one. ``cuda`` records the card's activity too; the
    device is synchronized before the trace stops. The file names the
    window and ``rank``, so the ranks of a run share a directory."""

    def __init__(self, trace_dir: Optional[str], start_step: int = 10,
                 num_steps: int = 3, cuda: bool = False, rank: int = 0):
        self.trace_dir = trace_dir
        self.rank = rank
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self.stop_step = self.start_step + self.num_steps
        self.cuda = cuda
        self.trace_path: Optional[str] = None
        self._prof = None
        self._done = False

    @property
    def active(self) -> bool:
        return self._prof is not None

    def maybe_start(self, step: int) -> None:
        if self.trace_dir and not self.active and not self._done and step >= self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self.start_step = step
            self.stop_step = step + self.num_steps

    def annotate(self, step: int):
        """A ``record_function`` span named for the step while tracing."""
        if self.active:
            return torch.profiler.record_function(f"train_step_{step}")
        return contextlib.nullcontext()

    def maybe_stop(self, step: int) -> None:
        """Stop at the window's end and export the trace."""
        if self.active and step >= self.stop_step:
            if self.cuda:
                torch.cuda.synchronize()
            self._prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            self.trace_path = os.path.join(
                self.trace_dir,
                f"steps_{self.start_step}_{self.stop_step}_rank{self.rank}.trace.json")
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None
            self._done = True
            emit(f"[profiler] trace for steps [{self.start_step}, {self.stop_step}) written "
                 f"to {self.trace_path}")

    def close(self) -> None:
        if self.active:
            self.maybe_stop(self.stop_step)


class StepTimer:
    """Step-latency stats from step timestamps: EMA + p50/p95 over a
    sliding window."""

    def __init__(self, ema_alpha: float = 0.1, window: int = 256):
        self.alpha = ema_alpha
        self.window = window
        self._samples: collections.deque[float] = collections.deque(maxlen=window)
        self.ema: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self, n_steps: int = 1) -> Optional[float]:
        """Call once per dispatch covering ``n_steps`` optimizer steps;
        returns the per-step latency (None on the first call)."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return None
        dt = (now - self._last) / max(n_steps, 1)
        self._last = now
        self.ema = dt if self.ema is None else self.alpha * dt + (1 - self.alpha) * self.ema
        self._samples.append(dt)
        return dt

    def stats(self) -> dict:
        if not self._samples:
            return {}
        arr = np.asarray(self._samples)
        return {
            "step_time_ema_s": float(self.ema),
            "step_time_p50_s": float(np.percentile(arr, 50)),
            "step_time_p95_s": float(np.percentile(arr, 95)),
        }


def peak_hbm_per_device() -> Optional[list[float]]:
    """The device memory high-water mark in GiB of every local card, or
    None without one."""
    if not torch.cuda.is_available():
        return None
    return [round(torch.cuda.max_memory_allocated(i) / 2**30, 3)
            for i in range(torch.cuda.device_count())] or None


def peak_hbm_gb() -> Optional[float]:
    """The high-water mark across all local cards."""
    per = peak_hbm_per_device()
    return max(per) if per else None


def comm_report(num_params: int, world: int, wire: str,
                steps_per_sec: Optional[float] = None,
                vote_every: int = 1, accum_steps: int = 1,
                vote_buckets: int = 1, dcn_pipeline_depth: int = 0) -> dict:
    """The vote collective's wire accounting, the JAX package's keys, and
    its rate when ``steps_per_sec`` is known. ``comm_overlap_frac`` is the
    analytic share of the wire that bucketing lets ride behind the previous
    bucket's apply; on the hier wire ``dcn_overlap_frac`` the share of the
    cross-group leg's latency the DCN pipeline takes off the step."""
    acct = wire_bytes_per_param(num_params, world, wire, vote_every=vote_every,
                                accum_steps=accum_steps, vote_buckets=vote_buckets,
                                dcn_pipeline_depth=dcn_pipeline_depth)
    out = {
        "wire": acct["wire"],
        "comm_bytes_per_step": acct["bytes_per_step"],
        "comm_bits_per_param": acct["bits_per_param"],
        "comm_bits_per_param_per_microbatch": acct["bits_per_param_per_microbatch"],
        "vote_buckets": acct["vote_buckets"],
        "comm_overlap_frac": acct["overlappable_wire_frac"],
        "vs_bf16_allreduce": acct["vs_bf16_allreduce"],
        "vs_reference_wire": acct["bytes_per_step"] / max(acct["reference_bytes_per_step"], 1),
    }
    if "dcn_bytes_per_step" in acct:  # hier wire: the cross-group leg alone
        out["comm_dcn_bytes_per_step"] = acct["dcn_bytes_per_step"]
        out["comm_dcn_bits_per_param"] = acct["dcn_bits_per_param"]
        out["dcn_pipeline_depth"] = acct["dcn_pipeline_depth"]
        out["dcn_overlap_frac"] = acct["dcn_overlap_frac"]
    if steps_per_sec:
        out["comm_mbytes_per_sec"] = acct["bytes_per_step"] * steps_per_sec / 1e6
    return out
