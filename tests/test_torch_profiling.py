"""``train/profiling.py`` against the JAX package's ``train/profiling.py``.

Tolerances: exact. ``StepTimer`` from the same clock readings gives JAX's
stats; ``comm_report`` gives JAX's dict for every wire, at
``dcn_pipeline_depth`` 0 and 2; ``StepProfiler`` traces its window (``torch.profiler`` on the
CPU), anchored at the first step it sees past ``start_step`` as a
resumed run reaches it, and writes nothing without a ``trace_dir``.
"""

import json
import time

import pytest
import torch

from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.train import profiling
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.train.profiling import StepProfiler, StepTimer, comm_report


def test_step_timer_equals_jax(monkeypatch):
    from distributed_lion_tpu.train.profiling import StepTimer as JStepTimer

    clock = [0.0, 0.5, 0.75, 1.75, 1.8, 3.0]
    stats = []
    for cls in (StepTimer, JStepTimer):
        readings = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(readings))
        timer = cls(window=3)
        ticks = [timer.tick(), timer.tick(), timer.tick(2), timer.tick(), timer.tick(),
                 timer.tick()]
        stats.append((ticks, timer.stats()))
    assert stats[0] == stats[1]
    assert stats[0][0][0] is None and stats[0][1]["step_time_ema_s"] > 0
    assert StepTimer().stats() == {}


@pytest.mark.parametrize("wire", ["sign_psum", "packed_allgather", "packed_a2a", "hier:2"])
def test_comm_report_equals_jax(wire):
    from distributed_lion_tpu.train.profiling import comm_report as j_comm_report

    for world, kw in ((2, {}), (4, dict(vote_every=4, accum_steps=2)),
                      (8, dict(vote_buckets=4, steps_per_sec=3.5)),
                      (8, dict(vote_buckets=3, dcn_pipeline_depth=2))):
        assert comm_report(124_439_808, world, wire, **kw) == \
            j_comm_report(124_439_808, world, wire, **kw), (world, kw)


def test_trainer_comm_stats_are_comm_report():
    cfg = TrainConfig(wire="packed_a2a", vote_buckets=2, block_size=32, max_steps=1)
    tr = Trainer.for_gpt2(cfg, GPT2Config.tiny(), device="cpu")
    assert tr.comm_stats() == {}  # a world of one: no vote collective
    tr.world = 4
    assert tr.comm_stats(2.0) == comm_report(tr.n_params, 4, "packed_a2a", 2.0,
                                             accum_steps=cfg.gradient_accumulation_steps,
                                             vote_buckets=2)
    tr.close()


def _drive(prof, steps):
    """The trainer's calls: start at the top of a step, stop after it."""
    for step in steps:
        prof.maybe_start(step)
        with prof.annotate(step):
            torch.ones(8).sum()
        prof.maybe_stop(step + 1)


def test_step_profiler_traces_its_window(tmp_path):
    prof = StepProfiler(str(tmp_path), start_step=2, num_steps=2, rank=3)
    _drive(prof, range(6))
    assert prof.trace_path == str(tmp_path / "steps_2_4_rank3.trace.json")
    assert [p.name for p in tmp_path.iterdir()] == ["steps_2_4_rank3.trace.json"]
    names = {e.get("name") for e in json.loads(open(prof.trace_path).read())["traceEvents"]}
    assert {"train_step_2", "train_step_3"} <= names and "train_step_4" not in names


def test_step_profiler_window_of_a_resumed_run(tmp_path):
    prof = StepProfiler(str(tmp_path), start_step=2, num_steps=2)
    _drive(prof, range(5, 9))  # resumed at step 5, past start_step
    assert prof.trace_path.endswith("steps_5_7_rank0.trace.json")


def test_step_profiler_close_and_inactive(tmp_path):
    prof = StepProfiler(str(tmp_path / "a"), start_step=0, num_steps=10)
    _drive(prof, range(3))
    assert prof.active and prof.trace_path is None
    prof.close()  # mid-window: the trace so far is written
    assert not prof.active and prof.trace_path.endswith("steps_0_10_rank0.trace.json")
    off = StepProfiler(None, start_step=0)
    _drive(off, range(3))
    assert not off.active and off.trace_path is None


def test_peak_hbm_is_none_without_a_card():
    per = profiling.peak_hbm_per_device()
    if torch.cuda.is_available():
        assert len(per) == torch.cuda.device_count() and profiling.peak_hbm_gb() == max(per)
    else:
        assert per is None and profiling.peak_hbm_gb() is None
