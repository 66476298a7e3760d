"""Preemption (``--on_preempt save_exit``, the default) and the poison
parser, port against the JAX package (tests/test_resilience.py).

Tolerances: exact. A SIGTERM delivered while the data iterator fetches
batch 3 leaves a committed checkpoint tagged ``preempt``; a fresh trainer
resumes from it and ends ``torch.equal`` (params, momentum, losses) to an
uninterrupted run: at W = 1, where the run stops at step 3 as the JAX
trainer does, and at W = 2 (gloo), where only rank 1 gets the signal and
both ranks stop at step 4, the boundary after the one at which their flags
went out. ``run_clm`` returns after the preemption's checkpoint, before its
eval and its final save. ``off`` installs nothing; a second SIGTERM before
a step boundary goes to the previous handler; ``--on_preempt`` is
validated; ``parse_poison`` agrees with JAX's on good and bad specs.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.cli import run_clm
from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.parallel.mesh import data_grid
from distributed_lion_tpu_torch.train import resilience
from distributed_lion_tpu_torch.train.checkpoint import Checkpointer
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer

BLOCKS = synthetic_lm_dataset(64, 32, 256, seed=1)
STEPS = 6


def _cfg(out, **kw):
    base = dict(lion=True, async_grad=True, learning_rate=1e-3, warmup_steps=1,
                max_steps=STEPS, per_device_train_batch_size=2, gradient_accumulation_steps=1,
                block_size=32, logging_steps=1, save_steps=100, output_dir=out, seed=5)
    base.update(kw)
    return TrainConfig(**base)


def _trainer(cfg, group=None):
    return Trainer.for_gpt2(cfg, GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.1),
                            device="cpu", grid=data_grid(group))


class SignallingIter:
    """Delivers a real SIGTERM while fetching batch ``at`` (1-based)."""

    def __init__(self, inner, at):
        self.inner, self.n, self.at = inner, 0, at

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        if self.n == self.at:
            signal.raise_signal(signal.SIGTERM)
        return next(self.inner)

    def skip(self, k):
        self.inner.skip(k)


def _losses(hist):
    return [h["loss"] for h in hist if "loss" in h]


def _preempt_and_resume(out, group=None, signal_at=3):
    """Uninterrupted, then preempted + resumed: (reference trainer, its
    losses, preempted trainer, its losses, resumed trainer, its losses)."""
    ref = _trainer(_cfg(None), group)
    ref_losses = _losses(ref.train(batch_iterator(BLOCKS, ref.global_train_batch(), seed=5)))
    ref.close()
    t1 = _trainer(_cfg(out), group)
    it = batch_iterator(BLOCKS, t1.global_train_batch(), seed=5)
    l1 = _losses(t1.train(SignallingIter(it, signal_at) if signal_at else it))
    t1.close()
    t2 = _trainer(_cfg(out), group)
    l2 = _losses(t2.train(batch_iterator(BLOCKS, t2.global_train_batch(), seed=5)))
    t2.close()
    return ref, ref_losses, t1, l1, t2, l2


def _assert_equal_to_uninterrupted(ref, ref_losses, t1, l1, t2, l2, stop):
    assert t1.preempted and t1.step_count == stop
    assert not t2.preempted and t2.step_count == STEPS
    assert l1 + l2 == ref_losses
    assert torch.equal(t2.flat.params, ref.flat.params)
    assert torch.equal(t2.state.exp_avg, ref.state.exp_avg)


def test_save_exit_resumes_equal_to_uninterrupted(tmp_path):
    out = str(tmp_path / "run")
    ref, ref_losses, t1, l1, t2, l2 = _preempt_and_resume(out)
    _assert_equal_to_uninterrupted(ref, ref_losses, t1, l1, t2, l2, stop=3)
    ck = Checkpointer(os.path.join(out, "checkpoints"))
    assert resilience.latest_valid_step_in(ck.directory) == 3  # drained and committed
    assert ck.manifest_meta(3)["tag"] == "preempt"
    ck.close()


def _work(rank, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/pg", rank=rank, world_size=2)
    try:
        ref, ref_losses, t1, l1, t2, l2 = _preempt_and_resume(
            f"{out}/run", dist.group.WORLD, signal_at=3 if rank == 1 else 0)
        ck = Checkpointer(f"{out}/run/checkpoints")
        meta = ck.manifest_meta(t1.step_count)
        ck.close()
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump({"preempted": t1.preempted, "stop": t1.step_count, "tag": meta["tag"],
                       "resumed": t2.step_count, "losses": l1 + l2, "ref_losses": ref_losses,
                       "params": torch.equal(t2.flat.params, ref.flat.params),
                       "momentum": torch.equal(t2.state.exp_avg, ref.state.exp_avg)}, f)
    finally:
        dist.destroy_process_group()


def test_save_exit_at_two_ranks_stops_every_rank_on_one_step(tmp_path):
    mp.spawn(_work, args=(str(tmp_path),), nprocs=2, join=True)
    for r in range(2):
        rec = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert rec["preempted"] and rec["stop"] == 4 and rec["tag"] == "preempt", rec
        assert rec["resumed"] == STEPS and rec["losses"] == rec["ref_losses"]
        assert rec["params"] and rec["momentum"]


def test_run_clm_returns_after_the_preemption_checkpoint(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "run")

    def signalling(blocks, batch, seed):
        return SignallingIter(batch_iterator(blocks, batch, seed=seed), 2)

    monkeypatch.setattr(run_clm, "batch_iterator", signalling)
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    tr = run_clm.main(["--model_name", "tiny", "--dataset", "synthetic", "--synthetic_blocks",
                       "64", "--block_size", "32", "--per_device_train_batch_size", "2",
                       "--gradient_accumulation_steps", "1", "--max_steps", "5",
                       "--logging_steps", "1", "--output_dir", out])
    assert tr.preempted and tr.step_count == 2
    assert "[run_clm] preempted: checkpoint durable, exiting cleanly" in capsys.readouterr().out
    ck = Checkpointer(os.path.join(out, "checkpoints"))
    assert ck.all_steps() == [2] and ck.manifest_meta(2)["tag"] == "preempt"
    ck.close()
    assert not os.path.exists(os.path.join(out, "model.npz"))  # no final save
    assert signal.getsignal(signal.SIGTERM) is not tr._preempt._on_signal  # closed


def test_on_preempt_off_ignores_sigterm():
    prev = signal.signal(signal.SIGTERM, lambda *a: None)
    try:
        t = _trainer(_cfg(None, max_steps=3, on_preempt="off"))
        assert t._preempt is None
        t.train(SignallingIter(batch_iterator(BLOCKS, t.global_train_batch(), seed=5), 2))
        assert t.step_count == 3 and not t.preempted
        t.close()
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_on_preempt_validated():
    with pytest.raises(ValueError, match="on_preempt"):
        _trainer(_cfg(None, on_preempt="panic"))


def test_second_sigterm_escalates():
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda *a: hits.append("prev"))
    try:
        guard = resilience.PreemptionGuard()
        signal.raise_signal(signal.SIGTERM)
        assert guard.should_stop() and hits == []  # first: absorbed
        signal.raise_signal(signal.SIGTERM)
        assert hits == ["prev"]  # second: handed to the handler before it
        assert signal.getsignal(signal.SIGTERM) is not guard._on_signal
        guard.close()
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_trigger_off_the_main_thread():
    import threading

    made = []
    th = threading.Thread(target=lambda: made.append(resilience.PreemptionGuard()))
    th.start()
    th.join()
    guard = made[0]
    assert not guard.should_stop() and guard._prev == {}  # nothing installed
    guard.trigger()
    assert guard.should_stop() and guard.tripped_mono is not None


@pytest.mark.parametrize("spec", ["nan_grads:2", "flipped_ballot:0:100", "frozen_ballot:3:0",
                                  "bad_kind:1", "nan_grads:x", "nan_grads", "nan_grads:1:2:3",
                                  "nan_grads:-1", "frozen_ballot:1:-4"])
def test_parse_poison_equals_jax(spec):
    from distributed_lion_tpu.train import resilience as j_resilience

    got = []
    for parse in (resilience.parse_poison, j_resilience.parse_poison):
        try:
            got.append(parse(spec))
        except ValueError as e:
            got.append(("ValueError", str(e)))
    assert got[0] == got[1]
    assert resilience.POISON_KINDS == j_resilience.POISON_KINDS


def test_consume_due_equals_jax():
    from distributed_lion_tpu.train import resilience as j_resilience

    sched = [("worker_drop", 1, 2), ("worker_rejoin", 1, 5), ("worker_drop", 2, 9)]
    got = []
    for mod in (resilience, j_resilience):
        mod.inject_fault("membership", list(sched))
        got.append([mod.consume_due("membership", t) for t in (1, 5, 5, 10)])
        mod.clear_faults()
    assert got[0] == got[1] == [[], sched[:2], [], sched[2:]]
    assert np.array_equal(got[0][1], sched[:2])
