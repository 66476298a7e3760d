"""The membership control plane, port against the JAX package
(tests/test_control_plane.py).

Tolerances: the plane's states, masks, events, reports and journal records
are exact; a trainer's transitions land on the JAX trainer's steps and its
losses are held within 1e-5 of the JAX trainer's on the same init and
batches (the bound of tests/test_torch_vote_guard.py's trainer comparison);
the post-rejoin tail is held within JAX's ``REJOIN_PARITY_BOUND_NATS`` of a
clean run; everything else of the port against itself is ``torch.equal``.

- **parsers**: ``parse_membership*`` and ``parse_serve*`` equal JAX's on the
  same strings and raise where JAX raises;
- **the plane** (:class:`ControlPlane`) boundary by boundary against JAX's
  on the same seeded observation streams and schedules: lifecycles, masks,
  events, reports, summaries, the journal records and the fault registry,
  over the cases of JAX ``tests/test_control_plane.py:81-276``;
- **the trainer at W = 4** (one spawn of four gloo ranks, the ``ranks``
  fixture): worker 2 dropped at step 3 and rejoined at 9 against the JAX
  trainer on a ``data=4`` mesh, the four ranks' lifecycles and masks equal
  at every boundary, the heal equal to the healthy mean, journal on and
  off ``torch.equal``, the four journals read by both analyzers; a drop at
  step 0 ``torch.equal`` to a run masked from scratch; a crash and resume
  mid-degradation, and a resume after a consumed rejoin, ``torch.equal`` to
  the uninterrupted run; the plane toggled across a resume; the quorum
  refusal; strict-JSON metrics;
- the trainer's flag rules and the CLIs' flags.

The spawn also runs the wire-ledger cases of ``tests/test_torch_wire_ledger.py``
and the W = 4 cases of ``tests/test_torch_dcn_pipeline.py`` and
``tests/test_torch_zero.py``, and the JAX trainer's journal of the pin is read by
``tests/test_torch_run_analyze.py``: :func:`shared_run` runs each once per
test session, whichever module (or xdist worker) asks first, under a file
lock. jax is imported inside the tests only, so the spawned ranks import
torch alone.
"""

import dataclasses
import fcntl
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import distributed_lion_tpu_torch.train.loop as loop_module
from distributed_lion_tpu_torch.cli import run_analyze, run_clm, run_dpo, run_sft
from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.parallel.mesh import data_grid
from distributed_lion_tpu_torch.train import control_plane, resilience
from distributed_lion_tpu_torch.train.control_plane import ControlPlane
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.train.vote_guard import VoteGuard
from distributed_lion_tpu_torch.utils.argparsing import build_parser
from distributed_lion_tpu_torch.utils.serialization import params_from_jax, save_pytree

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TINY = dict(compute_dtype=torch.float32, dropout=0.0)
# the drop/rejoin pin: worker 2 leaves at step 3 and rejoins at 9, on
# probation for 4 steps (healthy at 13)
PIN = dict(control_plane=True, rejoin_probe_steps=4,
           inject_membership="worker_drop:2:3,worker_rejoin:2:9")
PIN_STEPS = 16
TAIL = 6
REJOIN_PARITY_BOUND_NATS = 0.35  # JAX tests/test_control_plane.py's pre-registered bound
MEMBERSHIP_FLAGS = ("journal", "journal_dir", "control_plane", "rejoin_probe_steps",
                    "inject_membership")
# the wire-ledger cases (tests/test_torch_wire_ledger.py): every wire at
# vote_every {1, 4} and vote_buckets {1, 4}, one telemetry step each
LEDGER_WIRES = ("sign_psum", "packed_allgather", "packed_a2a", "hier:2")
LEDGER_CASES = tuple((w, ve, vb) for w in LEDGER_WIRES for ve in (1, 4) for vb in (1, 4))


def shared_run(tmp_path_factory, name: str, make) -> pathlib.Path:
    """The directory of ``make(directory)``, run once per test session: the
    first caller (of any module, on any xdist worker) runs it under a file
    lock beside the session's temporary directories; later callers wait for
    the lock and reuse what it wrote."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    out = root / f"shared_{name}"
    with open(root / f"shared_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            shutil.rmtree(out, ignore_errors=True)
            out.mkdir()
            make(out)
            (out / "done").touch()
    return out


@pytest.fixture(autouse=True)
def _clean_faults():
    resilience.clear_faults()
    yield
    resilience.clear_faults()


def _cfg(bs, steps, outdir=None, **kw):
    """tests/test_control_plane.py's ``_trainer_cfg``."""
    base = dict(
        lion=True, async_grad=True, wire="sign_psum", vote_every=1, vote_buckets=1,
        learning_rate=5e-3, lr_scheduler_type="constant", warmup_steps=0, max_steps=steps,
        weight_decay=0.0, per_device_train_batch_size=bs, gradient_accumulation_steps=1,
        block_size=32, logging_steps=1, output_dir=outdir, guard_strikes=2,
        guard_cooldown=1000)
    base.update(kw)
    return base


def _blocks():
    return synthetic_lm_dataset(96, 32, 256, seed=4)


class _Boundaries:
    """Each boundary's ``(kind, step, lifecycle, mask)`` of a trainer's
    plane, recorded after its ``_apply_membership`` and ``_apply_guard``."""

    def __init__(self, tr):
        self.rows: list = []
        for kind in ("_apply_membership", "_apply_guard"):
            setattr(tr, kind, self._wrap(tr, kind, getattr(tr, kind)))

    def _wrap(self, tr, kind, fn):
        def call(step, *args):
            fn(step, *args)
            self.rows.append([kind, int(step), list(tr._cplane.lifecycle()),
                              [bool(b) for b in tr._cplane.alive_mask()]])
        return call


def _trainer(cfg: dict, group, init=None):
    return Trainer.for_gpt2(TrainConfig(**cfg), GPT2Config.tiny(**TINY), device="cpu",
                            grid=data_grid(group), initial_params=init)


def _train(cfg: dict, group, init=None, trainer=None, record=False):
    """A port trainer over ``_blocks``; returns (trainer, losses, boundary
    rows or None). The trainer is closed."""
    tr = trainer if trainer is not None else _trainer(cfg, group, init)
    rows = _Boundaries(tr) if record and tr._cplane is not None else None
    try:
        hist = tr.train(batch_iterator(_blocks(), tr.global_train_batch(), seed=0))
    finally:
        tr.close()
    return tr, [h["loss"] for h in hist if "loss" in h], None if rows is None else rows.rows


class _HealCheck:
    """Wraps the trainer's ``heal_rank_momentum``: before each heal it
    gathers every rank's momentum and forms the healthy mean in plain
    float32, summed in rank order; after it, records whether each healed
    rank's momentum is ``torch.equal`` to it."""

    def __init__(self):
        self.results: list = []
        self._orig = loop_module.heal_rank_momentum

        def heal(m, healthy, workers, group):
            rows = [torch.empty_like(m) for _ in range(WORLD)]
            dist.all_gather(rows, m.contiguous(), group=group)
            src = [r for r in range(WORLD) if healthy[r]]
            total = rows[src[0]].clone()
            for r in src[1:]:
                total = total + rows[r]
            want = total / torch.tensor(float(len(src)))
            self._orig(m, healthy, workers, group)
            if dist.get_rank(group) in [int(w) for w in workers]:
                self.results.append(bool(torch.equal(m, want)))

        loop_module.heal_rank_momentum = heal

    def close(self):
        loop_module.heal_rank_momentum = self._orig


def _sha(t):
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _state(tr):
    return {"params": _sha(tr.flat.params), "momentum": _sha(tr.state.exp_avg),
            "health": tr.state.health.tolist()}


def _work(rank, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/pg", rank=rank,
                            world_size=WORLD)
    world = dist.group.WORLD
    init = params_from_jax(f"{out}/init.npz")
    res = {}
    try:
        # the drop/rejoin pin, journal on (and the heal held to the mean)
        heal = _HealCheck()
        try:
            tr, losses, rows = _train(_cfg(6, PIN_STEPS, journal=True,
                                           journal_dir=f"{out}/journal", **PIN),
                                      world, init, record=True)
        finally:
            heal.close()
        res["pin"] = {"losses": losses, "rows": rows, "heal": heal.results,
                      "state": _state(tr), "final": tr._cplane.lifecycle(),
                      "events": [tr._cplane.left_events, tr._cplane.rejoin_events],
                      "finite": bool(torch.isfinite(tr.state.exp_avg).all())}
        resilience.clear_faults()
        tr, losses, _ = _train(_cfg(6, PIN_STEPS, **PIN), world, init)
        res["pin_off"] = {"losses": losses, "state": _state(tr)}
        resilience.clear_faults()
        _, res["clean"], _ = _train(_cfg(6, PIN_STEPS, control_plane=True), world, init)
        # a drop at step 0 against a run masked from scratch
        tr, losses, _ = _train(_cfg(6, 8, control_plane=True,
                                    inject_membership="worker_drop:2:0"), world)
        res["drop0"] = {"losses": losses, "state": _state(tr),
                        "lifecycle": tr._cplane.lifecycle()}
        resilience.clear_faults()
        tr = _trainer(_cfg(6, 8, vote_guard="enforce"), world)
        mask = [True, True, False, True]
        tr.state = tr.state._replace(health=torch.tensor(mask))
        tr._guard.adopt_mask(mask, step=0)
        tr, losses, _ = _train(None, world, trainer=tr)
        res["masked"] = {"losses": losses, "state": _state(tr)}
        # crash and resume mid-degradation
        spec = dict(control_plane=True, inject_membership="worker_drop:2:2")
        tr, full, _ = _train(_cfg(6, 8, **spec), world)
        res["resume_full"] = {"losses": full, "state": _state(tr)}
        resilience.clear_faults()
        run = f"{out}/resume"
        tr, first, _ = _train(_cfg(6, 4, outdir=run, save_steps=4, **spec), world)
        resilience.clear_faults()
        tr = _trainer(_cfg(6, 8, outdir=run, save_steps=4, **spec), world)
        resumed = {"step": tr.step_count, "lifecycle": tr._cplane.lifecycle(),
                   "departed": {str(k): v for k, v in tr._cplane.departed.items()}}
        tr, second, _ = _train(None, world, trainer=tr)
        res["resume"] = {"losses": first + second, "state": _state(tr), **resumed}
        # a resume after a consumed rejoin does not replay it
        spec = dict(control_plane=True, rejoin_probe_steps=2,
                    inject_membership="worker_drop:2:2,worker_rejoin:2:4")
        resilience.clear_faults()
        tr, full, _ = _train(_cfg(6, 12, **spec), world)
        res["replay_full"] = {"losses": full, "state": _state(tr)}
        resilience.clear_faults()
        run = f"{out}/replay"
        tr, first, _ = _train(_cfg(6, 8, outdir=run, save_steps=8, **spec), world)
        consumed = tr._cplane.rejoin_events
        resilience.clear_faults()
        tr = _trainer(_cfg(6, 12, outdir=run, save_steps=8, **spec), world)
        registry = resilience.fault("membership")
        tr, second, _ = _train(None, world, trainer=tr)
        res["replay"] = {"losses": first + second, "state": _state(tr), "consumed": consumed,
                         "registry": registry,
                         "events": [tr._cplane.left_events, tr._cplane.rejoin_events]}
        # the plane toggled across a resume, both ways
        resilience.clear_faults()
        run = f"{out}/toggle"
        _train(_cfg(6, 4, outdir=run, save_steps=4, control_plane=True,
                    inject_membership="worker_drop:1:0"), world)
        resilience.clear_faults()
        tr = _trainer(_cfg(6, 8, outdir=run, save_steps=4, vote_guard="enforce"), world)
        res["toggle_off"] = [tr.step_count, tr._cplane is None, tr.state.health.tolist(),
                             bool(tr._guard.healthy[1])]
        tr.close()
        run = f"{out}/toggle2"
        _train(_cfg(6, 4, outdir=run, save_steps=4, vote_guard="enforce"), world)
        tr = _trainer(_cfg(6, 8, outdir=run, save_steps=4, control_plane=True), world)
        res["toggle_on"] = [tr.step_count, tr._cplane is not None, tr._cplane.departed,
                            tr.state.health.tolist()]
        tr.close()
        # the quorum refusal names the plane
        try:
            _train(_cfg(6, 8, control_plane=True,
                        inject_membership="worker_drop:1:0,worker_drop:2:2"), world)
            res["quorum"] = "no error"
        except RuntimeError as e:
            res["quorum"] = str(e)
        resilience.clear_faults()
        # strict-JSON membership metrics
        _train(_cfg(6, 4, outdir=f"{out}/metrics", control_plane=True,
                    inject_membership="worker_drop:3:1"), world)
        res["ledger"] = _ledger_cases(world)
        # the DCN pipeline's and ZeRO-1's W = 4 cases
        from test_torch_dcn_pipeline import rank_cases as dcn_cases
        from test_torch_zero import rank_cases as zero_cases

        res["dcn"] = dcn_cases(world, out)
        resilience.clear_faults()
        res["zero"] = zero_cases(world, out)
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _ledger_cases(world) -> dict:
    """One telemetry step on every ``LEDGER_CASES`` configuration: the
    trainer's captured ledger and its first row's wire keys."""
    out = {}
    for wire, ve, vb in LEDGER_CASES:
        tr, _, _ = _train(_cfg(2, 1, wire=wire, vote_every=ve, vote_buckets=vb,
                               telemetry=True), world)
        row = tr.history[0]
        out[f"{wire}|{ve}|{vb}"] = {
            "ledger": tr._wire_measured, "n": tr.n_params,
            "row": {k: row.get(k) for k in (
                "comm_bytes_per_step", "comm_measured_bytes_per_step",
                "comm_measured_calls_per_step", "comm_measured_dcn_bytes_per_step",
                "comm_drift_bytes", "host_step_skew")}}
    return out


def _spawn(out: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.models.gpt2 import gpt2_init

    init = gpt2_init(jax.random.key(42), JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0))
    save_pytree(out / "init.npz", jax.tree.map(np.asarray, init))
    mp.spawn(_work, args=(str(out),), nprocs=WORLD, join=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's record after the session's one spawn of four gloo
    ranks."""
    out = shared_run(tmp_path_factory, "plane_ranks", _spawn)
    return out, [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]


def _jax_pin_run(out: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.data.sources import batch_iterator as j_batch_iterator
    from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.parallel.mesh import make_mesh
    from distributed_lion_tpu.train import resilience as j_resilience
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer

    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    cfg = _cfg(6, PIN_STEPS, journal=True, journal_dir=str(out / "journal"), seed=42, **PIN)
    j_resilience.clear_faults()
    try:
        # no remat on the reference side: the same numbers, less to compile
        jtr = JTrainer.for_gpt2(JTrainConfig(**cfg), mesh,
                                JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0,
                                             remat=False))
        rows = _Boundaries(jtr).rows
        hist = jtr.train(j_batch_iterator(j_synthetic(96, 32, 256, seed=4),
                                          jtr.global_train_batch(), seed=0))
        final = jtr._cplane.lifecycle()
        jtr.close()
    finally:
        j_resilience.clear_faults()
    (out / "pin.json").write_text(json.dumps(
        {"rows": rows, "losses": [float(h["loss"]) for h in hist if "loss" in h],
         "final": final}))


@pytest.fixture(scope="module")
def jax_pin(tmp_path_factory):
    """The JAX trainer on the drop/rejoin pin on a ``data=4`` mesh (once per
    session), journal on: its boundary rows, losses and journal directory."""
    out = shared_run(tmp_path_factory, "plane_jax_pin", _jax_pin_run)
    return dict(json.loads((out / "pin.json").read_text()), journal=out / "journal")


# ------------------------------------------------------------------ parsers
MEMBERSHIP_SPECS = ("worker_drop:2", "worker_drop:0:7", "worker_rejoin:1:9",
                    "worker_drop:2:3, worker_rejoin:2:9", " worker_drop:1 ,", "",
                    "worker_vanish:1", "worker_drop:x", "worker_drop:-1", "worker_rejoin:2",
                    "worker_drop:1:2:3", "worker_rejoin:1:x")
SERVE_SPECS = ("replica_crash:0:2", "replica_kill:1:4", "replica_drain:1", "replica_drain:1:3",
               "slow_tick:0:25", "replica_rejoin:0:5",
               "replica_crash:0:2,replica_rejoin:0:5, slow_tick:1:3", "replica_crash:0",
               "slow_tick:1", "replica_rejoin:2", "bogus:0:1", "replica_crash:-1:2",
               "replica_drain:x")


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", MEMBERSHIP_SPECS)
def test_parse_membership_equals_jax(spec):
    from distributed_lion_tpu.train import resilience as j_resilience

    assert (_outcome(resilience.parse_membership_specs, spec)
            == _outcome(j_resilience.parse_membership_specs, spec))
    if "," not in spec and spec.strip():
        assert (_outcome(resilience.parse_membership, spec)
                == _outcome(j_resilience.parse_membership, spec))
    assert resilience.MEMBERSHIP_KINDS == j_resilience.MEMBERSHIP_KINDS


@pytest.mark.parametrize("spec", SERVE_SPECS)
def test_parse_serve_equals_jax(spec):
    from distributed_lion_tpu.train import resilience as j_resilience

    assert (_outcome(resilience.parse_serve_specs, spec)
            == _outcome(j_resilience.parse_serve_specs, spec))
    if "," not in spec:
        assert (_outcome(resilience.parse_serve_fault, spec)
                == _outcome(j_resilience.parse_serve_fault, spec))
    assert resilience.SERVE_FAULT_KINDS == j_resilience.SERVE_FAULT_KINDS


# ------------------------------------------------------- the plane, unit
class _FakeJournal:
    def __init__(self):
        self.records = []

    def event(self, name, **fields):
        self.records.append({"kind": "event", "name": name, **fields})

    def record(self, rec):
        self.records.append(dict(rec))


def _obs(world=4, nonfinite=(), frozen=(), disagree=None):
    o = {"guard_nonfinite": np.zeros(world, np.int32), "guard_frozen": np.zeros(world, np.int32),
         "guard_disagree": (np.full(world, 0.25) if disagree is None
                            else np.asarray(disagree, np.float64)),
         "guard_voted_steps": np.asarray(1, np.int32)}
    for w in nonfinite:
        o["guard_nonfinite"][w] = 1
    for w in frozen:
        o["guard_frozen"][w] = 1
    return o


def _repeated_quarantines():
    """JAX test_repeated_quarantines_escalate_to_departed's boundaries."""
    ops, step = [("plane", dict(strikes=1, cooldown=2))], 0
    for cycle in range(control_plane.DEPART_AFTER_QUARANTINES):
        step += 1
        ops.append(("observe", step, dict(nonfinite=[0])))
        if cycle < control_plane.DEPART_AFTER_QUARANTINES - 1:
            step += 2
            ops.append(("observe", step, {}))
    ops += [("inject", [("worker_rejoin", 0, step + 1)]), ("due", step + 1),
            ("observe", step + 2, {}), ("observe", step + 5, {}),
            ("observe", step + 6, dict(nonfinite=[0]))]
    return ops


def _chip_smoke_p():
    """``chip_smoke.py`` run (p)'s boundaries in the trainer's order:
    membership before step s + 1, then the guard's fold of step s; rank 1
    dropped at 2 and rejoined at 5, probation 2, the CLI's guard
    defaults."""
    ops = [("plane", dict(strikes=3, cooldown=50, probe=2)),
           ("inject", [("worker_drop", 1, 2), ("worker_rejoin", 1, 5)])]
    for s in range(8):
        ops.append(("due", s))
        if s:
            ops.append(("observe", s, {}))
    return ops + [("observe", 8, {})]


# rank 1's lifecycle after each boundary of run (p), as chip_smoke.py's
# P_LIFECYCLE states it
P_LIFECYCLE = {"due": ["healthy", "healthy", "departed", "departed", "departed", "rejoining",
                       "rejoining", "rejoining"],
               "observe": ["healthy", "departed", "departed", "departed", "rejoining",
                           "rejoining", "healthy", "healthy"]}

SCENARIOS = {
    "chip_smoke_p": _chip_smoke_p(),
    "drop_never_readmits": [("plane", dict(cooldown=2)), ("inject", [("worker_drop", 1, 3)]),
                            ("due", 2), ("due", 3)] + [("observe", s, {}) for s in range(4, 20)],
    "rejoin_heals_and_promotes": [("plane", dict(probe=3)),
                                  ("inject", [("worker_drop", 2, 0), ("worker_rejoin", 2, 5)]),
                                  ("due", 0), ("due", 5), ("observe", 6, {}),
                                  ("observe", 8, {})],
    "probe_failure_departs": [("plane", dict(strikes=2, probe=50)),
                              ("inject", [("worker_drop", 3, 0), ("worker_rejoin", 3, 2)]),
                              ("due", 0), ("due", 2), ("observe", 3, dict(nonfinite=[3])),
                              ("observe", 4, dict(nonfinite=[3])),
                              ("observe", 5, dict(nonfinite=[3]))],
    "same_boundary_drop_then_rejoin": [("plane", dict(probe=2)),
                                       ("inject", [("worker_rejoin", 2, 5),
                                                   ("worker_drop", 2, 5)]), ("due", 5)],
    "repeated_quarantines_escalate": _repeated_quarantines(),
    "rejoin_at_depth_refused": [("plane", dict(depth=1)), ("inject", [("worker_drop", 1, 0)]),
                                ("due", 0), ("inject", [("worker_rejoin", 1, 1)]), ("due", 1)],
    "rejoin_of_a_worker_never_gone": [("plane", {}), ("inject", [("worker_rejoin", 0, 0)]),
                                      ("due", 0), ("observe", 1, {})],
    "adopt_restores_probation": [("plane", dict(probe=10)),
                                 ("inject", [("worker_drop", 1, 0), ("worker_rejoin", 1, 4)]),
                                 ("due", 0), ("due", 4), ("plane", dict(probe=10)),
                                 ("adopt", [True] * 4, 6, dict(
                                     departed=[], sched_through=4,
                                     rejoining_until=[-1, 14, -1, -1],
                                     quarantine_counts=[0, 0, 0, 2])),
                                 ("observe", 7, dict(nonfinite=[1])),
                                 ("observe", 8, dict(nonfinite=[1])),
                                 ("plane", {}), ("adopt", [True] * 4, 6, dict(
                                     rejoining_until=[9] * 8, quarantine_counts=[1] * 8))],
    "stale_window_gets_the_peers_mean": [("plane", dict(strikes=1, probe=5)),
                                         ("inject", [("worker_drop", 0, 0),
                                                     ("worker_rejoin", 0, 2)]),
                                         ("due", 0), ("due", 2),
                                         ("observe", 3, dict(disagree=[0.9, 0.2, 0.3, 0.31])),
                                         ("observe", 4, dict(disagree=[0.2, 0.2, 0.62, 0.25])),
                                         ("observe", 5, dict(frozen=[0]))],
    "resume_departed_and_watermark": [("plane", dict(cooldown=2)),
                                      ("inject", [("worker_drop", 1, 2), ("worker_rejoin", 1, 6),
                                                  ("worker_drop", 3, 9)]),
                                      ("adopt", [True, False, True, True], 5,
                                       dict(departed=[1], sched_through=5)),
                                      ("observe", 6, {}), ("observe", 9, {}), ("due", 6),
                                      ("due", 9)],
    "quorum_and_preempt": [("plane", dict(strikes=1)),
                           ("inject", [("worker_drop", 1, 0), ("worker_drop", 2, 1)]),
                           ("due", 0), ("quorum", 0), ("due", 1), ("quorum", 1),
                           ("preempt", 2), ("preempt", 3)],
}


def _run_scenario(ops, plane_cls, guard_cls, res):
    journal = _FakeJournal()
    plane = None
    trace = []
    for op in ops:
        kind = op[0]
        try:
            if kind == "plane":
                kw = dict(dict(world=4, strikes=2, cooldown=3, probe=4, depth=0), **op[1])
                plane = plane_cls(guard_cls(kw["world"], "enforce",
                                            strike_threshold=kw["strikes"],
                                            cooldown_steps=kw["cooldown"]),
                                  kw["world"], rejoin_probe_steps=kw["probe"],
                                  dcn_pipeline_depth=kw["depth"], journal=journal)
                out = None
            elif kind == "inject":
                res.inject_fault("membership", list(op[1]))
                out = None
            elif kind == "due":
                out = dataclasses.asdict(plane.membership_due(op[1]))
            elif kind == "observe":
                out = dataclasses.asdict(plane.observe(op[1], _obs(**op[2]), 1))
            elif kind == "adopt":
                out = plane.adopt(op[1], op[2], **op[3])
            elif kind == "quorum":
                out = [plane.quorum_ok(), plane.quorum_error(op[1])]
            else:  # preempt
                out = plane.note_preempt(op[1])
            err = None
        except (ValueError, RuntimeError) as e:
            out, err = None, f"{type(e).__name__}: {e}"
        trace.append({
            "op": repr(op), "out": out, "err": err,
            "lifecycle": plane.lifecycle(), "mask": plane.alive_mask().tolist(),
            "report": plane.report(), "summary": plane.summary(),
            "departed": dict(plane.departed), "until": plane.rejoining_until.tolist(),
            "counts": plane.quarantine_counts.tolist(), "through": plane.sched_through,
            "tallies": [plane.transitions, plane.left_events, plane.rejoin_events],
            "strikes": plane.guard.strikes.tolist(),
            "registry": res.fault("membership"), "journal": list(journal.records)})
    return trace


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_control_plane_equals_jax(name):
    from distributed_lion_tpu.train import resilience as j_resilience
    from distributed_lion_tpu.train.control_plane import ControlPlane as JControlPlane
    from distributed_lion_tpu.train.vote_guard import VoteGuard as JVoteGuard

    j_resilience.clear_faults()
    try:
        mine = _run_scenario(SCENARIOS[name], ControlPlane, VoteGuard, resilience)
        theirs = _run_scenario(SCENARIOS[name], JControlPlane, JVoteGuard, j_resilience)
    finally:
        j_resilience.clear_faults()
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a == b, a["op"]
    if name == "chip_smoke_p":
        ops = SCENARIOS[name]
        got = {k: [t["lifecycle"][1] for op, t in zip(ops, mine) if op[0] == k]
               for k in P_LIFECYCLE}
        assert got == P_LIFECYCLE
        return
    # each scenario reaches the state its JAX test asserts
    final = mine[-1]
    want = {"drop_never_readmits": ("departed", 1),
            "rejoin_heals_and_promotes": ("healthy", 2),
            "probe_failure_departs": ("departed", 3),
            "same_boundary_drop_then_rejoin": ("rejoining", 2),
            "repeated_quarantines_escalate": ("quarantined", 0),
            "rejoin_at_depth_refused": ("departed", 1),
            "rejoin_of_a_worker_never_gone": ("healthy", 0),
            "adopt_restores_probation": ("healthy", 1),
            "stale_window_gets_the_peers_mean": ("departed", 0),
            "resume_departed_and_watermark": ("departed", 3),
            "quorum_and_preempt": ("departed", 2)}[name]
    assert final["lifecycle"][want[1]] == want[0], final
    if name == "rejoin_at_depth_refused":
        assert "DCN tally ring" in final["err"]
    if name == "probe_failure_departs":
        assert ["probe_failed"] == [c for _, c in final["out"]["left"]]


def test_plane_construction_equals_jax():
    from distributed_lion_tpu.train import control_plane as j_plane
    from distributed_lion_tpu.train.vote_guard import VoteGuard as JVoteGuard

    assert control_plane.STATES == j_plane.STATES
    assert control_plane.DEPART_AFTER_QUARANTINES == j_plane.DEPART_AFTER_QUARANTINES
    for mod, guard in ((control_plane, VoteGuard), (j_plane, JVoteGuard)):
        with pytest.raises(ValueError, match="VoteGuard"):
            mod.ControlPlane(None, 4)
        with pytest.raises(ValueError, match="world"):
            mod.ControlPlane(guard(8, "enforce"), 4)
        with pytest.raises(ValueError, match="rejoin_probe_steps"):
            mod.ControlPlane(guard(4, "enforce"), 4, rejoin_probe_steps=-1)
        auto = mod.make_control_plane(guard(4, "enforce", cooldown_steps=7), 4, 0, 0)
        assert auto.rejoin_probe_steps == 7 and auto.lifecycle() == ["healthy"] * 4


# ----------------------------------------------------- trainer, one rank
def test_trainer_flag_rules():
    model = GPT2Config.tiny(**TINY)
    with pytest.raises(ValueError, match="control_plane"):
        Trainer.for_gpt2(TrainConfig(**_cfg(2, 4, inject_membership="worker_drop:0")), model,
                         device="cpu")
    with pytest.raises(ValueError, match="outside world"):
        Trainer.for_gpt2(TrainConfig(**_cfg(2, 4, control_plane=True,
                                            inject_membership="worker_drop:3:500")),
                         model, device="cpu")
    with pytest.raises(ValueError, match="observe"):
        Trainer.for_gpt2(TrainConfig(**_cfg(2, 4, control_plane=True, vote_guard="observe")),
                         model, device="cpu")
    with pytest.raises(ValueError, match="AdamW|election"):
        Trainer.for_gpt2(TrainConfig(**_cfg(2, 4, lion=False, async_grad=False,
                                            control_plane=True)), model, device="cpu")
    with pytest.raises(ValueError, match="bad membership spec"):
        Trainer.for_gpt2(TrainConfig(**_cfg(2, 4, control_plane=True,
                                            inject_membership="worker_rejoin:0")),
                         model, device="cpu")


def test_control_plane_auto_arms_enforce(capsys):
    tr = Trainer.for_gpt2(TrainConfig(**_cfg(2, 4, control_plane=True)), GPT2Config.tiny(**TINY),
                          device="cpu")
    try:
        assert tr.cfg.vote_guard == "enforce"
        assert tr._cplane is not None and tr._guard is not None
        assert tr.state.health.tolist() == [True]
        assert tr._cplane.rejoin_probe_steps == 1000  # auto: --guard_cooldown
    finally:
        tr.close()
    assert "auto-armed to 'enforce'" in capsys.readouterr().out


CLI_GROUPS = {"run_clm": (run_clm.ModelArguments, run_clm.DataArguments),
              "run_sft": (run_sft.SFTArguments,),
              "run_dpo": (run_dpo.DPOArguments,)}


@pytest.mark.parametrize("cli", sorted(CLI_GROUPS))
def test_cli_accepts_the_membership_flags(cli):
    """Every entry point takes the five flags (they come with
    ``TrainConfig``), with the JAX package's names and defaults."""
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig

    parser = build_parser(CLI_GROUPS[cli] + (TrainConfig,))
    args = parser.parse_args(["--journal", "--journal_dir", "/j", "--control_plane",
                              "--rejoin_probe_steps", "3", "--inject_membership",
                              "worker_drop:1:2"])
    assert (args.journal, args.journal_dir, args.control_plane, args.rejoin_probe_steps,
            args.inject_membership) == (True, "/j", True, 3, "worker_drop:1:2")
    jdefaults = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    for f in dataclasses.fields(TrainConfig):
        if f.name in MEMBERSHIP_FLAGS:
            assert f.default == jdefaults[f.name], f.name


# ------------------------------------------------------- trainer, W = 4
def test_drop_rejoin_matches_the_jax_trainer(ranks, jax_pin):
    """Worker 2 drops at step 3 and rejoins at 9 (probation 4): the port's
    boundaries (lifecycle and mask after every membership and guard fold)
    are the JAX trainer's on every rank, its losses within 1e-5 of JAX's,
    the run ends all healthy with finite momentum, and its tail tracks the
    clean run within JAX's pre-registered bound."""
    _, recs = ranks
    want = jax_pin["rows"]
    assert [r for r in want if r[2][2] != "healthy"], "the pin never left healthy"
    left = [r[1] for r in want if r[0] == "_apply_membership" and r[2][2] == "departed"]
    assert left[0] == 3 and [r[1] for r in want if r[2][2] == "rejoining"][0] == 9
    for r, rec in enumerate(recs):
        pin = rec["pin"]
        assert pin["rows"] == want, r
        np.testing.assert_allclose(pin["losses"], jax_pin["losses"], atol=1e-5, rtol=0)
        assert pin["final"] == jax_pin["final"] == ["healthy"] * WORLD
        assert pin["events"] == [1, 1] and pin["finite"]
        assert pin["state"]["health"] == [True] * WORLD
    gap = abs(np.mean(recs[0]["pin"]["losses"][-TAIL:]) - np.mean(recs[0]["clean"][-TAIL:]))
    assert gap < REJOIN_PARITY_BOUND_NATS, gap


def test_four_ranks_agree_at_every_boundary(ranks):
    _, recs = ranks
    for rec in recs[1:]:
        assert rec["pin"]["rows"] == recs[0]["pin"]["rows"]
        assert rec["pin"]["state"]["params"] == recs[0]["pin"]["state"]["params"]


def test_rejoin_heals_to_the_healthy_mean(ranks):
    """The rejoiner's momentum after the heal is ``torch.equal`` to the mean
    of ranks 0, 1 and 3, summed in rank order; the other ranks keep theirs."""
    _, recs = ranks
    assert [rec["pin"]["heal"] for rec in recs] == [[], [], [True], []]


def test_journal_on_off_equal_at_w4(ranks):
    _, recs = ranks
    for rec in recs:
        assert rec["pin"]["state"] == rec["pin_off"]["state"]
        assert rec["pin"]["losses"] == rec["pin_off"]["losses"]


def test_w4_journals_read_by_both_analyzers(ranks):
    """The four ranks' journals: strict schema, the same report from the
    port's and the JAX analyzer, every rank's attribution closing with
    coverage >= 0.95, and the membership timeline exactly the drop, the
    rejoin and the probation's end."""
    out, _ = ranks
    jdir = out / "journal"
    files = sorted(jdir.glob("journal_rank*.jsonl"))
    assert [f.name for f in files] == [f"journal_rank{r}.jsonl" for r in range(WORLD)]
    vm = _load("plane_validate_metrics", "scripts/validate_metrics.py")
    for f in files:
        assert vm.validate_journal_file(str(f)) == []
    ja = _load("plane_run_analyze", "distributed_lion_tpu/cli/run_analyze.py")
    for r in range(WORLD):
        rep = run_analyze.analyze_dir(str(jdir), rank=r)
        assert rep == ja.analyze_dir(str(jdir), rank=r)
        att = rep["attribution"]
        assert rep["schema_errors"] == 0 and att["closes"] and att["coverage"] >= 0.95, att
        assert att["steps"] == PIN_STEPS
    timeline = run_analyze.analyze_dir(str(jdir))["membership"]
    assert [(t.get("transition") or t["event"], t["step"], t.get("worker")) for t in timeline] \
        == [("worker_left", 3, 2), ("worker_rejoined", 9, 2), ("healthy", 13, 2)]
    assert run_analyze.analyze_dir(str(jdir))["step_skew"]["steps_compared"] == PIN_STEPS


def test_jax_trainer_journal_matches_the_ports_timeline(ranks, jax_pin):
    """The JAX trainer's journal of the same pin: both analyzers agree on
    it, and its membership timeline is the port's."""
    out, _ = ranks
    ja = _load("plane_run_analyze_j", "distributed_lion_tpu/cli/run_analyze.py")
    rep = run_analyze.analyze_dir(str(jax_pin["journal"]))
    assert rep == ja.analyze_dir(str(jax_pin["journal"]))
    assert rep["membership"] == run_analyze.analyze_dir(str(out / "journal"))["membership"]


def test_drop_at_zero_equals_a_run_masked_from_scratch(ranks):
    _, recs = ranks
    for rec in recs:
        assert rec["drop0"]["lifecycle"][2] == "departed"
        assert rec["drop0"]["losses"] == rec["masked"]["losses"]
        assert rec["drop0"]["state"] == rec["masked"]["state"]
        assert rec["masked"]["state"]["health"] == [True, True, False, True]


def test_crash_resume_mid_degradation_equals_uninterrupted(ranks):
    _, recs = ranks
    for rec in recs:
        got = rec["resume"]
        assert got["step"] == 4 and got["lifecycle"][2] == "departed"
        assert got["departed"] == {"2": "resumed"}
        assert got["losses"] == rec["resume_full"]["losses"]
        assert got["state"] == rec["resume_full"]["state"]
        assert got["state"]["health"] == [True, True, False, True]


def test_resume_after_a_consumed_rejoin_does_not_replay(ranks):
    _, recs = ranks
    for rec in recs:
        got = rec["replay"]
        assert got["consumed"] == 1 and got["registry"] == []
        assert got["events"] == [0, 0]
        assert got["losses"] == rec["replay_full"]["losses"]
        assert got["state"] == rec["replay_full"]["state"]


def test_plane_toggle_across_a_resume(ranks):
    _, recs = ranks
    for rec in recs:
        assert rec["toggle_off"] == [4, True, [True, False, True, True], False]
        assert rec["toggle_on"] == [4, True, {}, [True] * WORLD]


def test_quorum_refusal_names_the_plane(ranks):
    _, recs = ranks
    for rec in recs:
        assert rec["quorum"].startswith("control plane: healthy quorum 2/4 fell below "
                                        "--min_quorum 3"), rec["quorum"]
        assert "'departed'" in rec["quorum"]


def test_membership_metrics_are_strict_json(ranks):
    out, _ = ranks
    path = out / "metrics" / "metrics.jsonl"
    proc = subprocess.run([sys.executable, "scripts/validate_metrics.py", str(path)],
                          capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    assert any(r.get("train/cp_departed") == 1 for r in rows)
    assert all("train/cp_transitions" in r for r in rows)


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
