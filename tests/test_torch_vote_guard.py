"""The vote guard, port against the JAX package (tests/test_vote_guard.py).

Four gloo ranks spawned once (the ``ranks`` fixture) run every W = 4 case
and write what they saw; the tests hold it against the JAX package on a
``data=4`` mesh, or against the bounds of the JAX tests. Tolerances: the
masked elections' tallies, the masks, the guard counters and the
quarantine steps are exact; the guarded trainer's losses are held within
1e-5 of the JAX trainer's on the same init and batches (the bound of the
port's other trainer comparisons).

- **masked elections** on all four wires at random masks, at a mask whose
  quorum of 2 makes ties, and for ``hier:2`` with a fully quarantined
  group: the tally (or the ±1 proxy) bit-identical to JAX's
  ``vote_total(alive=...)``; all-healthy equal to unmasked; ``WireTally``
  bytes unchanged by the mask;
- **all-healthy enforce** ``torch.equal`` to ``off`` in params and momentum
  over wire × {deterministic, stochastic} × buckets {1, 4}, and lazy K 4;
- the **guard frame** naming a NaN rank and a frozen rank; ``enforce``
  keeping momentum finite where ``observe`` lets the NaN in;
- :class:`VoteGuard` against JAX's on the same observation streams;
  ``heal_rank_momentum`` (windowed, over the ranks) bit-identical to JAX's
  ``heal_worker_momentum``;
- the **trainer**: quarantine and readmission on JAX's steps with JAX's
  masks; a flipped voter under ``enforce`` tracking a clean W−1 run;
  a NaN rank poisoning its own momentum only with the guard off, and
  ``observe`` leaving that run's elections as they are;
  ``min_quorum`` refusal; the mask restored exactly from a checkpoint; a
  guard toggle across a checkpoint; an elastic resume healing a
  quarantined momentum before the remap; strict-JSON metrics.

jax is imported inside the tests only, so the spawned ranks import torch
alone.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import distributed_lion_tpu_torch.optim.distributed_lion as lion_module
from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.optim.distributed_lion import (
    distributed_lion,
    heal_rank_momentum,
    heal_worker_momentum,
)
from distributed_lion_tpu_torch.optim.lion import FlatParams
from distributed_lion_tpu_torch.parallel import collectives
from distributed_lion_tpu_torch.parallel.mesh import data_grid
from distributed_lion_tpu_torch.train import resilience
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.train.vote_guard import VoteGuard
from distributed_lion_tpu_torch.utils.serialization import params_from_jax, save_pytree

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
WIRES = ("sign_psum", "packed_allgather", "packed_a2a", "hier:2")
N = 1003
# masks: all healthy; one sick; quorum 2 (ties); hier:2's group 0 all sick;
# then three drawn at random (each with a healthy rank)
_DRAWN = np.random.default_rng(2).integers(0, 2, size=(8, WORLD))
MASKS = ((1, 1, 1, 1), (1, 0, 1, 1), (0, 1, 1, 0), (0, 0, 1, 1)) + tuple(
    tuple(int(x) for x in m) for m in _DRAWN if m.any())[:3]
# the quarantine pin (chip_smoke.py's run (m2)): rank 1's grads NaN from
# step 1, 2 strikes, cooldown 3, 8 steps
PIN = dict(inject_poison="nan_grads:1:1", guard_strikes=2, guard_cooldown=3)
PIN_STEPS = 8
TINY = dict(compute_dtype=torch.float32, dropout=0.0)


def _cfg(bs, steps, guard="off", poison="", outdir=None, **kw):
    """tests/test_vote_guard.py's ``_trainer_cfg``."""
    base = dict(
        lion=True, async_grad=True, wire="sign_psum", vote_every=1, vote_buckets=1,
        learning_rate=5e-3, lr_scheduler_type="constant", warmup_steps=0, max_steps=steps,
        weight_decay=0.0, per_device_train_batch_size=bs, gradient_accumulation_steps=1,
        block_size=32, logging_steps=1, output_dir=outdir, vote_guard=guard,
        guard_strikes=2, guard_cooldown=1000, inject_poison=poison)
    base.update(kw)
    return base


def _blocks():
    return synthetic_lm_dataset(96, 32, 256, seed=4)


def _train(cfg: dict, group, init=None, events=None):
    """A port trainer over ``_blocks``; returns (trainer, losses). With
    ``events`` each guard transition is appended as (step, quarantined,
    readmitted)."""
    tr = Trainer.for_gpt2(TrainConfig(**cfg), GPT2Config.tiny(**TINY), device="cpu",
                          grid=data_grid(group), initial_params=init)
    if events is not None:
        update = tr._guard.update

        def record(step, obs, advanced):
            ev = update(step, obs, advanced)
            if ev.quarantined or ev.readmitted:
                events.append([int(step), [int(w) for w in ev.quarantined],
                               [int(w) for w in ev.readmitted]])
            return ev

        tr._guard.update = record
    try:
        hist = tr.train(batch_iterator(_blocks(), tr.global_train_batch(), seed=0))
    finally:
        tr.close()
    return tr, [h["loss"] for h in hist if "loss" in h]


def _grads(world, n, t, poison=None, kind=None):
    """Per-step random grads of every rank, [W, n] (honest ballots flip)."""
    g = np.random.default_rng(100 + t).normal(size=(world, n)).astype(np.float32)
    if kind == "nan":
        g[poison] = np.nan
    elif kind == "zero":
        g[poison] = 0.0
    return g


def _opt_run(rank, steps, grads_fn, **kw):
    """``steps`` optimizer steps of one rank at N coordinates; returns
    (params, momentum, last guard frame or None)."""
    p = np.random.default_rng(7).normal(size=N).astype(np.float32)
    flat = FlatParams([("p", torch.nn.Parameter(torch.from_numpy(p)))])
    opt = distributed_lion(0.01, weight_decay=0.0, **kw)
    state = opt.init(flat)
    frame = None
    for t in range(steps):
        flat.grads.copy_(torch.from_numpy(grads_fn(t)[rank]))
        out = opt.step(flat, state)
        state, frame = (out[0], out[-1]) if type(out) is tuple else (out, None)
    return flat.params.clone(), state.exp_avg.clone(), frame


def _elections(rank, out):
    ballots = np.where(np.random.default_rng(3).integers(0, 2, size=(WORLD, N)), 1, -1)
    mine = torch.from_numpy(ballots[rank].astype(np.int8))
    res = {}
    for wire in WIRES:
        for mask in (None,) + MASKS:
            tally = collectives.WireTally()
            alive = None if mask is None else torch.tensor(mask, dtype=torch.bool)
            total = collectives.vote_total(mine.clone(), wire, dist.group.WORLD, tally,
                                           alive=alive)
            res[f"{wire}|{mask}"] = {"total": total.to(torch.int32).tolist(),
                                     "bytes": tally.entries}
    return res


def _optimizer_cases(rank):
    """All-healthy enforce against off; the guard frames; the sanitize; the
    heal. The guard's windows are cut to a few per vector, so every windowed
    pass runs more than one."""
    lion_module.GUARD_WINDOW = 296
    try:
        return _optimizer_windowed(rank)
    finally:
        lion_module.GUARD_WINDOW = 1 << 26


def _optimizer_windowed(rank):
    res = {"identity": []}
    for wire in WIRES:
        for stochastic in (False, True):
            for buckets in (1, 4):
                kw = dict(wire=wire, vote_buckets=buckets,
                          **({"max_grad_norm": 1.0, "seed": 3} if stochastic else {}))
                runs = [_opt_run(rank, 3, lambda t: _grads(WORLD, N, t), guard=g, **kw)
                        for g in ("off", "enforce")]
                res["identity"].append(bool(torch.equal(runs[0][0], runs[1][0])
                                            and torch.equal(runs[0][1], runs[1][1])))
    for wire in ("sign_psum", "packed_a2a"):
        runs = [_opt_run(rank, 5, lambda t: _grads(WORLD, N, t), guard=g, wire=wire,
                         vote_every=4, vote_buckets=2) for g in ("off", "enforce")]
        res["identity"].append(bool(torch.equal(runs[0][0], runs[1][0])
                                    and torch.equal(runs[0][1], runs[1][1])))
    _, _, f = _opt_run(rank, 2, lambda t: _grads(WORLD, N, t, 3, "nan"), guard="observe")
    res["nonfinite"] = f["nonfinite"].tolist()
    _, _, f = _opt_run(rank, 3, lambda t: _grads(WORLD, N, t, 2, "zero"), guard="observe")
    res["flips"], res["flip_valid"] = f["flips"].tolist(), bool(f["flip_valid"])
    for guard in ("enforce", "observe"):
        _, m, _ = _opt_run(rank, 2, lambda t: _grads(WORLD, N, t, 1, "nan"), guard=guard)
        res[f"finite_{guard}"] = bool(torch.isfinite(m).all())
    rows = np.random.default_rng(9).normal(size=(WORLD, N)).astype(np.float32)
    m = torch.from_numpy(rows[rank].copy())
    heal_rank_momentum(m, [True, False, True, True], [1, 3], dist.group.WORLD)
    res["healed"] = m.tolist()
    return res


def _trainer_cases(rank, out, init):
    world = dist.group.WORLD
    sub3 = dist.new_group([0, 1, 2])
    sub2 = dist.new_group([0, 1])
    res = {}
    # the quarantine pin
    events = []
    tr, losses = _train(_cfg(2, PIN_STEPS, guard="enforce", **PIN), world, init, events)
    res["pin"] = {"events": events, "losses": losses, "mask": tr.state.health.tolist(),
                  "finite": bool(torch.isfinite(tr.state.exp_avg).all()),
                  "rows": [[r["guard_healthy_mask"], r["guard_strikes"]]
                           for r in tr.history if "loss" in r]}
    # a flipped voter: enforce tracks a clean W−1 run (bs 8 x 3 = bs 6 x 4)
    if rank < 3:
        _, clean = _train(_cfg(8, 40), sub3)
        res["clean"] = clean
    tr, enf = _train(_cfg(6, 40, guard="enforce", inject_poison="flipped_ballot:1"), world)
    res["flip_enforce"] = {"losses": enf, "report": tr._guard.sick_report()}
    _, res["flip_off"] = _train(_cfg(6, 40, inject_poison="flipped_ballot:1"), world)
    # a NaN rank without the guard: its own momentum poisoned, losses finite
    tr, off = _train(_cfg(2, 8, inject_poison="nan_grads:3"), world)
    res["nan_off"] = {"finite": bool(torch.isfinite(tr.state.exp_avg).all()),
                      "losses_finite": bool(np.isfinite(off).all())}
    params_off = tr.flat.params.clone()
    tr, obs = _train(_cfg(2, 8, guard="observe", inject_poison="nan_grads:3"), world)
    res["observe"] = {"same": obs == off and torch.equal(tr.flat.params, params_off),
                      "sick": sorted(tr._guard.sick_report()["sick_workers"]),
                      "mask": tr.state.health.tolist()}
    tr, _ = _train(_cfg(2, 8, guard="enforce", inject_poison="nan_grads:3"), world)
    res["nan_enforce"] = {"finite": bool(torch.isfinite(tr.state.exp_avg).all()),
                          "mask": tr.state.health.tolist()}
    try:
        _train(_cfg(2, 10, guard="enforce", inject_poison="nan_grads:0", min_quorum=4), world)
        res["quorum"] = "no error"
    except RuntimeError as e:
        res["quorum"] = str(e)
    # the mask across a checkpoint
    run = f"{out}/mask"
    tr, _ = _train(_cfg(2, 6, guard="enforce", inject_poison="nan_grads:2", outdir=run,
                        save_steps=6), world)
    saved = tr.state.health.tolist()
    resilience.clear_faults()
    tr2 = Trainer.for_gpt2(TrainConfig(**_cfg(2, 12, guard="enforce", outdir=run,
                                              save_steps=6)),
                           GPT2Config.tiny(**TINY), device="cpu", grid=data_grid(world))
    res["mask_resume"] = {"saved": saved, "step": tr2.step_count,
                          "health": tr2.state.health.tolist(),
                          "guard": tr2._guard.healthy.tolist()}
    tr2.close()
    # a guard toggle across a checkpoint, both ways
    tr, _ = _train(_cfg(2, 4, guard="enforce", outdir=f"{out}/t1", save_steps=4), world)
    tr = Trainer.for_gpt2(TrainConfig(**_cfg(2, 8, outdir=f"{out}/t1", save_steps=4)),
                          GPT2Config.tiny(**TINY), device="cpu", grid=data_grid(world))
    res["toggle_off"] = [tr.step_count, tr.state.health is None, tr.state.prev_ballot is None]
    tr.close()
    _train(_cfg(2, 4, outdir=f"{out}/t2", save_steps=4), world)
    tr = Trainer.for_gpt2(TrainConfig(**_cfg(2, 8, guard="enforce", outdir=f"{out}/t2",
                                             save_steps=4)),
                          GPT2Config.tiny(**TINY), device="cpu", grid=data_grid(world))
    res["toggle_on"] = [tr.step_count, tr.state.health.tolist(),
                        int(tr.state.prev_ballot.sum())]
    tr.close()
    # elastic resume W 4 -> 2 with rank 1 quarantined and its momentum garbage
    run = f"{out}/elastic"
    tr, _ = _train(_cfg(2, 4, guard="enforce", outdir=run, save_steps=4), world)
    tr = Trainer.for_gpt2(TrainConfig(**_cfg(2, 4, guard="enforce", outdir=run, save_steps=4)),
                          GPT2Config.tiny(**TINY), device="cpu", grid=data_grid(world))
    if rank == 1:
        tr.state.exp_avg.fill_(1e9)
    tr.state = tr.state._replace(health=torch.tensor([True, False, True, True]))
    tr.step_count += 1
    tr.save()
    tr.close()
    if rank < 2:
        tr = Trainer.for_gpt2(TrainConfig(**_cfg(4, 10, guard="enforce", outdir=run,
                                                 save_steps=100, elastic_resume=True)),
                              GPT2Config.tiny(**TINY), device="cpu", grid=data_grid(sub2))
        res["elastic"] = {"exp_avg": tr.state.exp_avg.tolist(),
                          "health": tr.state.health.tolist(), "step": tr.step_count}
        tr.close()
    dist.barrier()
    return res


def _work(rank, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/pg", rank=rank,
                            world_size=WORLD)
    try:
        res = {"elections": _elections(rank, out), **_optimizer_cases(rank),
               **_trainer_cases(rank, out, params_from_jax(f"{out}/init.npz"))}
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's record, after one spawn of four gloo ranks."""
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.models.gpt2 import gpt2_init

    out = tmp_path_factory.mktemp("guard")
    init = gpt2_init(jax.random.key(42), JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0))
    save_pytree(out / "init.npz", jax.tree.map(np.asarray, init))
    mp.spawn(_work, args=(str(out),), nprocs=WORLD, join=True)
    return out, [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]


def _jax_vote_total(wire):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.parallel import collectives as jc
    from distributed_lion_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])

    @jax.jit
    def masked(b, a):
        return shard_map(lambda b, a: jc.vote_total(b[0] > 0, "data", wire, a), mesh=mesh,
                         in_specs=(P("data"), P()), out_specs=P(), check_vma=False)(b, a)

    @jax.jit
    def plain(b):
        return shard_map(lambda b: jc.vote_total(b[0] > 0, "data", wire), mesh=mesh,
                         in_specs=(P("data"),), out_specs=P(), check_vma=False)(b)

    return masked, plain


def test_masked_elections_match_jax_on_every_wire(ranks):
    import jax.numpy as jnp

    _, recs = ranks
    ballots = jnp.asarray(np.where(np.random.default_rng(3).integers(0, 2, size=(WORLD, N)),
                                   1, -1))
    for wire in WIRES:
        masked, plain = _jax_vote_total(wire)
        want_plain = np.asarray(plain(ballots))
        for mask in (None,) + MASKS:
            want = (want_plain if mask is None
                    else np.asarray(masked(ballots, jnp.asarray(mask, jnp.bool_))))
            key = f"{wire}|{mask}"
            for r in range(WORLD):
                got = recs[r]["elections"][key]
                np.testing.assert_array_equal(got["total"], want, err_msg=f"{key} rank {r}")
                assert got["bytes"] == recs[r]["elections"][f"{wire}|None"]["bytes"], key
        # with every rank healthy the masked election is the unmasked one
        assert (recs[0]["elections"][f"{wire}|(1, 1, 1, 1)"]["total"]
                == recs[0]["elections"][f"{wire}|None"]["total"])
    # hier:2 at mask (0, 0, 1, 1): group 0 abstains, group 1's verdict wins
    hier = np.asarray(recs[0]["elections"]["hier:2|(0, 0, 1, 1)"]["total"])
    group1 = np.asarray(ballots)[2:].sum(0) > 0
    np.testing.assert_array_equal(hier > 0, group1)


def test_all_healthy_enforce_equals_off(ranks):
    _, recs = ranks
    for r in range(WORLD):
        assert recs[r]["identity"] == [True] * (len(WIRES) * 4 + 2), r


def test_guard_frames_name_the_nan_and_the_frozen_rank(ranks):
    _, recs = ranks
    for r in range(WORLD):
        nf = recs[r]["nonfinite"]
        assert nf[3] > 0 and nf[:3] == [0, 0, 0]
        flips = recs[r]["flips"]
        assert recs[r]["flip_valid"] and flips[2] == 0
        assert all(flips[i] > 0 for i in (0, 1, 3))
    # enforce zeroes the NaN grads before the momentum update; observe does not
    assert all(rec["finite_enforce"] for rec in recs)
    assert [rec["finite_observe"] for rec in recs] == [True, False, True, True]


def test_heal_rank_momentum_equals_jax_heal_worker_momentum(ranks):
    import jax.numpy as jnp

    from distributed_lion_tpu.optim import heal_worker_momentum as j_heal

    _, recs = ranks
    rows = np.random.default_rng(9).normal(size=(WORLD, N)).astype(np.float32)
    healthy = np.array([True, False, True, True])
    want = np.asarray(j_heal({"m": jnp.asarray(rows)}, healthy, [1, 3])["m"])
    for r in range(WORLD):
        np.testing.assert_array_equal(np.asarray(recs[r]["healed"], np.float32), want[r])
    stacked = heal_worker_momentum(torch.from_numpy(rows), healthy, [1, 3])
    np.testing.assert_array_equal(stacked.numpy(), want)
    bf16 = torch.from_numpy(rows).to(torch.bfloat16)
    want16 = np.asarray(j_heal({"m": jnp.asarray(bf16.float().numpy()).astype(jnp.bfloat16)},
                               healthy, [1])["m"]).astype(np.float32)
    np.testing.assert_array_equal(heal_worker_momentum(bf16, healthy, [1]).float().numpy(),
                                  want16)


def _obs(world, nonfinite=(), frozen=(), disagree=None, voted=1):
    o = {"guard_nonfinite": np.zeros(world, np.int32), "guard_frozen": np.zeros(world, np.int32),
         "guard_disagree": (np.full(world, 0.25) if disagree is None else np.asarray(disagree)),
         "guard_voted_steps": np.asarray(voted, np.int32)}
    for w in nonfinite:
        o["guard_nonfinite"][w] = 1
    for w in frozen:
        o["guard_frozen"][w] = 1
    return o


STREAMS = {
    # strikes, quarantine, cooldown, readmission
    "strikes": (dict(strike_threshold=2, cooldown_steps=10),
                [(1, dict(nonfinite=[2])), (2, dict(nonfinite=[2])), (5, dict(nonfinite=[2])),
                 (12, {})]),
    # a clean window forgives one strike
    "decay": (dict(strike_threshold=3, cooldown_steps=10),
              [(1, dict(nonfinite=[0])), (2, {}), (3, {}), (4, dict(frozen=[1])),
               (5, dict(frozen=[1])), (6, dict(frozen=[1]))]),
    # the outlier rule: both arms, and the noise-dominated election
    "outlier": (dict(strike_threshold=1, cooldown_steps=10),
                [(1, dict(disagree=[0.26, 0.43, 0.25, 0.27])),
                 (2, dict(disagree=[0.49, 0.51, 0.48, 0.5]))]),
    "quorum": (dict(strike_threshold=1, cooldown_steps=1000),
               [(1, dict(nonfinite=[0, 1])), (2, dict(nonfinite=[0, 1], voted=0))]),
}


@pytest.mark.parametrize("mode", ["enforce", "observe"])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_vote_guard_machine_equals_jax(stream, mode):
    from distributed_lion_tpu.train.vote_guard import VoteGuard as JVoteGuard

    kw, steps = STREAMS[stream]
    guards = [VoteGuard(4, mode, **kw), JVoteGuard(4, mode, **kw)]
    for step, o in steps:
        evs = [g.update(step, _obs(4, **o), 1) for g in guards]
        assert [(e.quarantined, e.readmitted, e.mask_changed, e.logs) for e in evs[:1]] == \
            [(e.quarantined, e.readmitted, e.mask_changed, e.logs) for e in evs[1:]]
        mine, theirs = guards
        assert mine.sick_report() == theirs.sick_report()
        assert mine.summary() == theirs.summary()
        assert mine.quorum_ok() == theirs.quorum_ok()
        np.testing.assert_array_equal(mine.strikes, theirs.strikes)
    for g in guards:
        g.adopt_mask([True, False, True, True], step=7)
    assert guards[0].sick_report() == guards[1].sick_report()
    np.testing.assert_array_equal(guards[0].quarantined_at, guards[1].quarantined_at)


def test_vote_guard_validation_equals_jax():
    from distributed_lion_tpu.train import vote_guard as jvg

    from distributed_lion_tpu_torch.train import vote_guard

    for mod in (vote_guard, jvg):
        with pytest.raises(ValueError):
            mod.VoteGuard(4, "nonsense")
        with pytest.raises(ValueError):
            mod.VoteGuard(4, "enforce", min_quorum=9)
        with pytest.raises(ValueError):
            mod.VoteGuard(4, "enforce").adopt_mask([True, True], step=0)
        with pytest.raises(ValueError):
            mod.parse_guard_mode("sometimes")
        assert mod.make_guard(4, "off", 3, 50, 0) is None
        assert mod.make_guard(5, "enforce", 3, 50, 0).min_quorum == 3
    assert vote_guard.OBS_KEYS == jvg.OBS_KEYS
    assert (vote_guard.DISAGREE_ABS, vote_guard.DISAGREE_MARGIN) == (jvg.DISAGREE_ABS,
                                                                      jvg.DISAGREE_MARGIN)
    with pytest.raises(ValueError):
        distributed_lion(guard="sometimes")
    with pytest.raises(ValueError):
        distributed_lion(axis_name=None, guard="enforce")
    with pytest.raises(ValueError, match="vote_guard"):
        Trainer.for_gpt2(TrainConfig(lion=False, async_grad=False, vote_guard="enforce"),
                         GPT2Config.tiny(**TINY), device="cpu")


def test_quarantine_and_readmission_on_jax_steps(ranks):
    """Rank 1's grads NaN from step 1, 2 strikes, cooldown 3, 8 steps:
    quarantined at step 3, readmitted (momentum healed) at 6, quarantined
    again at 8, on the steps the JAX trainer decides them, with its losses.
    Each transition lands one step behind its evidence, so the logged rows
    show the first quarantine from step 4 on."""
    import jax

    from distributed_lion_tpu.data.sources import batch_iterator as j_batch_iterator
    from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.parallel.mesh import make_mesh
    from distributed_lion_tpu.train import resilience as j_resilience
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer

    _, recs = ranks
    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    import jax.numpy as jnp

    cfg = _cfg(2, PIN_STEPS, guard="enforce", **PIN)
    cfg.update(seed=42)
    j_resilience.clear_faults()
    try:
        jtr = JTrainer.for_gpt2(JTrainConfig(**cfg), mesh,
                                JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0))
        events = []
        update = jtr._guard.update

        def record(step, obs, advanced):
            ev = update(step, obs, advanced)
            if ev.quarantined or ev.readmitted:
                events.append([int(step), list(ev.quarantined), list(ev.readmitted)])
            return ev

        jtr._guard.update = record
        hist = jtr.train(j_batch_iterator(j_synthetic(96, 32, 256, seed=4),
                                          jtr.global_train_batch(), seed=0))
        mask = np.asarray(jtr.state.health).tolist()
        jtr.close()
    finally:
        j_resilience.clear_faults()
    assert events == [[3, [1], []], [6, [], [1]], [8, [1], []]]
    for r in range(WORLD):
        pin = recs[r]["pin"]
        assert pin["events"] == events, r
        assert pin["mask"] == mask == [True, False, True, True]
        assert pin["finite"]
        np.testing.assert_allclose(pin["losses"], [h["loss"] for h in hist if "loss" in h],
                                   atol=1e-5, rtol=0)
    masks = [row[0] for row in recs[0]["pin"]["rows"]]
    healthy, sick = [True] * WORLD, [True, False, True, True]
    assert masks == [healthy] * 3 + [sick] * 3 + [healthy] * 2


def test_flipped_voter_under_enforce_tracks_clean_w_minus_1(ranks):
    """tests/test_vote_guard.py:463-493's bounds: the adversary quarantined
    as an outlier; enforce within 0.35 nats of the clean W−1 run over the
    last 10 steps, guard off at least 0.1 worse."""
    _, recs = ranks
    rec = recs[0]

    def tail(x):
        return float(np.mean(x[-10:]))

    rep = rec["flip_enforce"]["report"]
    assert rep["healthy_mask"] == [True, False, True, True]
    assert rep["sick_workers"]["1"]["outlier"] > 0
    gap_enforce = abs(tail(rec["flip_enforce"]["losses"]) - tail(rec["clean"]))
    gap_off = abs(tail(rec["flip_off"]) - tail(rec["clean"]))
    assert gap_enforce < 0.35, (gap_enforce, gap_off)
    assert gap_off > gap_enforce + 0.1, (gap_enforce, gap_off)


def test_nan_rank_poisons_only_its_own_momentum_without_guard(ranks):
    _, recs = ranks
    assert [rec["nan_off"]["finite"] for rec in recs] == [True, True, True, False]
    assert all(rec["nan_off"]["losses_finite"] for rec in recs)
    for rec in recs:
        assert rec["nan_enforce"] == {"finite": True, "mask": [True, True, True, False]}


def test_observe_keeps_the_elections_of_guard_off(ranks):
    """tests/test_vote_guard.py::test_observe_mode_keeps_elections_untouched:
    a poisoned run under observe has guard off's losses and params, bit for
    bit, and reports the rank enforce would quarantine."""
    _, recs = ranks
    for rec in recs:
        assert rec["observe"] == {"same": True, "sick": ["3"], "mask": [True] * WORLD}


def test_min_quorum_refusal(ranks):
    _, recs = ranks
    for rec in recs:
        assert "quorum" in rec["quorum"] and "below --min_quorum 4" in rec["quorum"]


def test_quarantine_mask_restored_exactly(ranks):
    _, recs = ranks
    for rec in recs:
        got = rec["mask_resume"]
        assert got["saved"] == [True, True, False, True]
        assert got["step"] == 6
        assert got["health"] == got["guard"] == got["saved"]


def test_guard_toggle_across_a_checkpoint(ranks):
    _, recs = ranks
    for rec in recs:
        assert rec["toggle_off"] == [4, True, True]
        assert rec["toggle_on"] == [4, [True] * WORLD, 0]


def test_elastic_resume_heals_quarantined_momentum(ranks):
    """W 4 -> 2 with rank 1 quarantined and its momentum 1e9: its row is
    re-averaged from the healthy mean before the remap (JAX's heal and remap
    on the saved rows, bit for bit); the guard restarts all healthy."""
    import jax.numpy as jnp

    from distributed_lion_tpu.optim import heal_worker_momentum as j_heal
    from distributed_lion_tpu.optim import remap_worker_momentum as j_remap

    out, recs = ranks
    ck = out / "elastic" / "checkpoints" / "5"
    rows = np.stack([torch.load(ck / f"exp_avg/rank{r:05d}.pt", weights_only=True).numpy()
                     for r in range(WORLD)])
    assert (rows[1] == 1e9).all()
    healed = j_heal({"m": jnp.asarray(rows)}, np.array([True, False, True, True]), [1])
    want = np.asarray(j_remap(healed, WORLD, 2)["m"])
    for r in range(2):
        got = recs[r]["elastic"]
        assert got["step"] == 5 and got["health"] == [True, True]
        np.testing.assert_array_equal(np.asarray(got["exp_avg"], np.float32), want[r])
        assert np.abs(want[r]).max() < 1e8


def test_guard_metrics_are_strict_json(ranks):
    out, _ = ranks
    path = out / "mask" / "metrics.jsonl"
    proc = subprocess.run([sys.executable, "scripts/validate_metrics.py", str(path)],
                          capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    assert any("train/guard_healthy" in r for r in rows)
    assert any(r.get("train/guard_healthy_mask") == [True, True, False, True] for r in rows)
