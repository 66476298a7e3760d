"""``steps_per_call``: chunked dispatch, port against the JAX trainer
(tests/test_train.py::test_chunked_steps_match_single_exact,
tests/test_vote_guard.py::test_guard_chunked_dispatch_counts_every_step).

- At W = 1, k = 4 over 40 steps (dropout on, so every step's seed counts)
  is ``torch.equal`` in params and momentum to k = 1; logs, evals and saves
  fire on the crossed multiples ``[12, 20, 32, 40]`` at interval 10; each
  logged loss is the mean of its chunk's four per-step losses (``rtol
  1e-6``: a float32 mean of four).
- JAX's chunked trainer (``lax.scan``, k = 2) on the same tiny weights and
  batches: chunk-mean losses within 1e-5 (the bound of the port's other
  trainer comparisons) and the final params ≥ 99.9% bit-equal, every
  coordinate within 2·lr·steps (the key bias's gradient is float noise on
  both sides, ROADMAP Queue 3).
- Three gloo ranks, spawned once (``ranks``): rank 2 poisoned with NaN
  grads under ``vote_guard enforce`` and k = 3 is quarantined on the first
  applied window (its three bad steps arrive in one observation), and a
  mixed float32/bfloat16 tree's W = 3 vote (Distributed Lion, 3 steps)
  gives JAX's packed ballots and elections bit for bit on a ``data=3``
  mesh, its params as tests/test_torch_mixed_dtype.py states (which holds
  the W = 1 case). Three, not two: at W = 2 a tie elects −1, so a NaN
  voter (−1 everywhere) carries every election and the honest rank, which
  then disagrees with half of them, is an outlier too, in either package;
  W = 3 is the smallest world where only the sick rank is flagged, as in
  the JAX test's W = 4.
- Every trainer runs with ``remat`` off: the same numbers, a third of the
  JAX compile.

jax is imported inside the tests only, so the spawned ranks import torch
alone.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.cli import run_dpo, run_sft
from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.optim.distributed_lion import distributed_lion
from distributed_lion_tpu_torch.optim.lion import FlatParams
from distributed_lion_tpu_torch.parallel.mesh import data_grid
from distributed_lion_tpu_torch.train import resilience
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.utils.argparsing import parse_dataclasses
from distributed_lion_tpu_torch.utils.serialization import params_from_jax, params_to_jax

torch.set_num_threads(2)

COMMON = dict(lion=True, async_grad=True, learning_rate=3e-3, weight_decay=0.0,
              warmup_steps=5, per_device_train_batch_size=2, gradient_accumulation_steps=2,
              per_device_eval_batch_size=2, block_size=32, eval_iters=1, seed=0)
MIXED = {"a": ((130,), torch.float32), "b": ((33, 7), torch.bfloat16),
         "c": ((1001,), torch.float32)}
MIXED_LR = 0.05


def _train(cfg: TrainConfig, blocks, eval_blocks=None, **model):
    tr = Trainer.for_gpt2(cfg, GPT2Config.tiny(compute_dtype=torch.float32, remat=False,
                                               **model), device="cpu")
    try:
        hist = tr.train(batch_iterator(blocks, tr.global_train_batch(), seed=0), eval_blocks)
    finally:
        tr.close()
    return tr, hist


def test_chunks_equal_single_steps_and_cross_every_boundary(tmp_path):
    blocks = synthetic_lm_dataset(512, 32, 256)
    tk, hk = _train(TrainConfig(**COMMON, steps_per_call=4, max_steps=40, logging_steps=10,
                                eval_steps=10, save_steps=10, save_total_limit=None,
                                output_dir=str(tmp_path)), blocks, blocks[:4], dropout=0.1)
    t1, h1 = _train(TrainConfig(**COMMON, steps_per_call=1, max_steps=40, logging_steps=1,
                                eval_steps=1000), blocks, dropout=0.1)
    assert tk.step_count == t1.step_count == 40
    assert torch.equal(tk.flat.params, t1.flat.params)
    assert torch.equal(tk.state.exp_avg, t1.state.exp_avg)
    logged = [h for h in hk if "loss" in h]
    assert [h["step"] for h in logged] == [12, 20, 32, 40]
    assert [h["step"] for h in hk if "eval/loss" in h] == [12, 20, 32, 40]
    saved = sorted(int(p.name) for p in (tmp_path / "checkpoints").iterdir() if p.name.isdigit())
    assert saved == [12, 20, 32, 40]
    per_step = [h["loss"] for h in h1]
    for h in logged:
        np.testing.assert_allclose(h["loss"], np.mean(per_step[h["step"] - 4:h["step"]]),
                                   rtol=1e-6)


def test_tail_runs_step_by_step_and_flags_parse():
    blocks = synthetic_lm_dataset(64, 32, 256)
    tr, hist = _train(TrainConfig(**COMMON, steps_per_call=4, max_steps=6, logging_steps=1),
                      blocks)
    # one chunk of 4 (logged at its end: 4 % 1 < 4), then the tail of 2 step by step
    assert [h["step"] for h in hist] == [4, 5, 6]
    with pytest.raises(ValueError, match="steps_per_call must be >= 1"):
        _train(TrainConfig(**COMMON, steps_per_call=0, max_steps=1), blocks)
    for cli, args in ((run_sft, run_sft.SFTArguments), (run_dpo, run_dpo.DPOArguments)):
        _, cfg = parse_dataclasses((args, TrainConfig), ["--steps_per_call", "3"])
        assert cfg.steps_per_call == 3


def test_chunked_trainer_matches_jax_chunked_trainer():
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.data.sources import batch_iterator as j_batch_iterator
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer

    lr, steps = 3e-3, 4
    common = dict(COMMON, learning_rate=lr, lr_scheduler_type="constant", max_steps=steps,
                  steps_per_call=2, logging_steps=1, eval_steps=1000)
    jtr = JTrainer.for_gpt2(JTrainConfig(**common), make_mesh(data=1, devices=jax.devices()[:1]),
                            JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0, remat=False))
    init = jax.tree.map(np.asarray, jtr.params)
    blocks = synthetic_lm_dataset(64, 32, 256)
    jhist = jtr.train(j_batch_iterator(blocks, jtr.global_train_batch(), seed=0))
    jtr.close()

    ttr = Trainer.for_gpt2(TrainConfig(**common),
                           GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.0,
                                           remat=False),
                           device="cpu", initial_params=params_from_jax(init))
    thist = ttr.train(batch_iterator(blocks, ttr.global_train_batch(), seed=0))
    ttr.close()
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [2, 4]
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist],
                               atol=1e-5, rtol=0)
    got = np.concatenate([v.reshape(-1) for v in jax.tree.leaves(params_to_jax(ttr.model))])
    want = np.concatenate([np.asarray(v).reshape(-1) for v in jax.tree.leaves(jtr.params)])
    assert np.mean(got == want) >= 0.999
    assert np.max(np.abs(got - want)) <= 2 * lr * steps * (1 + 1e-6)


# ---------------------------------------------------------- three gloo ranks
WORLD = 3


def _mixed(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (torch.from_numpy(rng.normal(size=s).astype(np.float32)) * scale).to(dt)
            for k, (s, dt) in MIXED.items()}


def _rank(rank: int, world: int, init: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        # the guard under chunked dispatch: rank 2's grads NaN from step 0
        cfg = TrainConfig(**dict(COMMON, warmup_steps=0, lr_scheduler_type="constant"),
                          wire="sign_psum", max_steps=9, steps_per_call=3, logging_steps=3,
                          vote_guard="enforce", inject_poison="nan_grads:2", guard_strikes=3)
        tr = Trainer.for_gpt2(cfg, GPT2Config.tiny(compute_dtype=torch.float32, remat=False),
                              device="cpu", grid=data_grid(dist.group.WORLD))
        try:
            tr.train(batch_iterator(synthetic_lm_dataset(96, 32, 256, seed=4),
                                    tr.global_train_batch(), seed=0))
        finally:
            tr.close()
            resilience.clear_faults()
        if rank == 0:
            torch.save({"health": tr.state.health.tolist(),
                        "quarantined_at": [int(s) for s in tr._guard.quarantined_at],
                        "report": tr._guard.sick_report(),
                        "momentum_finite": bool(torch.isfinite(tr.state.exp_avg).all())},
                       f"{out}/guard.pt")

        # a mixed float32/bfloat16 tree's vote at W = 3
        flat = FlatParams([(k, torch.nn.Parameter(v)) for k, v in _mixed(0).items()])
        opt = distributed_lion(MIXED_LR, weight_decay=0.1, vote_buckets=2, guard="observe",
                               group=dist.group.WORLD)
        state = opt.init(flat)
        ballots, params = [], []
        for s in range(3):
            views = flat.views(flat.grad_bufs)
            for k, v in _mixed(10 + 10 * s + rank, 0.1).items():
                views[k].copy_(v)
            state, _ = opt.step(flat, state)
            ballots.append(state.prev_ballot.clone())
            params.append({k: v.float().clone() for k, v in flat.views(flat.param_bufs).items()})
        torch.save({"ballots": ballots, "params": params}, f"{out}/mixed_{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("w2")
    mp.spawn(_rank, args=(WORLD, str(out / "pg"), str(out)), nprocs=WORLD, join=True)
    return out


def test_guard_quarantines_on_the_first_chunk_window(ranks):
    got = torch.load(ranks / "guard.pt")
    assert got["health"] == [True, True, False]
    # chunk 1 (steps 1-3) is folded after chunk 2 is issued: quarantined at step 3
    assert got["quarantined_at"][2] == 3
    assert list(got["report"]["sick_workers"]) == ["2"]
    assert got["report"]["sick_workers"]["2"]["nonfinite"] >= 3
    assert got["momentum_finite"]


def test_mixed_tree_vote_at_three_ranks_matches_jax(ranks):
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.optim import distributed_lion as j_distributed_lion
    from distributed_lion_tpu.optim import init_global_state
    from distributed_lion_tpu.optim.sharded import make_sharded_step, shard_state
    from distributed_lion_tpu.parallel import make_mesh

    def jtree(t):
        return {k: jnp.asarray(v.float().numpy()).astype(
            jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32) for k, v in t.items()}

    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    jopt = j_distributed_lion(learning_rate=MIXED_LR, weight_decay=0.1, vote_buckets=2,
                              guard="observe")
    jp = jtree(_mixed(0))
    jstate = shard_state(init_global_state(jopt, jp, WORLD), mesh)
    jstep = make_sharded_step(jopt, mesh, has_guard=True)
    got = [torch.load(ranks / f"mixed_{r}.pt") for r in range(WORLD)]
    decay = 1.0 - MIXED_LR * 0.1
    for s in range(3):
        per_rank = [jtree(_mixed(10 + 10 * s + r, 0.1)) for r in range(WORLD)]
        grads = {k: jnp.stack([g[k] for g in per_rank]) for k in MIXED}
        jbefore = {k: np.asarray(v.astype(jnp.float32)) for k, v in jp.items()}
        jp, jstate, _ = jstep(jp, grads, jstate)
        for r in range(WORLD):
            np.testing.assert_array_equal(got[r]["ballots"][s].numpy(),
                                          np.asarray(jstate.prev_ballot)[r],
                                          err_msg=f"rank {r} step {s}")
            before = (got[r]["params"][s - 1] if s else
                      {k: v.float() for k, v in _mixed(0).items()})
            for k, (_, dt) in MIXED.items():
                want = np.asarray(jp[k].astype(jnp.float32))
                have = got[r]["params"][s][k].numpy()
                # the elections: the sign each coordinate moved against its decay
                np.testing.assert_array_equal(have - before[k].numpy() * decay > 0,
                                              want - jbefore[k] * decay > 0, err_msg=k)
                if dt == torch.bfloat16:   # two bfloat16 ulps a step: the apply
                    # kernel's one rounding against the XLA path's per-op ones
                    ulp = 2.0 ** (np.floor(np.log2(np.max(np.abs(want)))) - 7)
                    np.testing.assert_allclose(have, want, rtol=0, atol=2 * (s + 1) * ulp,
                                               err_msg=k)
                else:   # one float32 ulp a step: XLA:CPU's FMAs
                    ulp = np.spacing(np.float32(np.max(np.abs(want))))
                    np.testing.assert_allclose(have, want, rtol=1e-6, atol=(s + 1) * ulp,
                                               err_msg=k)
