"""The vote across four ranks: spawned gloo ranks on the CPU against the
JAX package on a ``data=4`` mesh.

The gate: a tiny GPT-2 at float32 trains on 4 ranks on the ``sign_psum``
and the ``hier:2`` wires, against the JAX ``Trainer.for_gpt2`` on the
mesh, both from the same ``gpt2_init`` params and the same
``batch_iterator`` batches (3 steps x accumulation 2, dropout 0, weight
decay 0, constant LR). Bounds, those of the one-rank slice test
(tests/test_torch_gpt2.py): per-step losses within 1e-5, at least 99.9% of
the final params bit-equal, every coordinate within ``2·lr·steps`` (a
flipped election moves a coordinate by 2·lr), and all four ranks' params
equal. Then the optimizer alone at W in {2, 4} on all four wires with 3
buckets, from the same per-rank grads and momenta: elections and
decay-free params bit-identical to JAX's fused step, momentum within rtol
1e-6. Last, the multi-node layout: ``WORLD_SIZE=4, LOCAL_WORLD_SIZE=2``
resolves ``--wire auto`` to ``hier:2``, and ``run_clm`` trains on it under
``DLION_PLATFORM=cpu``.

One spawn of four ranks runs all the W = 4 work (the ``four_ranks``
fixture); the tests compare what it wrote. This file imports jax only
inside the tests and the fixture, so the spawned ranks import torch alone.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.cli import run_clm
from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.ops.codec import unpack_signs
from distributed_lion_tpu_torch.optim.distributed_lion import distributed_lion
from distributed_lion_tpu_torch.optim.lion import FlatParams
from distributed_lion_tpu_torch.parallel.mesh import data_grid
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.utils.serialization import params_from_jax, save_pytree

WORLD = 4
LR, STEPS = 3e-3, 3
GATE_WIRES = ("sign_psum", "hier:2")
WIRES = ("sign_psum", "packed_allgather", "packed_a2a", "hier:2")
COMMON = dict(lion=True, async_grad=True, learning_rate=LR, weight_decay=0.0,
              lr_scheduler_type="constant", max_steps=STEPS, per_device_train_batch_size=2,
              gradient_accumulation_steps=2, block_size=32, logging_steps=1, eval_steps=1000,
              seed=0)
N = 1003
BUCKETS = 3


def _name(wire):
    return wire.replace(":", "")


def optimizer_inputs(world):
    """Per-rank grads and momenta [W, N] and shared params [N], float32."""
    rng = np.random.default_rng(world)
    g = rng.normal(size=(world, N)).astype(np.float32)
    m = rng.normal(size=(world, N)).astype(np.float32)
    return g, m, rng.normal(size=N).astype(np.float32)


def _optimizer_steps(rank, world, out):
    """One 3-bucket step per wire from ``optimizer_inputs``; writes the
    election (from the telemetry frame), the params and the momentum."""
    g, m, p = optimizer_inputs(world)
    for wire in WIRES:
        flat = FlatParams([("p", torch.nn.Parameter(torch.from_numpy(p.copy())))])
        opt = distributed_lion(0.02, weight_decay=0.0, wire=wire, vote_buckets=BUCKETS,
                               telemetry=True)
        state = opt.init(flat)
        state.exp_avg.copy_(torch.from_numpy(m[rank]))
        flat.grads.copy_(torch.from_numpy(g[rank]))
        state, frame = opt.step(flat, state)
        prefix = f"{out}/w{world}_{_name(wire)}"
        np.save(f"{prefix}_elected_{rank}.npy", unpack_signs(frame["elected"], (N,)).numpy())
        np.save(f"{prefix}_params_{rank}.npy", flat.params.numpy())
        np.save(f"{prefix}_momentum_{rank}.npy", state.exp_avg.numpy())


def _init(rank, world, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/pg", rank=rank,
                            world_size=world)


def _four_rank_work(rank, out):
    _init(rank, WORLD, out)
    try:
        blocks = synthetic_lm_dataset(256, 32, 256)
        for wire in GATE_WIRES:
            tr = Trainer.for_gpt2(TrainConfig(**COMMON, wire=wire),
                                  GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.0),
                                  device="cpu", initial_params=params_from_jax(f"{out}/init.npz"),
                                  grid=data_grid(dist.group.WORLD))
            hist = tr.train(batch_iterator(blocks, tr.global_train_batch(), seed=0))
            tr.close()
            np.save(f"{out}/{_name(wire)}_loss_{rank}.npy", np.array([h["loss"] for h in hist]))
            # the flat buffer holds the params in the JAX package's leaf order
            np.save(f"{out}/{_name(wire)}_params_{rank}.npy", tr.flat.params.numpy())
        _optimizer_steps(rank, WORLD, out)
        # what torchrun sets for two nodes of two ranks each; run_clm takes
        # the process group already started
        os.environ.update(WORLD_SIZE=str(WORLD), RANK=str(rank), LOCAL_WORLD_SIZE="2",
                          LOCAL_RANK=str(rank % 2), DLION_PLATFORM="cpu")
        tr = run_clm.main(["--model_name", "tiny", "--dataset", "synthetic",
                           "--synthetic_blocks", "64", "--block_size", "32",
                           "--per_device_train_batch_size", "2",
                           "--gradient_accumulation_steps", "1", "--max_steps", "2",
                           "--logging_steps", "1", "--dropout", "0"])
        losses = [h["loss"] for h in tr.history if "loss" in h]
        np.save(f"{out}/auto_{rank}.npy", np.array(
            [tr.cfg.wire == "hier:2", tr.device.type == "cpu", len(losses) == 2,
             all(np.isfinite(losses))]))
    finally:
        dist.destroy_process_group()


def _two_rank_work(rank, out):
    _init(rank, 2, out)
    try:
        _optimizer_steps(rank, 2, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The directory the four spawned ranks wrote their results into."""
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.models.gpt2 import gpt2_init

    out = tmp_path_factory.mktemp("w4")
    init = gpt2_init(jax.random.key(COMMON["seed"]),
                     JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0))
    # through a file: spawn writes its arguments into a pipe, and arguments
    # larger than the pipe's buffer would start the ranks one by one
    save_pytree(out / "init.npz", jax.tree.map(np.asarray, init))
    mp.spawn(_four_rank_work, args=(str(out),), nprocs=WORLD, join=True)
    return out


def test_four_rank_gpt2_matches_jax_trainer_at_data_4(four_ranks):
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.data.sources import batch_iterator as j_batch_iterator
    from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer
    from distributed_lion_tpu.utils.serialization import load_pytree as j_load_pytree

    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    blocks = j_synthetic(256, 32, 256)
    np.testing.assert_array_equal(synthetic_lm_dataset(256, 32, 256), blocks)
    init = j_load_pytree(four_ranks / "init.npz")
    for wire in GATE_WIRES:
        jtr = JTrainer.for_gpt2(JTrainConfig(**COMMON, wire=wire), mesh,
                                JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0))
        jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jtr.params), init)
        jhist = jtr.train(j_batch_iterator(blocks, jtr.global_train_batch(), seed=0))
        jtr.close()
        want = np.concatenate([np.asarray(v).reshape(-1) for v in jax.tree.leaves(jtr.params)])
        got = np.load(four_ranks / f"{_name(wire)}_params_0.npy")
        for r in range(WORLD):
            np.testing.assert_allclose(np.load(four_ranks / f"{_name(wire)}_loss_{r}.npy"),
                                       [h["loss"] for h in jhist], atol=1e-5, rtol=0)
            np.testing.assert_array_equal(np.load(four_ranks / f"{_name(wire)}_params_{r}.npy"),
                                          got)
        assert got.shape == want.shape
        assert np.mean(got == want) >= 0.999, wire
        assert np.max(np.abs(got - want)) <= 2 * LR * STEPS * (1 + 1e-6), wire


@pytest.mark.parametrize("world", [2, 4])
def test_optimizer_step_on_every_wire_matches_jax(world, request, tmp_path):
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.optim import distributed_lion as j_distributed_lion
    from distributed_lion_tpu.optim import init_global_state
    from distributed_lion_tpu.optim.sharded import make_sharded_step, shard_state
    from distributed_lion_tpu.parallel import make_mesh

    if world == WORLD:
        out = request.getfixturevalue("four_ranks")
    else:
        out = tmp_path
        mp.spawn(_two_rank_work, args=(str(out),), nprocs=world, join=True)
    g, m, p = optimizer_inputs(world)
    mesh = make_mesh(data=world, devices=jax.devices()[:world])
    for wire in WIRES:
        opt = j_distributed_lion(learning_rate=0.02, weight_decay=0.0, wire=wire,
                                 kernel="pallas", vote_buckets=BUCKETS)
        params = {"p": jnp.asarray(p)}
        state = init_global_state(opt, params, world)
        state = shard_state(state._replace(exp_avg={"p": jnp.asarray(m)}), mesh)
        new_p, new_state = make_sharded_step(opt, mesh)(params, {"p": jnp.asarray(g)}, state)
        want_p = np.asarray(new_p["p"])
        elected = want_p < p  # weight decay 0: p - lr·(+1) < p where +1 was elected
        prefix = out / f"w{world}_{_name(wire)}"
        for r in range(world):
            np.testing.assert_array_equal(np.load(f"{prefix}_elected_{r}.npy"), elected)
            np.testing.assert_array_equal(np.load(f"{prefix}_params_{r}.npy"), want_p)
            np.testing.assert_allclose(np.load(f"{prefix}_momentum_{r}.npy"),
                                       np.asarray(new_state.exp_avg["p"])[r], rtol=1e-6, atol=0)


def test_multi_node_auto_wire_resolves_to_hier_and_trains(four_ranks):
    for r in range(WORLD):
        assert np.load(four_ranks / f"auto_{r}.npy").tolist() == [True, True, True, True]
