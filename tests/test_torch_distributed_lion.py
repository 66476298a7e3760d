"""The port's majority-vote optimizer vs the JAX package's
``distributed_lion(kernel="pallas")`` (interpret mode, ``data=1`` mesh):
3 steps with fresh grads each step, from the same params; also at
bfloat16 momentum under float32 params (``mom_dtype``), where elections
must be bit-identical and the momentum within one bfloat16 ulp of its
largest magnitude per step (the Pallas body's float32 ``m*b2 + g*(1-b2)``
is one FMA on the CPU before its one rounding to bfloat16, the port's
kernel two float32 roundings before it).

Elections (at W = 1, the rank's own ballots) must be bit-identical. With
weight decay 0 the params must be too. With weight decay > 0 the JAX
reference rounds ``p*(1-lr*wd) - lr*s`` as one FMA on the CPU (see
tests/test_torch_fused_lion.py), the port as two roundings. Its
``m*b2 + g*(1-b2)`` is one FMA too. So params (with decay) and momentum are
held to ``rtol=1e-6`` plus one float32 ulp per step at their largest
magnitude: where the two addends cancel, the FMA's one-ulp difference is
an ulp of the addends, not of the result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_lion_tpu.ops import pallas_lion
from distributed_lion_tpu.optim import distributed_lion as j_distributed_lion
from distributed_lion_tpu.optim import init_global_state
from distributed_lion_tpu.optim.sharded import make_sharded_step, shard_state
from distributed_lion_tpu.parallel import make_mesh
from distributed_lion_tpu_torch.ops import fused_lion
from distributed_lion_tpu_torch.optim.distributed_lion import distributed_lion
from distributed_lion_tpu_torch.optim.lion import FlatParams, Lion
from distributed_lion_tpu_torch.parallel import collectives

# tiny shapes: more intra-op threads only add contention with the other
# test workers
torch.set_num_threads(2)

SHAPES = {"b": (130,), "w": (33, 7), "z": (1001,)}  # jax.tree.leaves order


def _flat_of(tree):
    return np.concatenate([np.asarray(tree[k]).reshape(-1) for k in SHAPES])


@pytest.mark.parametrize("buckets", [1, 4])
@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_optimizer_matches_jax_pallas_w1(buckets, wd):
    rng = np.random.default_rng(3)
    p_np = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=(1,) + s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]

    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    jopt = j_distributed_lion(learning_rate=0.02, weight_decay=wd, kernel="pallas",
                              vote_buckets=buckets)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jstate = shard_state(init_global_state(jopt, jp, 1), mesh)
    jstep = make_sharded_step(jopt, mesh)

    flat = FlatParams([(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
                       for k, v in p_np.items()])
    topt = distributed_lion(0.02, weight_decay=wd, vote_buckets=buckets)
    assert topt.world == 1 and topt.group is None
    tstate = topt.init(flat)
    for g in grads:
        g_flat = _flat_of({k: v[0] for k, v in g.items()})
        m_jax = _flat_of({k: v[0] for k, v in jstate.exp_avg.items()})
        elected_jax = np.asarray(pallas_lion.fused_ballots(
            jnp.asarray(g_flat), jnp.asarray(m_jax), 0.9, interpret=True)) > 0
        jp, jstate = jstep(jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate)

        flat.grads.copy_(torch.from_numpy(g_flat))
        elected = fused_lion.fused_ballots(flat.grads, tstate.exp_avg, 0.9) > 0
        tstate = topt.step(flat, tstate)
        np.testing.assert_array_equal(elected.numpy(), elected_jax)

    got_p, want_p = flat.params.numpy(), _flat_of(jp)
    if wd == 0.0:
        np.testing.assert_array_equal(got_p, want_p)
    else:
        np.testing.assert_allclose(got_p, want_p, rtol=1e-6,
                                   atol=len(grads) * np.spacing(np.abs(want_p).max()))
    want_m = _flat_of({k: v[0] for k, v in jstate.exp_avg.items()})
    np.testing.assert_allclose(tstate.exp_avg.numpy(), want_m, rtol=1e-6,
                               atol=len(grads) * np.spacing(np.abs(want_m).max()))
    assert int(tstate.count) == int(jstate.count) == 3


@pytest.mark.parametrize("wire", ["sign_psum", "packed_allgather", "packed_a2a"])
def test_one_rank_group_runs_the_wire(tmp_path, wire):
    """In a 1-rank process group the collectives really run (as on the
    card in chip_smoke.py); the tally is the rank's own ballots and no
    bytes are recorded (nothing crosses a wire)."""
    ballots = torch.where(torch.randn(1003) > 0, 1, -1).to(torch.int8)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        tally = collectives.WireTally()
        tot = collectives.vote_total(ballots.clone(), wire, dist.group.WORLD, tally)
        opt = distributed_lion(0.01, wire=wire, vote_buckets=3)
        assert opt.group is dist.group.WORLD
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal((tot > 0).numpy(), (ballots > 0).numpy())
    assert tally.total() == 0


def test_refused_options_name_their_roadmap_item():
    # the DCN pipeline is ported: it builds on a hier wire and is refused,
    # as in the JAX package, on a wire without a cross-group leg
    assert distributed_lion(0.01, wire="hier:1", dcn_pipeline_depth=1).depth == 1
    with pytest.raises(ValueError, match="has no such leg"):
        distributed_lion(0.01, dcn_pipeline_depth=1)
    assert distributed_lion(0.01, guard="enforce").guard == "enforce"  # ported: it builds
    assert distributed_lion(0.01, vote_every=4).vote_every == 4  # ported: it builds
    assert distributed_lion(0.01, telemetry=True).telemetry  # ported: no longer refused
    assert distributed_lion(0.01, max_grad_norm=1.0, seed=0).max_grad_norm == 1.0  # ported
    lazy_stoch = distributed_lion(0.01, vote_every=4, max_grad_norm=1.0, seed=0)  # ported: builds
    assert (lazy_stoch.vote_every, lazy_stoch.max_grad_norm) == (4, 1.0)
    assert isinstance(distributed_lion(0.01, axis_name=None), Lion)
    with pytest.raises(ValueError, match="requires a vote axis"):
        distributed_lion(0.01, axis_name=None, max_grad_norm=1.0)


def test_flat_buffers_are_the_params_and_grads():
    """Params and grads are views of the flat buffers: backward accumulates
    into the flat grad buffer, and an optimizer write is seen by the
    module."""
    lin = torch.nn.Linear(4, 3)
    flat = FlatParams(sorted(lin.named_parameters()))
    lin(torch.ones(2, 4)).sum().backward()
    lin(torch.ones(2, 4)).sum().backward()
    np.testing.assert_array_equal(flat.views(flat.grads)["bias"].numpy(), [4.0, 4.0, 4.0])
    flat.params.fill_(0.5)
    assert torch.all(lin.weight == 0.5)
    flat.zero_grad()
    assert torch.all(lin.bias.grad == 0)
    lin.zero_grad()  # set_to_none: the views are gone
    with pytest.raises(RuntimeError, match="no longer a view"):
        flat.zero_grad()


def test_resolve_auto_comm_matches_jax_decision_table():
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import resolve_auto_comm as j_resolve
    from distributed_lion_tpu_torch.train.loop import TrainConfig, resolve_auto_comm

    for world in (1, 8):
        mesh = make_mesh(data=world, devices=jax.devices()[:world])
        for n in (1000, 124_439_808):
            for kw in ({}, {"vote_every": 1}, {"vote_buckets": 2}, {"wire": "packed_allgather"}):
                want = j_resolve(JTrainConfig(**kw), mesh, n, True)
                got = resolve_auto_comm(TrainConfig(**kw), world, n)
                assert (got.wire, got.vote_every, got.vote_buckets) == \
                    (want.wire, want.vote_every, want.vote_buckets), (world, n, kw)
    multi = resolve_auto_comm(TrainConfig(), 16, 124_439_808, nodes=2, local_world=8)
    assert multi.wire == "hier:8"  # the JAX table's pick, which builds
    assert distributed_lion(0.01, wire=multi.wire).wire == "hier:8"


BF16_STEPS = 3


@pytest.mark.parametrize("buckets", [1, 4])
def test_bf16_momentum_matches_jax_pallas_w1(buckets):
    """``mom_dtype=bfloat16`` under float32 params: the fused path (its
    plain versions here) against JAX's Pallas path in interpret mode."""
    rng = np.random.default_rng(4)
    p_np = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=(1,) + s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(BF16_STEPS)]
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    jopt = j_distributed_lion(learning_rate=0.02, weight_decay=0.0, kernel="pallas",
                              vote_buckets=buckets, mom_dtype=jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jstate = shard_state(init_global_state(jopt, jp, 1), mesh)
    jstep = make_sharded_step(jopt, mesh)

    flat = FlatParams([(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
                       for k, v in p_np.items()])
    topt = distributed_lion(0.02, vote_buckets=buckets, mom_dtype="bfloat16")
    tstate = topt.init(flat)
    assert tstate.exp_avg.dtype == torch.bfloat16 and flat.params.dtype == torch.float32
    for t, g in enumerate(grads, 1):
        m_jax = jnp.concatenate([jstate.exp_avg[k][0].reshape(-1) for k in SHAPES])
        g_flat = _flat_of({k: v[0] for k, v in g.items()})
        elected_jax = np.asarray(pallas_lion.fused_ballots(
            jnp.asarray(g_flat).astype(jnp.bfloat16), m_jax, 0.9, interpret=True)) > 0
        jp, jstate = jstep(jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        flat.grads.copy_(torch.from_numpy(g_flat))
        elected = fused_lion.fused_ballots(flat.grads.bfloat16(), tstate.exp_avg, 0.9) > 0
        tstate = topt.step(flat, tstate)
        np.testing.assert_array_equal(elected.numpy(), elected_jax)
        np.testing.assert_array_equal(flat.params.numpy(), _flat_of(jp))
        want_m = np.concatenate([np.asarray(jstate.exp_avg[k][0].astype(jnp.float32)).reshape(-1)
                                 for k in SHAPES])
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want_m).max())) - 7)
        np.testing.assert_allclose(tstate.exp_avg.float().numpy(), want_m, rtol=0, atol=t * ulp)
    assert tstate.exp_avg.dtype == torch.bfloat16


def _bf16_trainer(out=None, steps=20, **kw):
    from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
    from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer

    cfg = TrainConfig(lion=True, async_grad=True, learning_rate=3e-3, warmup_steps=2,
                      max_steps=steps, per_device_train_batch_size=2,
                      gradient_accumulation_steps=1, block_size=32, logging_steps=1,
                      save_steps=2, output_dir=out, seed=5, **kw)
    return Trainer.for_gpt2(cfg, GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.0),
                            device="cpu")


def _train(t, blocks):
    from distributed_lion_tpu_torch.data.sources import batch_iterator

    h = t.train(batch_iterator(blocks, t.global_train_batch(), seed=5))
    t.close()
    return [x["loss"] for x in h if "loss" in x]


def test_mom_dtype_bf16_trains_and_halves_state():
    """``--mom_dtype bfloat16`` (JAX tests/test_train.py::
    test_mom_dtype_bf16_trains_and_halves_state): the momentum is bf16, the
    optimizer state half the float32 one's bytes, and training converges
    on a memorizable corpus."""
    from distributed_lion_tpu_torch.data.sources import synthetic_lm_dataset

    t = _bf16_trainer(mom_dtype="bfloat16")
    blocks = synthetic_lm_dataset(t.global_train_batch() * 2, 32, 256, seed=3)
    losses = _train(t, blocks)
    assert losses[-1] < losses[0]
    m = t.state.exp_avg
    assert m.dtype == torch.bfloat16 and m.numel() == t.n_params
    assert m.numel() * m.element_size() * 2 == t.flat.params.numel() * 4


def test_bf16_momentum_checkpoint_round_trip(tmp_path):
    """A bf16-momentum run: 2 steps + a resume + 2 steps ``torch.equal`` to
    4 steps, its momentum file bf16; resuming it at float32 momentum
    fails loudly."""
    from distributed_lion_tpu_torch.data.sources import synthetic_lm_dataset
    from distributed_lion_tpu_torch.train.loop import momentum_file

    blocks = synthetic_lm_dataset(64, 32, 256, seed=1)
    ref = _bf16_trainer(steps=4, mom_dtype="bfloat16")
    ref_losses = _train(ref, blocks)
    out = str(tmp_path / "run")
    first = _train(_bf16_trainer(out, 2, mom_dtype="bfloat16"), blocks)
    saved = torch.load(f"{out}/checkpoints/2/{momentum_file(0)}", weights_only=True)
    assert saved.dtype == torch.bfloat16
    t2 = _bf16_trainer(out, 4, mom_dtype="bfloat16")
    assert t2.step_count == 2 and torch.equal(t2.state.exp_avg, saved)
    assert first + _train(t2, blocks) == ref_losses
    assert torch.equal(t2.flat.params, ref.flat.params)
    assert torch.equal(t2.state.exp_avg, ref.state.exp_avg)
    with pytest.raises(RuntimeError, match="failed to restore"):
        _bf16_trainer(out, 6)
