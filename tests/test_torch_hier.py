"""The port's ``hier:<g>`` wire on spawned gloo ranks vs the JAX package.

Each rank votes seeded ±1 ballots over ``hier:<g>`` for every g that
divides the world (W = 4: g in {1, 2, 4}; W = 2: g in {1, 2}). The
elections must be bit-identical to the JAX package's ``vote_total`` on a
``data=W`` mesh, and at g = 1 and g = W to the flat ``sign_psum`` vote.
The first 2^W coordinates hold every combination of ballots, so ties occur
at both levels; n = 1003 is not a multiple of 8·g. The bytes each leg
records in the port's ``WireTally`` must equal the JAX package's trace-time
``WIRE_TALLY`` entries, leg for leg, and ``codec.wire_bytes_per_param``.
At W = 4 each rank then takes one 3-bucket optimizer step on ``hier:2``,
whose params must be bit-identical to the JAX
``distributed_lion(kernel="pallas", wire="hier:2", vote_buckets=3)`` step
(float32, weight decay 0).

This file imports jax only inside the test functions, so the spawned ranks
import torch alone.
"""

import itertools

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.ops import codec as tcodec
from distributed_lion_tpu_torch.optim.distributed_lion import distributed_lion
from distributed_lion_tpu_torch.optim.lion import FlatParams
from distributed_lion_tpu_torch.parallel import collectives

N = 1003
BUCKETS = 3
STEP_WIRE = "hier:2"


def group_sizes(world):
    return [g for g in range(1, world + 1) if world % g == 0]


def ballot_matrix(world, seed=11):
    """[W, N] int8 ±1 ballots: every combination of W ballots in the first
    2^W coordinates, seeded coin flips after them."""
    rng = np.random.default_rng(seed)
    b = np.where(rng.random((world, N)) < 0.5, 1, -1).astype(np.int8)
    combos = np.array(list(itertools.product((1, -1), repeat=world)), np.int8).T
    b[:, :combos.shape[1]] = combos
    return b


def _rank(rank, world, init, out, ballots, g, m, p):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        mine = torch.from_numpy(ballots[rank])
        for size in group_sizes(world):
            wire = f"hier:{size}"
            hier = collectives.HierGroups(dist.group.WORLD, size)
            tally = collectives.WireTally()
            tot = collectives.vote_total(mine, wire, dist.group.WORLD, tally, hier=hier)
            assert tot.dtype == torch.int8 and torch.equal(tot.abs(), torch.ones_like(tot))
            np.save(f"{out}/{size}_elected_{rank}.npy", (tot > 0).numpy())
            np.save(f"{out}/{size}_legs_{rank}.npy", np.array(
                [(leg == "dcn", nbytes) for leg, nbytes in tally.entries], np.int64))
        if world == 4:
            # no holder given: vote_total_async builds the groups itself
            tot = collectives.vote_total(mine, STEP_WIRE, dist.group.WORLD)
            np.save(f"{out}/built_elected_{rank}.npy", (tot > 0).numpy())
            flat = FlatParams([("p", torch.nn.Parameter(torch.from_numpy(p.copy())))])
            step_tally = collectives.WireTally()
            opt = distributed_lion(0.02, weight_decay=0.0, wire=STEP_WIRE,
                                   vote_buckets=BUCKETS, tally=step_tally)
            state = opt.init(flat)
            state.exp_avg.copy_(torch.from_numpy(m[rank]))
            flat.grads.copy_(torch.from_numpy(g[rank]))
            opt.step(flat, state)
            np.save(f"{out}/step_params_{rank}.npy", flat.params.numpy())
            np.save(f"{out}/step_bytes_{rank}.npy", np.int64(step_tally.total()))
    finally:
        dist.destroy_process_group()


def _jax_vote(ballots, wire):
    """JAX ``vote_total`` elections on a data=W mesh, and the trace-time
    ``WIRE_TALLY`` entries as ``(is_dcn, bytes)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.parallel import collectives as jcoll
    from distributed_lion_tpu.parallel import make_mesh

    world = ballots.shape[0]
    mesh = make_mesh(data=world, devices=jax.devices()[:world])
    elect = jax.jit(jax.shard_map(
        lambda b: jcoll.vote_total(b[0] > 0, "data", wire)[None] > 0,
        mesh=mesh, in_specs=P("data"), out_specs=P("data"), check_vma=False))
    with jcoll.WIRE_TALLY.capture() as entries:
        out = np.asarray(elect(jnp.asarray(ballots)))
    return out, [(leg == "dcn", nbytes) for leg, nbytes in entries]


@pytest.mark.parametrize("world", [2, 4])
def test_hier_elections_and_bytes_match_jax_mesh(world, tmp_path):
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.ops import codec as jcodec
    from distributed_lion_tpu.optim import distributed_lion as j_distributed_lion
    from distributed_lion_tpu.optim import init_global_state
    from distributed_lion_tpu.optim.sharded import make_sharded_step, shard_state
    from distributed_lion_tpu.parallel import make_mesh

    ballots = ballot_matrix(world)
    rng = np.random.default_rng(7)
    g = rng.normal(size=(world, N)).astype(np.float32)
    m = rng.normal(size=(world, N)).astype(np.float32)
    p = rng.normal(size=N).astype(np.float32)
    mp.spawn(_rank, args=(world, str(tmp_path / "pg"), str(tmp_path), ballots, g, m, p),
             nprocs=world, join=True)

    flat, _ = _jax_vote(ballots, "sign_psum")
    for size in group_sizes(world):
        want, legs = _jax_vote(ballots, f"hier:{size}")
        if size in (1, world):
            np.testing.assert_array_equal(want, flat)
        acct = jcodec.wire_bytes_per_param(N, world, f"hier:{size}")
        assert sum(b for _, b in legs) == acct["bytes_per_step"]
        assert sum(b for dcn, b in legs if dcn) == acct["dcn_bytes_per_step"]
        for r in range(world):
            np.testing.assert_array_equal(np.load(tmp_path / f"{size}_elected_{r}.npy"), want[r])
            got = [tuple(e) for e in np.load(tmp_path / f"{size}_legs_{r}.npy").tolist()]
            assert got == legs, (size, r)
    if world == 2:
        return
    # a majority of group majorities is its own electorate: somewhere in
    # the enumerated combinations hier:2 and the flat vote elect apart
    hier2, _ = _jax_vote(ballots, STEP_WIRE)
    assert np.any(hier2 != flat)
    for r in range(world):
        np.testing.assert_array_equal(np.load(tmp_path / f"built_elected_{r}.npy"), hier2[r])

    opt = j_distributed_lion(learning_rate=0.02, weight_decay=0.0, wire=STEP_WIRE,
                             kernel="pallas", vote_buckets=BUCKETS)
    params = {"p": jnp.asarray(p)}
    state = init_global_state(opt, params, world)
    mesh = make_mesh(data=world, devices=jax.devices()[:world])
    state = shard_state(state._replace(exp_avg={"p": jnp.asarray(m)}), mesh)
    new_p, _ = make_sharded_step(opt, mesh)(params, {"p": jnp.asarray(g)}, state)
    acct = jcodec.wire_bytes_per_param(N, world, STEP_WIRE, vote_buckets=BUCKETS)
    for r in range(world):
        np.testing.assert_array_equal(np.load(tmp_path / f"step_params_{r}.npy"),
                                      np.asarray(new_p["p"]))
        assert int(np.load(tmp_path / f"step_bytes_{r}.npy")) == acct["bytes_per_step"]


@pytest.mark.parametrize("wire", ["hier:1", "hier:2", "hier:4", "hier:8", "hier:200"])
def test_hier_codec_equals_jax(wire):
    from distributed_lion_tpu.ops import codec as jcodec

    assert tcodec.parse_wire(wire) == jcodec.parse_wire(wire)
    size = tcodec.parse_wire(wire)[1]
    for n in (1, 7, 8, 9, 1000, 4101, 124_439_808):
        for w in (size, 2 * size, 8 * size):
            assert tcodec.bucket_alignment(w, wire) == jcodec.bucket_alignment(w, wire)
            for b in (1, 3, 4):
                assert tcodec.bucket_bounds(n, b, w, wire) == jcodec.bucket_bounds(n, b, w, wire)
                got = tcodec.wire_bytes_per_param(n, w, wire, accum_steps=8, vote_buckets=b)
                assert got == jcodec.wire_bytes_per_param(n, w, wire, accum_steps=8,
                                                          vote_buckets=b)


def test_hier_refusals_match_jax():
    from distributed_lion_tpu.ops import codec as jcodec

    for bad in ("hier:x", "hier:", "hier:0", "hier:-2"):
        texts = []
        for parse in (tcodec.parse_wire, jcodec.parse_wire):
            with pytest.raises(ValueError) as err:
                parse(bad)
            texts.append(str(err.value))
        assert texts[0] == texts[1], texts
    for mod in (tcodec, jcodec):  # a group size that does not divide the world
        with pytest.raises(ValueError, match="hier group size 3 does not divide world 4"):
            mod.wire_bytes_per_param(1000, 4, "hier:3")
