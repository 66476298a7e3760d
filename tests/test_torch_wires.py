"""Two gloo ranks on the CPU vs the JAX package's ``data=2`` mesh, over
the three flat wires.

Each rank forms ballots from its own (g, m) with the port's ballot pass
and votes them over the port's wire; the elections must be bit-identical
to the JAX package's ``vote_total`` on the same ballots, and the bytes the
port hands the backend (``WireTally``) must equal
``codec.wire_bytes_per_param``. Each rank then takes one bucketed optimizer
step (3 buckets), whose params must be bit-identical to the JAX
``distributed_lion(kernel="pallas")`` step on the mesh.

This file imports jax only inside the test function, so the spawned ranks
import torch alone.
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.ops import fused_lion
from distributed_lion_tpu_torch.optim.distributed_lion import distributed_lion
from distributed_lion_tpu_torch.optim.lion import FlatParams
from distributed_lion_tpu_torch.parallel import collectives

WIRES = ("sign_psum", "packed_allgather", "packed_a2a")
N = 1003
BUCKETS = 3


def _rank(rank, world, init, out, g, m, p):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        gt, mt = torch.from_numpy(g[rank]), torch.from_numpy(m[rank])
        for wire in WIRES:
            tally = collectives.WireTally()
            ballots = fused_lion.fused_ballots(gt, mt, 0.9)
            before = ballots.clone()
            kept = collectives.vote_total(ballots, wire, dist.group.WORLD, keep_ballots=True)
            assert torch.equal(ballots, before), f"{wire}: keep_ballots wrote the ballots"
            tot = collectives.vote_total(ballots, wire, dist.group.WORLD, tally)
            assert torch.equal(tot, kept), f"{wire}: the kept ballots' tally differs"
            np.save(f"{out}/{wire}_elected_{rank}.npy", (tot > 0).numpy())
            np.save(f"{out}/{wire}_bytes_{rank}.npy", np.int64(tally.total()))

            flat = FlatParams([("p", torch.nn.Parameter(torch.from_numpy(p.copy())))])
            step_tally = collectives.WireTally()
            opt = distributed_lion(0.02, weight_decay=0.0, wire=wire,
                                   vote_buckets=BUCKETS, tally=step_tally)
            state = opt.init(flat)
            state.exp_avg.copy_(mt)
            flat.grads.copy_(gt)
            opt.step(flat, state)
            np.save(f"{out}/{wire}_params_{rank}.npy", flat.params.numpy())
            np.save(f"{out}/{wire}_step_bytes_{rank}.npy", np.int64(step_tally.total()))
    finally:
        dist.destroy_process_group()


def test_two_rank_wires_match_jax_mesh(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.ops import codec as jcodec
    from distributed_lion_tpu.optim import distributed_lion as j_distributed_lion
    from distributed_lion_tpu.optim import init_global_state
    from distributed_lion_tpu.optim.sharded import make_sharded_step, shard_state
    from distributed_lion_tpu.parallel import collectives as jcoll
    from distributed_lion_tpu.parallel import make_mesh

    rng = np.random.default_rng(5)
    g = rng.normal(size=(2, N)).astype(np.float32)
    m = rng.normal(size=(2, N)).astype(np.float32)
    p = rng.normal(size=N).astype(np.float32)
    mp.spawn(_rank, args=(2, str(tmp_path / "pg"), str(tmp_path), g, m, p),
             nprocs=2, join=True)

    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    ballots = np.where(0.9 * m + (1.0 - 0.9) * g > 0, 1, -1)
    for wire in WIRES:
        elect = jax.jit(jax.shard_map(
            lambda b, wire=wire: jcoll.vote_total(b[0] > 0, "data", wire)[None] > 0,
            mesh=mesh, in_specs=P("data"), out_specs=P("data"), check_vma=False))
        want = np.asarray(elect(jnp.asarray(ballots, jnp.int8)))
        for r in range(2):
            got = np.load(tmp_path / f"{wire}_elected_{r}.npy")
            np.testing.assert_array_equal(got, want[r])
            acct = jcodec.wire_bytes_per_param(N, 2, wire)["bytes_per_step"]
            assert int(np.load(tmp_path / f"{wire}_bytes_{r}.npy")) == acct
            acct_b = jcodec.wire_bytes_per_param(N, 2, wire, vote_buckets=BUCKETS)
            assert int(np.load(tmp_path / f"{wire}_step_bytes_{r}.npy")) == acct_b["bytes_per_step"]

        opt = j_distributed_lion(learning_rate=0.02, weight_decay=0.0, wire=wire,
                                 kernel="pallas", vote_buckets=BUCKETS)
        params = {"p": jnp.asarray(p)}
        state = init_global_state(opt, params, 2)
        state = shard_state(state._replace(exp_avg={"p": jnp.asarray(m)}), mesh)
        new_p, _ = make_sharded_step(opt, mesh)(params, {"p": jnp.asarray(g)}, state)
        for r in range(2):
            np.testing.assert_array_equal(np.load(tmp_path / f"{wire}_params_{r}.npy"),
                                          np.asarray(new_p["p"]))
