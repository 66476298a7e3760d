"""The port's stochastic binarization (``max_grad_norm``) vs the JAX package.

The two frameworks draw from different random streams, so their ballots
are compared only where the quantizer is deterministic: where ``|u| >= r``
the ballot must equal JAX's ``stochastic_vote_bool`` and the deterministic
ballot, bit for bit. Elsewhere each framework is held on its own to the
quantizer's law: over K draws the mean ballot of every coordinate lies
within 6 binomial standard deviations, ``6·2·sqrt(p(1-p)/K)``, of ``2p - 1``
(plus 1e-6 for the float32 sum); the chance that one of the N coordinates
strays that far by luck is below N·2e-9. The port's draws are reproducible
from ``(seed, count, rank)`` and differ across ranks. A W = 2 gloo step
with every coordinate saturated gives params bit-identical to the JAX
package's XLA path on a ``data=2`` mesh, at float32 (weight decay 0, as the
slice tests use) and at bfloat16 (weight decay 0.1: the XLA path rounds
the decay and the signed step to bfloat16 one after the other, as the port
does).

This file imports jax only inside the test functions, so the spawned ranks
import torch alone.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.ops import lion_math
from distributed_lion_tpu_torch.ops.codec import bucket_bounds
from distributed_lion_tpu_torch.optim.distributed_lion import distributed_lion
from distributed_lion_tpu_torch.optim.lion import FlatParams

B1 = 0.9
MGN = 0.5
R = (1.0 + 1.0 / B1) * MGN
CPU = torch.device("cpu")
N = 1003
BUCKETS = 3
K = 2000  # draws per coordinate in the unbiasedness check


def spread_inputs(n, seed, dtype=np.float32):
    """g, m whose update direction u spans [-1.5 r, 1.5 r]: a third of the
    coordinates saturated, the rest at every probability."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1.5 * R, 1.5 * R, n)
    m = rng.normal(scale=R, size=n)
    g = (u - B1 * m) / (1.0 - B1)
    return g.astype(dtype), m.astype(dtype)


def saturated_inputs(world, n, seed):
    """[W, n] g, m with |u| between 2r and 4r everywhere, signs mixed."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(2 * R, 4 * R, (world, n)) * rng.choice([-1.0, 1.0], (world, n))
    m = rng.uniform(-R, R, (world, n))
    return ((u - B1 * m) / (1.0 - B1)).astype(np.float32), m.astype(np.float32)


def p_up(g, m):
    """The port's probability of a +1 ballot, as numpy float64."""
    return lion_math.stochastic_p_up(torch.from_numpy(g), torch.from_numpy(m), B1,
                                     MGN).double().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_saturated_ballots_equal_jax_and_deterministic(dtype):
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.ops import lion_math as jlm

    g, m = (torch.from_numpy(a).to(dtype) for a in spread_inputs(4096, 1))
    u = lion_math.interp(g, m, B1).to(torch.float32)
    sat = (u.abs() >= R).numpy()
    assert 0.2 < sat.mean() < 0.5  # both kinds of coordinate are present
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jg, jm = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (g, m))
    np.testing.assert_array_equal(
        np.asarray(jlm.interp(jg, jm, B1).astype(jnp.float32)), u.numpy())
    det = lion_math.sign_vote_bool(g, m, B1).numpy()
    for count in range(3):
        got = lion_math.stochastic_vote_bool(
            g, m, B1, MGN, lion_math.stochastic_generator(5, count, 0, CPU)).numpy()
        want = np.asarray(jlm.stochastic_vote_bool(
            jax.random.fold_in(jax.random.key(5), count), jg, jm, B1, MGN))
        np.testing.assert_array_equal(got[sat], want[sat])
        np.testing.assert_array_equal(got[sat], det[sat])


def _assert_unbiased(draws, p):
    """draws: [K, n] bool ballots; p: [n] probabilities of +1."""
    mean = (2.0 * draws - 1.0).mean(0)
    bound = 6 * 2 * np.sqrt(p * (1 - p) / draws.shape[0]) + 1e-6
    worst = np.max(np.abs(mean - (2 * p - 1)) / bound)
    assert worst <= 1.0, f"a coordinate's mean ballot strays {worst:.3f} x the 6-sigma bound"


def test_port_draws_are_unbiased():
    g, m = spread_inputs(512, 2)
    gt, mt = torch.from_numpy(g), torch.from_numpy(m)
    draws = np.stack([lion_math.stochastic_vote_bool(
        gt, mt, B1, MGN, lion_math.stochastic_generator(9, count, 1, CPU)).numpy()
        for count in range(K)])
    _assert_unbiased(draws, p_up(g, m))


def test_jax_draws_are_unbiased():
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.ops import lion_math as jlm

    g, m = spread_inputs(512, 2)
    keys = jax.random.split(jax.random.key(9), K)
    draws = np.asarray(jax.jit(jax.vmap(
        lambda k: jlm.stochastic_vote_bool(k, jnp.asarray(g), jnp.asarray(m), B1, MGN)))(keys))
    _assert_unbiased(draws, p_up(g, m))


def test_draws_replay_from_seed_count_rank():
    gt, mt = (torch.from_numpy(a) for a in spread_inputs(4096, 3))

    def draw(seed, count, rank):
        return lion_math.stochastic_vote_bool(
            gt, mt, B1, MGN, lion_math.stochastic_generator(seed, count, rank, CPU))

    first = draw(42, 7, 0)
    assert torch.equal(first, draw(42, 7, 0))
    for other in (draw(42, 7, 1), draw(42, 8, 0), draw(43, 7, 0)):
        assert not torch.equal(first, other)


def test_stochastic_mode_needs_a_seed():
    with pytest.raises(ValueError, match="pass seed"):
        distributed_lion(0.01, max_grad_norm=1.0)
    with pytest.raises(ValueError, match="max_grad_norm must be > 0"):
        distributed_lion(0.01, max_grad_norm=0.0, seed=0)
    assert distributed_lion(0.01, max_grad_norm=1.0, seed=0).max_grad_norm == 1.0


def test_stoch_flip_frac_is_the_share_of_flipped_ballots():
    """A world of one with telemetry: ``stoch_flip_frac`` is the share of
    coordinates whose stochastic ballot differs from the deterministic one,
    replayed here from the step's generator, bucket after bucket."""
    g, m = spread_inputs(N, 4)
    flat = FlatParams([("p", torch.nn.Parameter(torch.zeros(N)))])
    opt = distributed_lion(0.01, max_grad_norm=MGN, seed=3, vote_buckets=BUCKETS,
                           telemetry=True)
    state = opt.init(flat)
    state.exp_avg.copy_(torch.from_numpy(m))
    flat.grads.copy_(torch.from_numpy(g))
    _, frame = opt.step(flat, state)
    gen = lion_math.stochastic_generator(3, 0, 0, CPU)
    p = p_up(g, m).astype(np.float32)
    stoch = np.concatenate([torch.rand(size, generator=gen).numpy() < p[start:start + size]
                            for start, size in bucket_bounds(N, BUCKETS, 1, "sign_psum")])
    det = (B1 * m + (1 - B1) * g) > 0
    assert frame["stoch_flip_frac"].dtype == torch.float32
    assert float(frame["stoch_flip_frac"]) == np.float32(np.sum(stoch != det) / N)
    assert 0 < float(frame["stoch_flip_frac"]) < 0.5


def _rank(rank, world, init, out, g, m, p):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        for dtype, wd in ((torch.float32, 0.0), (torch.bfloat16, 0.1)):
            flat = FlatParams([("p", torch.nn.Parameter(torch.from_numpy(p).to(dtype)))])
            opt = distributed_lion(0.02, weight_decay=wd, max_grad_norm=MGN, seed=0,
                                   vote_buckets=BUCKETS)
            state = opt.init(flat)
            state.exp_avg.copy_(torch.from_numpy(m[rank]).to(dtype))
            flat.grads.copy_(torch.from_numpy(g[rank]).to(dtype))
            state = opt.step(flat, state)
            assert state.steps == 1 and int(state.count) == 1
            np.save(f"{out}/params_{str(dtype)[6:]}_{rank}.npy", flat.params.float().numpy())
    finally:
        dist.destroy_process_group()


def test_saturated_two_rank_step_matches_jax_xla_path(tmp_path):
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.optim import distributed_lion as j_distributed_lion
    from distributed_lion_tpu.optim import init_global_state
    from distributed_lion_tpu.optim.sharded import make_sharded_step, shard_state
    from distributed_lion_tpu.parallel import make_mesh

    g, m = saturated_inputs(2, N, 6)
    p = np.random.default_rng(8).normal(size=N).astype(np.float32)
    mp.spawn(_rank, args=(2, str(tmp_path / "pg"), str(tmp_path), g, m, p), nprocs=2,
             join=True)
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    for jdt, wd in ((jnp.float32, 0.0), (jnp.bfloat16, 0.1)):
        opt = j_distributed_lion(learning_rate=0.02, weight_decay=wd, max_grad_norm=MGN,
                                 vote_buckets=BUCKETS)
        params = {"p": jnp.asarray(p).astype(jdt)}
        state = init_global_state(opt, params, 2, rng=jax.random.key(0))
        state = shard_state(state._replace(exp_avg={"p": jnp.asarray(m).astype(jdt)}), mesh)
        new_p, _ = make_sharded_step(opt, mesh)(params, {"p": jnp.asarray(g).astype(jdt)},
                                                state)
        want = np.asarray(new_p["p"].astype(jnp.float32))
        for r in range(2):
            got = np.load(tmp_path / f"params_{jnp.dtype(jdt).name}_{r}.npy")
            np.testing.assert_array_equal(got, want)
