"""Mixed param dtypes: a tree of interleaved float32 and bfloat16 leaves
under the port's local Lion and Distributed Lion vs the JAX package's
``lion()`` and its ``distributed_lion`` XLA path (the path JAX takes for a
tree whose leaves do not share one dtype, distributed_lion.py:696-701), at
W = 1 (``data=1`` mesh), every step and under lazy refresh (``vote_every``
4). The W = 3 vote over such a tree rides the 3-rank spawn of
tests/test_torch_steps_per_call.py.

What must match, over 3 steps with weight decay and fresh grads each step:
- the packed ballot bytes (the guard's ``prev_ballot``, JAX's
  ``pack_signs(_flatten_votes(votes))``): bit for bit, every step. The
  port's ballot kernel computes a bfloat16 window's u-term in float32 where
  the XLA path rounds each op in bfloat16, so a ballot whose u-term lies
  within those roundings of zero may differ (996 of 2,000,000 coordinates:
  ROADMAP Queue 3, "Rounding on XLA:CPU"); none of these 271 bfloat16
  coordinates does in these 3 steps;
- the elections: bit for bit (the same bytes at W = 1);
- float32 leaves' params and momentum: ``rtol=1e-6`` plus one float32 ulp a
  step at the leaf's largest magnitude: the port's apply kernel rounds
  each op, where XLA:CPU contracts the multiply-adds into FMAs;
- bfloat16 leaves' params and momentum, every step: two bfloat16 ulps a
  step at the leaf's largest magnitude. The apply kernel computes in
  float32 and rounds once to bfloat16; the XLA path rounds each op in
  bfloat16, with β₂, 1 − β₂ and 1 − lr·wd rounded to bfloat16 first (ROADMAP
  Queue 3, "two apply paths"): up to three half-ulp roundings and the
  factors' error, under two ulps a step. Measured here: at most 2 ulps after
  3 steps. Under lazy refresh both sides take the XLA path's plain ops for
  a bfloat16 momentum, as a single-dtype tree does: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.optim import distributed_lion as j_distributed_lion
from distributed_lion_tpu.optim import init_global_state
from distributed_lion_tpu.optim.lion import lion as j_lion
from distributed_lion_tpu.optim.sharded import make_sharded_step, shard_state
from distributed_lion_tpu.parallel import make_mesh
from distributed_lion_tpu_torch.optim.distributed_lion import distributed_lion
from distributed_lion_tpu_torch.optim.lion import FlatParams, lion, momenta
from distributed_lion_tpu_torch.optim.sharded import shard_state as torch_shard_state
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer

torch.set_num_threads(2)

# jax.tree.leaves order (sorted keys), dtypes interleaved
LEAVES = {"a": ((130,), torch.float32), "b": ((33, 7), torch.bfloat16),
          "c": ((1001,), torch.float32), "d": ((40,), torch.bfloat16),
          "e": ((5, 9), torch.float32)}
LR, WD, STEPS = 0.05, 0.1, 3


def tree(seed: int, scale: float = 1.0) -> dict:
    """Seeded leaves in their dtypes (torch), each exactly representable."""
    rng = np.random.default_rng(seed)
    return {k: (torch.from_numpy(rng.normal(size=s).astype(np.float32)) * scale).to(dt)
            for k, (s, dt) in LEAVES.items()}


def to_jax(t: dict) -> dict:
    return {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16 if v.dtype == torch.bfloat16
                                                      else jnp.float32)
            for k, v in t.items()}


def bf16_ulp(x: float) -> float:
    """The bfloat16 spacing at magnitude ``x`` (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(max(x, 1e-30))) - 7))


def check_leaf(name, got: torch.Tensor, want, steps: int, exact_bf16: bool = True) -> None:
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32).reshape(got.shape)
    if LEAVES[name][1] == torch.bfloat16 and exact_bf16:
        np.testing.assert_array_equal(got, want, err_msg=name)
    elif LEAVES[name][1] == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * steps * bf16_ulp(np.max(np.abs(want))), err_msg=name)
    else:
        ulp = np.spacing(np.float32(np.max(np.abs(want))))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=steps * ulp, err_msg=name)


def flat_of(t: dict) -> FlatParams:
    return FlatParams([(k, torch.nn.Parameter(v.clone())) for k, v in t.items()])


def set_grads(flat: FlatParams, g: dict) -> None:
    views = flat.views(flat.grad_bufs)
    for k, v in g.items():
        views[k].copy_(v)


def test_flat_params_keep_one_buffer_per_dtype():
    t = tree(0)
    flat = flat_of(t)
    assert flat.mixed and flat.dtypes == [torch.float32, torch.bfloat16]
    assert [b.numel() for b in flat.param_bufs] == [130 + 1001 + 45, 231 + 40]
    for k, v in flat.views(flat.param_bufs).items():
        assert v.dtype == LEAVES[k][1] and torch.equal(v, t[k])
    # leaf-order coordinates [120, 400) cross a, b, c: three windows
    assert flat.runs(120, 400) == [(0, 120, 130, 0), (1, 0, 231, 10), (0, 130, 169, 241)]
    with pytest.raises(NotImplementedError, match="one buffer per dtype"):
        flat.params
    with pytest.raises(NotImplementedError, match="mixed dtypes"):
        Trainer(TrainConfig(), [(k, torch.nn.Parameter(v)) for k, v in t.items()],
                lambda batch, seed: None)
    with pytest.raises(NotImplementedError, match="one buffer per dtype"):
        torch_shard_state(lion().init(flat), 0)
    single = flat_of({k: v.float() for k, v in t.items()})
    assert not single.mixed and single.runs(3, 9) == [(0, 3, 9, 0)]


def test_local_lion_mixed_tree_matches_jax():
    p0 = tree(1)
    flat = flat_of(p0)
    opt = lion(LR, weight_decay=WD)
    state = opt.init(flat)
    assert [m.dtype for m in momenta(state)] == flat.dtypes
    jopt = j_lion(LR, weight_decay=WD)
    jp = to_jax(p0)
    jstate = jopt.init(jp)
    for s in range(STEPS):
        g = tree(10 + s, 0.1)
        jp, jstate = jax.jit(jopt.step)(jp, to_jax(g), jstate)
        set_grads(flat, g)
        state = opt.step(flat, state)
    got_p = flat.views(flat.param_bufs)
    got_m = flat.views(list(momenta(state)))
    for k in LEAVES:
        check_leaf(k, got_p[k], jp[k].astype(jnp.float32), STEPS)
        check_leaf(k, got_m[k], jstate.exp_avg[k].astype(jnp.float32), STEPS)


@pytest.mark.parametrize("buckets,vote_every", [(1, 1), (3, 1), (3, 4)])
def test_distributed_lion_mixed_tree_matches_jax_xla_path_w1(buckets, vote_every):
    p0 = tree(2)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    jopt = j_distributed_lion(learning_rate=LR, weight_decay=WD, vote_buckets=buckets,
                              vote_every=vote_every, guard="observe")
    jp = to_jax(p0)
    jstate = shard_state(init_global_state(jopt, jp, 1), mesh)
    jstep = make_sharded_step(jopt, mesh, has_elected=vote_every > 1, has_guard=True)

    flat = flat_of(p0)
    opt = distributed_lion(LR, weight_decay=WD, vote_buckets=buckets, vote_every=vote_every,
                           guard="observe")
    state = opt.init(flat)
    for s in range(STEPS):
        g = tree(20 + s, 0.1)
        before = {k: v.float().clone() for k, v in flat.views(flat.param_bufs).items()}
        jbefore = {k: np.asarray(v, np.float32) for k, v in jp.items()}
        jp, jstate, _ = jstep(jp, {k: v[None] for k, v in to_jax(g).items()}, jstate)
        set_grads(flat, g)
        state, gframe = opt.step(flat, state)
        # this rank's packed ballots in leaf order: JAX's pack_signs(_flatten_votes)
        # (under lazy refresh the slot layout, the refreshed slot's bytes)
        np.testing.assert_array_equal(state.prev_ballot.numpy(),
                                      np.asarray(jstate.prev_ballot)[0], err_msg=f"step {s}")
        if vote_every > 1:   # the elected cache, replicated
            np.testing.assert_array_equal(state.elected.numpy(), np.asarray(jstate.elected))
        # the elections: the sign each coordinate moved against its decayed value
        after = flat.views(flat.param_bufs)
        for k in LEAVES:
            decay = 1.0 - LR * WD
            up = (after[k].float() - before[k] * decay).numpy() > 0
            jup = (np.asarray(jp[k], np.float32) - jbefore[k] * decay) > 0
            assert np.mean(up == jup) == 1.0, (k, s)
    got_p = flat.views(flat.param_bufs)
    got_m = flat.views(list(momenta(state)))
    for k in LEAVES:
        check_leaf(k, got_p[k], jp[k].astype(jnp.float32), STEPS, vote_every > 1)
        check_leaf(k, got_m[k], jstate.exp_avg[k][0].astype(jnp.float32), STEPS,
                   vote_every > 1)


def test_mixed_tree_stochastic_modes_step():
    """The stochastic modes (the RNG streams differ from JAX's by design)
    run over a mixed tree, every step and lazily, with telemetry: every
    leaf stays in its dtype and finite, and the frame counts the votes."""
    for kw in (dict(max_grad_norm=1.0, seed=3), dict(vote_every=2, max_grad_norm=1.0, seed=3)):
        flat = flat_of(tree(4))
        opt = distributed_lion(LR, weight_decay=WD, telemetry=True, **kw)
        state = opt.init(flat)
        for s in range(3):
            set_grads(flat, tree(30 + s, 0.1))
            state, frame = opt.step(flat, state)
        assert all(torch.isfinite(m).all() for m in momenta(state))
        assert [b.dtype for b in flat.param_bufs] == [torch.float32, torch.bfloat16]
        assert int(frame["voted"]) > 0
