"""ZeRO-1 AdamW (``optim/zero.py``, ``--zero1``), port against the JAX
package (tests/test_zero.py, the ZeRO-1 cells of tests/test_crash_resume.py).

Paths and tolerances:

- ``adamw_zero1`` against the JAX ``adamw_zero1`` (jitted; at W = 4 under
  ``shard_map`` on a ``data=4`` mesh) on the same seeded params and grads
  for 5 steps: params within 4 float32 ulps of their magnitude (XLA:CPU
  contracts the update's multiply-adds into FMAs, the port rounds per op),
  each rank's ``m`` and ``v`` chunk within one float32 ulp of their
  magnitude per step;
- against the port's replicated AdamW (``optim/optax_adapter.py``, optax's
  order of operations): the JAX test's own ``rtol=2e-5, atol=2e-6``;
- the state: float32 ``[zero1_chunk(N, W)]`` ``m`` and ``v`` on each rank;
- the trainer at W = 4 (the test session's one spawn of four gloo ranks,
  ``test_torch_control_plane``'s ``ranks``, which calls :func:`rank_cases`):
  params equal on every rank, losses within 1e-4 of the replicated AdamW
  trainer's, and a crash and resume ``torch.equal`` to the uninterrupted run;
- the flag rules and the elastic-resume refusal, with the JAX package's
  messages.
"""

import hashlib
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.optim.lion import FlatParams
from distributed_lion_tpu_torch.optim.optax_adapter import adamw
from distributed_lion_tpu_torch.optim.zero import Zero1State, adamw_zero1, zero1_chunk
from distributed_lion_tpu_torch.train.loop import TrainConfig, make_optimizer
from test_torch_control_plane import WORLD, _cfg, _train, _trainer, ranks  # noqa: F401

N, STEPS, LR, WD = 301, 5, 1e-2, 0.1
ADAM = dict(lion=False, async_grad=False, learning_rate=1e-3)


def _inputs():
    rng = np.random.default_rng(6)
    return (rng.normal(size=N).astype(np.float32),
            rng.normal(size=(STEPS, N)).astype(np.float32))


def _sha(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _port_steps(opt):
    """The port optimizer's params after each step, and its final state."""
    p0, gs = _inputs()
    flat = FlatParams([("w", torch.nn.Parameter(torch.from_numpy(p0.copy())))])
    state = opt.init(flat)
    traj = []
    for g in gs:
        flat.grads.copy_(torch.from_numpy(g))
        state = opt.step(flat, state)
        traj.append(flat.params.clone().numpy())
    return np.stack(traj), state


def _zero_state(tr):
    return {"params": _sha(tr.flat.params), "m": _sha(tr.state.m), "v": _sha(tr.state.v),
            "count": int(tr.state.count)}


def rank_cases(world, out) -> dict:
    """The W = 4 rank side, inside the shared spawn."""
    group = dist.group.WORLD
    traj, state = _port_steps(adamw_zero1(LR, weight_decay=WD, group=group))
    res = {"traj": traj.tolist(), "m": state.m.tolist(), "v": state.v.tolist(),
           "shapes": [list(state.m.shape), str(state.m.dtype), list(state.v.shape),
                      str(state.v.dtype)]}
    tr, losses, _ = _train(_cfg(2, 6, zero1=True, **ADAM), group)
    res["full"] = {"losses": losses, "state": _zero_state(tr), "chunk": tr.state.m.numel(),
                   "n": tr.n_params}
    _, res["adamw"], _ = _train(_cfg(2, 6, **ADAM), group)
    run = f"{out}/zero_resume"
    _, first, _ = _train(_cfg(2, 3, outdir=run, save_steps=3, zero1=True, **ADAM), group)
    tr = _trainer(_cfg(2, 6, outdir=run, save_steps=3, zero1=True, **ADAM), group)
    step = tr.step_count
    tr, second, _ = _train(None, group, trainer=tr)
    res["resume"] = {"losses": first + second, "state": _zero_state(tr), "step": step}
    return res


def _jax_zero1(world):
    """The JAX ``adamw_zero1`` trajectory (jitted) and its final ``[world,
    chunk]`` m and v."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.optim.zero import Zero1State as JState
    from distributed_lion_tpu.optim.zero import adamw_zero1 as j_adamw_zero1
    from distributed_lion_tpu.optim.zero import expand_zero_state, squeeze_zero_state
    from distributed_lion_tpu.parallel.mesh import make_mesh

    p0, gs = _inputs()
    params = {"w": jnp.asarray(p0)}
    if world == 1:
        opt = j_adamw_zero1(LR, weight_decay=WD, axis_name=None)
        state = squeeze_zero_state(opt.init(params, world=1))
        step = jax.jit(opt.step)
    else:
        opt = j_adamw_zero1(LR, weight_decay=WD)
        state = opt.init(params, world=world)
        mesh = make_mesh(data=world, devices=jax.devices()[:world])
        spec = JState(P(), P("data"), P("data"))

        def body(p, g, s):
            p2, s2 = opt.step(p, g, squeeze_zero_state(s))
            return p2, expand_zero_state(s2)

        step = jax.jit(shard_map(body, mesh=mesh, in_specs=({"w": P()}, {"w": P()}, spec),
                                 out_specs=({"w": P()}, spec), check_vma=False))
    traj = []
    for g in gs:
        params, state = step(params, {"w": jnp.asarray(g)}, state)
        traj.append(np.asarray(params["w"]))
    return np.stack(traj), np.asarray(state.m), np.asarray(state.v)


def _assert_params_close(got, want):
    for t in range(STEPS):
        np.testing.assert_allclose(got[t], want[t], rtol=0,
                                   atol=4 * np.spacing(np.abs(want[t]).max()))


def _assert_moment_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=STEPS * np.spacing(np.abs(want).max()))


def test_zero1_matches_jax_in_a_world_of_one():
    got, state = _port_steps(adamw_zero1(LR, weight_decay=WD))
    want, m, v = _jax_zero1(1)
    _assert_params_close(got, want)
    _assert_moment_close(state.m.numpy(), m)
    _assert_moment_close(state.v.numpy(), v)
    assert state.m.shape == (zero1_chunk(N, 1),) and int(state.count) == STEPS


@pytest.fixture(scope="module")
def jax_w4():
    """JAX's W = 4 trajectory, computed before the test waits for the shared
    spawn (listed ahead of ``ranks``)."""
    return _jax_zero1(WORLD)


def test_zero1_matches_jax_and_replicated_adamw_at_w4(jax_w4, ranks):
    _, recs = ranks
    want, m, v = jax_w4
    replicated, _ = _port_steps(adamw(LR, weight_decay=WD))
    chunk = zero1_chunk(N, WORLD)
    for r in range(WORLD):
        rec = recs[r]["zero"]
        got = np.asarray(rec["traj"], np.float32)
        _assert_params_close(got, want)
        np.testing.assert_array_equal(got, np.asarray(recs[0]["zero"]["traj"], np.float32))
        np.testing.assert_allclose(got, replicated, rtol=2e-5, atol=2e-6)
        _assert_moment_close(np.asarray(rec["m"], np.float32), m[r])
        _assert_moment_close(np.asarray(rec["v"], np.float32), v[r])
        assert rec["shapes"] == [[chunk], "torch.float32", [chunk], "torch.float32"]


def test_zero1_trainer_at_w4(ranks):
    """Params replicated after the all-gather, the state 2N/W floats a rank,
    losses within 1e-4 of the replicated AdamW trainer's."""
    _, recs = ranks
    full0 = recs[0]["zero"]["full"]
    assert full0["chunk"] == zero1_chunk(full0["n"], WORLD)
    for r in range(WORLD):
        rec = recs[r]["zero"]
        assert rec["full"]["state"]["params"] == full0["state"]["params"]
        assert rec["full"]["state"]["count"] == 6
        assert all(np.isfinite(rec["full"]["losses"]))
        np.testing.assert_allclose(rec["full"]["losses"], rec["adamw"], rtol=0, atol=1e-4)


def test_zero1_crash_resume_equals_uninterrupted(ranks):
    _, recs = ranks
    for r in range(WORLD):
        rec = recs[r]["zero"]
        assert rec["resume"]["step"] == 3
        assert rec["resume"]["losses"] == rec["full"]["losses"]
        assert rec["resume"]["state"] == rec["full"]["state"]


def test_zero1_flag_rules_equal_jax():
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import make_optimizer as j_make_optimizer

    for kw in (dict(lion=True, zero1=True), dict(lion=False, async_grad=True, zero1=True)):
        with pytest.raises(ValueError) as got:
            make_optimizer(TrainConfig(**kw))
        with pytest.raises(ValueError) as want:
            j_make_optimizer(JTrainConfig(**kw))
        assert str(got.value) == str(want.value)
    opt = make_optimizer(TrainConfig(lion=False, async_grad=False, zero1=True))
    flat = FlatParams([("w", torch.nn.Parameter(torch.zeros(N)))])
    state = opt.init(flat)
    assert isinstance(state, Zero1State) and state.m.shape == (N,)


def test_elastic_resume_refused_for_adamw_and_zero1(ranks, tmp_path):
    out, _ = ranks
    run = tmp_path / "run"
    shutil.copytree(out / "zero_resume", run)
    for zero1 in (True, False):
        with pytest.raises(NotImplementedError, match="AdamW/ZeRO-1 states have no"):
            _trainer(_cfg(2, 8, outdir=str(run), zero1=zero1, elastic_resume=True, **ADAM),
                     None)
