"""Lazy sign refresh (``vote_every`` K > 1): the port against the JAX
package, mirroring tests/test_vote_every.py.

Four spawned gloo ranks on the CPU run the port; the JAX package runs on a
``data=4`` mesh (its XLA path: the JAX package has no Pallas kernel for the
lazy step). One spawn does all the W = 4 work (the ``four_ranks``
fixture):

- the optimizer at K = 4 with 3 vote buckets over 6 steps (a rotation and
  a half) from per-rank momenta and fresh per-rank grads each step, with
  telemetry, on ``sign_psum``, ``packed_a2a`` and ``hier:2`` at weight
  decay 0, on ``sign_psum`` at weight decay 0.1, and on ``sign_psum`` with
  bfloat16 momentum. N = 1003 coordinates: a chunk of 256, so the last
  slot's slice runs 21 coordinates past N.
- a tiny GPT-2 at float32 on ``packed_a2a`` at K = 4, 5 steps, against the
  JAX ``Trainer.for_gpt2`` on the mesh from the same init and batches.

Bounds, fixed before the runs: the packed cache and the elections equal
JAX's ``state.elected`` byte for byte after every step; params at weight
decay 0 bit-identical (the decay factor is 1, so XLA:CPU's fused
multiply-add of ``p*f - lr*s`` rounds as the port's two operations do);
momentum within one ulp of the larger addend per step (XLA:CPU contracts
``m*b2 + g*(1-b2)`` into one FMA at float32; at bfloat16 it rounds each
operation, as the port does); at weight decay 0.1 params within rtol 1e-6
plus one ulp per step. The telemetry frame equals JAX's lazy
``_make_frame``'s (histogram, disagreement, packed cache, voted, valid,
flip_valid); the bytes ``WireTally`` records per step equal
``codec.wire_bytes_per_param(..., vote_every=4)``. The trainer: the W = 4
gate's bounds (tests/test_torch_vote_w4.py), and at least 99.9% of the
elected cache's signs equal JAX's. The resume and the K = 1,
cold-start and accounting cases run in this process at W = 1.

Lazy refresh under stochastic binarization (``max_grad_norm``) runs in the
same spawn on ``sign_psum`` at weight decay 0, K = 4, 3 buckets, 6 steps,
with telemetry, on two inputs whose update direction u is built step by
step from the momentum's trajectory: saturated (``|u|`` in [2r, 4r]
everywhere), where the quantizer is deterministic and the cache bytes,
elections, params and telemetry frames (``stoch_flip_frac`` 0) must equal
the JAX package's XLA path at data = 4 under the bounds above; and spread
(u over [-1.5r, 1.5r]), where each rank replays its slice ballots from
``(seed, count, rank)`` (``replay_slice_ballots``) before the step and the
plain election of the four replays must equal the refreshed cache's slice,
with the frame's histogram and disagreement equal to
``bucket_vote_stats_plain`` of them. At W = 1 the replayed slice ballots
are unbiased over 2000 counts within 6 binomial standard deviations per
coordinate, ``6·2·sqrt(p(1-p)/2000)`` (the bound of
tests/test_torch_stochastic.py).

jax is imported inside the tests and the fixture only, so the spawned
ranks import torch alone.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.ops import fused_lion, lion_math
from distributed_lion_tpu_torch.ops.codec import vote_chunk_elems, wire_bytes_per_param
from distributed_lion_tpu_torch.optim.distributed_lion import distributed_lion
from distributed_lion_tpu_torch.optim.lion import FlatParams
from distributed_lion_tpu_torch.parallel import collectives
from distributed_lion_tpu_torch.parallel.mesh import data_grid
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.utils.serialization import params_from_jax, save_pytree

torch.set_num_threads(2)

WORLD, K, N, BUCKETS, OPT_STEPS, LR = 4, 4, 1003, 3, 6, 0.02
# (label, wire, weight decay, momentum dtype)
CASES = (("sign_psum", "sign_psum", 0.0, "float32"),
         ("packed_a2a", "packed_a2a", 0.0, "float32"),
         ("hier2", "hier:2", 0.0, "float32"),
         ("sign_psum_wd", "sign_psum", 0.1, "float32"),
         ("sign_psum_bf16", "sign_psum", 0.0, "bfloat16"))
FRAME_KEYS = ("margin_hist", "elected", "disagree", "voted", "valid", "flip_valid")
GPT_LR, GPT_STEPS = 3e-3, 5
# lazy refresh under stochastic binarization: the quantizer's clip, seed and
# the two kinds of input (label, kind)
B1, MGN, STOCH_SEED = 0.9, 0.5, 7
R = (1.0 + 1.0 / B1) * MGN
STOCH_CASES = (("stoch_sat", "saturated"), ("stoch_spread", "spread"))
GPT_CFG = dict(lion=True, async_grad=True, wire="packed_a2a", vote_every=K,
               learning_rate=GPT_LR, weight_decay=0.0, lr_scheduler_type="constant",
               max_steps=GPT_STEPS, per_device_train_batch_size=2,
               gradient_accumulation_steps=1, block_size=32, logging_steps=1,
               eval_steps=1000, seed=0)


def optimizer_inputs():
    """Per-rank momenta [W, N], per-step per-rank grads [steps, W, N] and
    shared params [N], float32."""
    rng = np.random.default_rng(11)
    m = rng.normal(size=(WORLD, N)).astype(np.float32)
    g = rng.normal(size=(OPT_STEPS, WORLD, N)).astype(np.float32)
    return m, g, rng.normal(size=N).astype(np.float32)


def _as_np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def stochastic_inputs(kind):
    """(momenta [W, N], grads [steps, W, N], params [N]) float32 whose update
    direction ``u = b1·m + (1-b1)·g`` is drawn per step from the momentum's
    trajectory (``m ← b2·m + (1-b2)·g``, in float64): ``|u|`` in [2r, 4r]
    with mixed signs (saturated) or u over [-1.5r, 1.5r] (spread)."""
    rng = np.random.default_rng(13 if kind == "saturated" else 17)
    m = rng.uniform(-R, R, (WORLD, N))
    m0, grads = m.astype(np.float32), []
    for _ in range(OPT_STEPS):
        if kind == "saturated":
            u = rng.uniform(2 * R, 4 * R, (WORLD, N)) * rng.choice([-1.0, 1.0], (WORLD, N))
        else:
            u = rng.uniform(-1.5 * R, 1.5 * R, (WORLD, N))
        g = (u - B1 * m) / (1.0 - B1)
        grads.append(g.astype(np.float32))
        m = 0.99 * m + 0.01 * g
    return m0, np.stack(grads), rng.normal(size=N).astype(np.float32)


def _record_run(rank, out, label, opt, m, g, p, replay=False):
    """``OPT_STEPS`` steps of ``opt`` from rank ``rank``'s rows of the
    inputs; saves every step's params, momentum, cache, frame, wire bytes
    and, with ``replay``, the slice ballots replayed before the step."""
    flat = FlatParams([("p", torch.nn.Parameter(torch.from_numpy(p.copy())))])
    state = opt.init(flat)
    state.exp_avg.copy_(torch.from_numpy(m[rank]))
    rec: dict = {}
    replayed = {}  # the slices differ in length: one key a step
    for t in range(OPT_STEPS):
        flat.grads.copy_(torch.from_numpy(g[t, rank]))
        if replay:
            replayed[f"replayed_{t}"] = opt.replay_slice_ballots(flat.grads, state.exp_avg,
                                                                 state.steps).numpy()
        before = opt.tally.total()
        state, frame = opt.step(flat, state)
        step = {"wire_bytes": np.array(opt.tally.total() - before),
                "params": flat.params.numpy().copy(),
                "momentum": _as_np(state.exp_avg).copy(),
                "elected": state.elected.numpy().copy(),
                **{("frame_" if k == "elected" else "") + k: frame[k].numpy().copy()
                   for k in FRAME_KEYS + (("stoch_flip_frac",) if opt.max_grad_norm else ())}}
        for k, v in step.items():
            rec.setdefault(k, []).append(v)
    np.savez(f"{out}/opt_{label}_{rank}.npz", **{k: np.stack(v) for k, v in rec.items()},
             **replayed)


def _optimizer_runs(rank, out):
    m, g, p = optimizer_inputs()
    for label, wire, wd, mdt in CASES:
        opt = distributed_lion(LR, weight_decay=wd, wire=wire, vote_every=K,
                               vote_buckets=BUCKETS, mom_dtype=mdt, telemetry=True,
                               tally=collectives.WireTally())
        _record_run(rank, out, label, opt, m, g, p)
    for label, kind in STOCH_CASES:
        opt = distributed_lion(LR, wire="sign_psum", vote_every=K, vote_buckets=BUCKETS,
                               max_grad_norm=MGN, seed=STOCH_SEED, telemetry=True,
                               tally=collectives.WireTally())
        _record_run(rank, out, label, opt, *stochastic_inputs(kind), replay=kind == "spread")


def _four_rank_work(rank, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/pg", rank=rank,
                            world_size=WORLD)
    try:
        _optimizer_runs(rank, out)
        blocks = synthetic_lm_dataset(256, 32, 256)
        tr = Trainer.for_gpt2(TrainConfig(**GPT_CFG, output_dir=f"{out}/gpt", save_steps=GPT_STEPS),
                              GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.0),
                              device="cpu", initial_params=params_from_jax(f"{out}/init.npz"),
                              grid=data_grid(dist.group.WORLD))
        hist = tr.train(batch_iterator(blocks, tr.global_train_batch(), seed=0))
        tr.close()
        np.save(f"{out}/gpt_loss_{rank}.npy", np.array([h["loss"] for h in hist]))
        np.save(f"{out}/gpt_params_{rank}.npy", tr.flat.params.numpy())
        np.save(f"{out}/gpt_elected_{rank}.npy", tr.state.elected.numpy())
        if rank == 0:
            with open(f"{out}/comm_stats.json", "w") as f:
                json.dump(tr.comm_stats(), f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The directory the four spawned ranks wrote their results into."""
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.models.gpt2 import gpt2_init

    out = tmp_path_factory.mktemp("lazy_w4")
    init = gpt2_init(jax.random.key(GPT_CFG["seed"]),
                     JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0))
    # through a file: spawn writes its arguments into a pipe, and arguments
    # larger than the pipe's buffer would start the ranks one by one
    save_pytree(out / "init.npz", jax.tree.map(np.asarray, init))
    mp.spawn(_four_rank_work, args=(str(out),), nprocs=WORLD, join=True)
    return out


def _jax_lazy_run(wire, wd, mdt, inputs=None, max_grad_norm=None):
    """The JAX package's optimizer at data = 4 on ``inputs`` (default
    ``optimizer_inputs()``): per step the params, the stacked momenta, the
    cache and the stacked telemetry frames."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.optim import (
        distributed_lion as j_distributed_lion,
        expand_worker_state,
        init_global_state,
        squeeze_worker_state,
    )
    from distributed_lion_tpu.optim.sharded import shard_state, state_specs
    from distributed_lion_tpu.parallel import make_mesh

    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    m, g, p = optimizer_inputs() if inputs is None else inputs
    opt = j_distributed_lion(learning_rate=LR, weight_decay=wd, wire=wire, vote_every=K,
                             vote_buckets=BUCKETS, telemetry=True,
                             mom_dtype=getattr(jnp, mdt), max_grad_norm=max_grad_norm)
    params = {"p": jnp.asarray(p)}
    state = init_global_state(opt, params, WORLD, rng=None if max_grad_norm is None
                              else jax.random.key(STOCH_SEED))
    state = shard_state(state._replace(exp_avg={"p": jnp.asarray(m).astype(getattr(jnp, mdt))}),
                        mesh)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P("data"), state_specs(True)),
             out_specs=(P(), state_specs(True), P("data")), check_vma=False)
    def step(params, stacked, st):
        new_p, new_st, frame = opt.step(params, jax.tree.map(lambda x: x[0], stacked),
                                        squeeze_worker_state(st))
        return new_p, expand_worker_state(new_st), jax.tree.map(lambda x: x[None], frame)

    out = []
    for t in range(OPT_STEPS):
        params, state, frame = step(params, {"p": jnp.asarray(g[t])}, state)
        out.append({"params": np.asarray(params["p"]),
                    "momentum": np.asarray(state.exp_avg["p"].astype(jnp.float32)),
                    "cache": np.asarray(state.elected),
                    **{k: np.asarray(v) for k, v in frame.items()}})
    return out


@pytest.mark.parametrize("label,wire,wd,mdt", CASES, ids=[c[0] for c in CASES])
def test_lazy_optimizer_matches_jax_at_data_4(four_ranks, label, wire, wd, mdt):
    want = _jax_lazy_run(wire, wd, mdt)
    ranks = [np.load(four_ranks / f"opt_{label}_{r}.npz") for r in range(WORLD)]
    chunk = vote_chunk_elems(N, K)
    for t, w in enumerate(want):
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got["elected"][t], w["cache"], err_msg=f"step {t}")
            np.testing.assert_array_equal(got["frame_elected"][t], w["elected"][r])
            p_got = got["params"][t]
            if wd == 0.0:
                np.testing.assert_array_equal(p_got, w["params"], err_msg=f"step {t}")
            else:
                np.testing.assert_allclose(p_got, w["params"], rtol=1e-6,
                                           atol=(t + 1) * np.spacing(np.abs(w["params"]).max()))
            m_want = w["momentum"][r]
            ulp = (np.spacing(np.float32(np.abs(m_want).max())) if mdt == "float32"
                   else 2.0 ** (np.floor(np.log2(np.abs(m_want).max())) - 7))
            np.testing.assert_allclose(got["momentum"][t], m_want, rtol=0, atol=(t + 1) * ulp)
            for k in ("margin_hist", "disagree", "voted", "valid", "flip_valid"):
                np.testing.assert_array_equal(got[k][t], w[k][r], err_msg=f"{k} step {t}")
        # the slot's real coordinates, and the coordinates that moved
        slot_lo = (t % K) * chunk
        assert int(ranks[0]["voted"][t]) == max(0, min(chunk, N - slot_lo))
        assert int(ranks[0]["valid"][t]) == min((t + 1) * chunk, N)


def test_lazy_stochastic_saturated_matches_jax_at_data_4(four_ranks):
    """Saturated ballots: the quantizer is deterministic, so the cache bytes,
    the elections, the params (weight decay 0) and the telemetry frames
    equal the JAX package's XLA path at data = 4; momentum within one ulp
    of the larger addend per step; no ballot flipped."""
    inputs = stochastic_inputs("saturated")
    want = _jax_lazy_run("sign_psum", 0.0, "float32", inputs, max_grad_norm=MGN)
    ranks = [np.load(four_ranks / f"opt_stoch_sat_{r}.npz") for r in range(WORLD)]
    for t, w in enumerate(want):
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got["elected"][t], w["cache"], err_msg=f"step {t}")
            np.testing.assert_array_equal(got["frame_elected"][t], w["elected"][r])
            np.testing.assert_array_equal(got["params"][t], w["params"], err_msg=f"step {t}")
            m_want = w["momentum"][r]
            np.testing.assert_allclose(got["momentum"][t], m_want, rtol=0,
                                       atol=(t + 1) * np.spacing(np.abs(m_want).max()))
            for k in ("margin_hist", "disagree", "voted", "valid", "flip_valid",
                      "stoch_flip_frac"):
                np.testing.assert_array_equal(got[k][t], w[k][r], err_msg=f"{k} step {t}")
            assert float(got["stoch_flip_frac"][t]) == 0.0


def test_lazy_stochastic_ballots_replay_from_seed_count_rank(four_ranks):
    """Spread inputs at W = 4: the plain election of the four ranks' slice
    ballots, replayed from (seed, count, rank), equals the refreshed
    cache's slice at every step, and the frame's histogram and
    disagreement equal ``bucket_vote_stats_plain`` of them; the flip
    fraction is a real share of the full vector."""
    from distributed_lion_tpu_torch.ops.codec import unpack_signs

    ranks = [np.load(four_ranks / f"opt_stoch_spread_{r}.npz") for r in range(WORLD)]
    chunk = vote_chunk_elems(N, K)
    for t in range(OPT_STEPS):
        lo = (t % K) * chunk
        real = max(0, min(chunk, N - lo))
        ballots = [torch.from_numpy(np.where(rk[f"replayed_{t}"], 1, -1).astype(np.int8))
                   for rk in ranks]
        assert all(b.numel() == real for b in ballots)
        tally = sum(b.to(torch.int32) for b in ballots)
        cache = torch.from_numpy(ranks[0]["elected"][t])
        got = unpack_signs(cache[lo // 8:(lo + chunk) // 8], (chunk,))[:real]
        assert torch.equal(got, tally > 0), f"step {t}"
        for r, rk in enumerate(ranks):
            hist, dis = fused_lion.bucket_vote_stats_plain(ballots[r], tally, WORLD, 8)
            np.testing.assert_array_equal(rk["margin_hist"][t], hist.numpy())
            assert int(rk["disagree"][t]) == int(dis)
            assert 0.0 < float(rk["stoch_flip_frac"][t]) < 1.0
        assert not all(np.array_equal(ranks[0][f"replayed_{t}"], rk[f"replayed_{t}"])
                       for rk in ranks[1:])  # the ranks draw apart


def test_lazy_stochastic_slice_ballots_unbiased_and_voted_at_one_rank():
    """W = 1: a lazy stochastic step's cache slice is exactly its replayed
    ballots, and the replays over 2000 counts of slot 0 are unbiased per
    coordinate within 6 binomial standard deviations."""
    m0, g, p = stochastic_inputs("spread")
    opt = distributed_lion(LR, vote_every=K, vote_buckets=BUCKETS, max_grad_norm=MGN,
                           seed=STOCH_SEED)
    flat = FlatParams([("p", torch.nn.Parameter(torch.from_numpy(p.copy())))])
    state = opt.init(flat)
    gt, mt = torch.from_numpy(g[0, 0]), torch.from_numpy(m0[0])
    state.exp_avg.copy_(mt)
    flat.grads.copy_(gt)
    want = opt.replay_slice_ballots(gt, mt, 0)
    state = opt.step(flat, state)
    chunk = vote_chunk_elems(N, K)
    from distributed_lion_tpu_torch.ops.codec import unpack_signs

    assert torch.equal(unpack_signs(state.elected[:chunk // 8], (chunk,)), want)
    draws = torch.stack([opt.replay_slice_ballots(gt, mt, K * j) for j in range(2000)]).numpy()
    prob = lion_math.stochastic_p_up(gt[:chunk], mt[:chunk], B1, MGN).double().numpy()
    mean = (2.0 * draws - 1.0).mean(0)
    bound = 6 * 2 * np.sqrt(prob * (1 - prob) / draws.shape[0]) + 1e-6
    assert np.max(np.abs(mean - (2 * prob - 1)) / bound) <= 1.0
    assert 0.05 < np.mean((prob > 0) & (prob < 1))  # the check sees unsaturated coordinates


def test_lazy_cold_start_moves_only_voted_slots(four_ranks):
    """Step 1 at weight decay 0: only slot 0's coordinates move, on every
    rank and wire (JAX test_vote_every_cold_start_mask)."""
    _, _, p = optimizer_inputs()
    chunk = vote_chunk_elems(N, K)
    for label, _, wd, _ in CASES:
        if wd:
            continue
        for r in range(WORLD):
            moved = np.load(four_ranks / f"opt_{label}_{r}.npz")["params"][0] != p
            assert moved[:chunk].all() and not moved[chunk:].any(), label
    for label, kind in STOCH_CASES:  # weight decay 0 under stochastic binarization too
        p = stochastic_inputs(kind)[2]
        for r in range(WORLD):
            moved = np.load(four_ranks / f"opt_{label}_{r}.npz")["params"][0] != p
            assert moved[:chunk].all() and not moved[chunk:].any(), label


def test_lazy_wire_tally_equals_accounting(four_ranks):
    """The bytes handed to the backend per step equal
    ``wire_bytes_per_param(N, 4, wire, vote_every=4, vote_buckets=3)``."""
    for label, wire, _, _ in CASES:
        want = wire_bytes_per_param(N, WORLD, wire, vote_every=K,
                                    vote_buckets=BUCKETS)["bytes_per_step"]
        for r in range(WORLD):
            got = np.load(four_ranks / f"opt_{label}_{r}.npz")["wire_bytes"]
            assert got.tolist() == [want] * OPT_STEPS, (label, r)


def test_lazy_gpt2_matches_jax_trainer_at_data_4(four_ranks):
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.data.sources import batch_iterator as j_batch_iterator
    from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer

    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    jtr = JTrainer.for_gpt2(JTrainConfig(**GPT_CFG), mesh,
                            JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0))
    jhist = jtr.train(j_batch_iterator(j_synthetic(256, 32, 256), jtr.global_train_batch(),
                                       seed=0))
    want_stats = jtr.comm_stats()
    jtr.close()
    want = np.concatenate([np.asarray(v).reshape(-1) for v in jax.tree.leaves(jtr.params)])
    got = np.load(four_ranks / "gpt_params_0.npy")
    for r in range(WORLD):
        np.testing.assert_allclose(np.load(four_ranks / f"gpt_loss_{r}.npy"),
                                   [h["loss"] for h in jhist], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(np.load(four_ranks / f"gpt_params_{r}.npy"), got)
        np.testing.assert_array_equal(np.load(four_ranks / f"gpt_elected_{r}.npy"),
                                      np.load(four_ranks / "gpt_elected_0.npy"))
    # the grads differ in their last bits between the frameworks, so a few
    # elections near a zero update may too: the gate's 99.9%, per elected sign
    bits = np.unpackbits(np.load(four_ranks / "gpt_elected_0.npy"), bitorder="little")
    want_bits = np.unpackbits(np.asarray(jtr.state.elected), bitorder="little")
    assert np.mean(bits == want_bits) >= 0.999
    assert np.mean(got == want) >= 0.999
    assert np.max(np.abs(got - want)) <= 2 * GPT_LR * GPT_STEPS * (1 + 1e-6)
    stats = json.loads((four_ranks / "comm_stats.json").read_text())
    assert stats == {k: want_stats[k] for k in stats}
    assert stats["comm_bits_per_param"] <= 0.5 + 1e-6


def test_lazy_elastic_resume_passes_the_cache_through(four_ranks):
    """The four ranks' step-5 checkpoint resumed at W = 1 with
    ``elastic_resume``: the replicated cache comes back as saved, the
    momentum as the mean of the four ranks' (``remap_worker_momentum``)."""
    from distributed_lion_tpu_torch.optim.distributed_lion import remap_worker_momentum
    from distributed_lion_tpu_torch.train.loop import momentum_file

    out = four_ranks / "gpt"
    t = Trainer.for_gpt2(TrainConfig(**GPT_CFG, output_dir=str(out), elastic_resume=True),
                         GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.0),
                         device="cpu")
    t.close()
    assert t.step_count == GPT_STEPS
    np.testing.assert_array_equal(t.state.elected.numpy(),
                                  np.load(four_ranks / "gpt_elected_0.npy"))
    rows = torch.stack([torch.load(out / f"checkpoints/{GPT_STEPS}/{momentum_file(r)}",
                                   weights_only=True) for r in range(WORLD)])
    assert torch.equal(t.state.exp_avg, remap_worker_momentum(rows, WORLD, 1)[0])


def test_auto_comm_names_lazy_refresh_without_turning_it_on(capsys):
    """Auto keeps vote_every at 1, as the JAX package's, and a Lion run at
    W > 1 of at least AUTO_LAZY_MIN_PARAMS coordinates prints what
    ``--vote_every 4`` would cut its wire to (JAX loop.py:489-500)."""
    from distributed_lion_tpu_torch.train.loop import AUTO_LAZY_MIN_PARAMS, resolve_auto_comm

    n = 124_439_808
    assert n >= AUTO_LAZY_MIN_PARAMS
    cfg = resolve_auto_comm(TrainConfig(), 4, n, announce=True)
    assert cfg.vote_every == 1 and cfg.wire == "packed_a2a"
    out = capsys.readouterr().out
    assert "Lazy --vote_every 4 would cut the 124M-coordinate ballot to 0.38" in out
    for world, size, lion in ((1, n, True), (4, 1000, True), (4, n, False)):
        resolve_auto_comm(TrainConfig(lion=lion), world, size, announce=True)
        assert capsys.readouterr().out == ""


def test_vote_every_accounting_meets_budget():
    """packed_a2a at K = 4 is at or under BASELINE.md's 0.5 bit/param/step,
    with the JAX package's numbers, at W = 4 and 8."""
    from distributed_lion_tpu.ops.codec import wire_bytes_per_param as j_bytes

    for world in (4, 8):
        got = wire_bytes_per_param(124_439_808, world, "packed_a2a", vote_every=4)
        assert got == j_bytes(124_439_808, world, "packed_a2a", vote_every=4)
        assert got["bits_per_param"] <= 0.5 + 1e-6
        assert got["vs_bf16_allreduce"] <= 1 / 32 + 1e-9


def test_vote_every_one_is_the_unlazy_path():
    """K = 1 is the every-step vote bit for bit (JAX
    test_vote_every_one_matches_plain), telemetry frames included."""
    rng = np.random.default_rng(2)
    p = rng.normal(size=N).astype(np.float32)
    grads = rng.normal(size=(3, N)).astype(np.float32)
    runs = []
    for kw in ({}, {"vote_every": 1}):
        flat = FlatParams([("p", torch.nn.Parameter(torch.from_numpy(p.copy())))])
        opt = distributed_lion(LR, weight_decay=0.1, telemetry=True, vote_buckets=2, **kw)
        state = opt.init(flat)
        assert state.elected is None
        frames = []
        for g in grads:
            flat.grads.copy_(torch.from_numpy(g))
            state, frame = opt.step(flat, state)
            frames.append(frame)
        runs.append((flat.params, state.exp_avg, frames))
    (p0, m0, f0), (p1, m1, f1) = runs
    assert torch.equal(p0, p1) and torch.equal(m0, m1)
    for a, b in zip(f0, f1):
        assert all(torch.equal(a[k], b[k]) for k in a)


BLOCKS = synthetic_lm_dataset(64, 32, 256, seed=1)


def _resume_cfg(out, steps, **kw):
    base = dict(lion=True, async_grad=True, vote_every=K, learning_rate=1e-3, warmup_steps=1,
                max_steps=steps, per_device_train_batch_size=2, gradient_accumulation_steps=2,
                block_size=32, logging_steps=1, save_steps=2, output_dir=out, seed=5,
                telemetry=True)
    base.update(kw)
    return TrainConfig(**base)


def _train(cfg):
    t = Trainer.for_gpt2(cfg, GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.1),
                         device="cpu")
    h = t.train(batch_iterator(BLOCKS, t.global_train_batch(), seed=5))
    t.close()
    return t, [x["loss"] for x in h if "loss" in x]


def test_lazy_resume_equals_uninterrupted_and_refuses_another_k(tmp_path):
    """2 steps + a resume + 2 steps is ``torch.equal`` to 4 steps: losses,
    params, momentum, the elected cache (restored, not zeroed) and every
    vote-health counter (JAX test_vote_every_checkpoint_resume). Resuming
    under another K raises, naming both."""
    ref, ref_losses = _train(_resume_cfg(None, 4))
    out = str(tmp_path / "run")
    _, first = _train(_resume_cfg(out, 2))
    t2 = Trainer.for_gpt2(_resume_cfg(out, 4), GPT2Config.tiny(compute_dtype=torch.float32,
                                                                dropout=0.1), device="cpu")
    assert t2.step_count == 2 and t2.state.elected.any()
    h2 = t2.train(batch_iterator(BLOCKS, t2.global_train_batch(), seed=5))
    t2.close()
    assert first + [x["loss"] for x in h2 if "loss" in x] == ref_losses
    for a, b in ((t2.flat.params, ref.flat.params), (t2.state.exp_avg, ref.state.exp_avg),
                 (t2.state.elected, ref.state.elected)):
        assert torch.equal(a, b)
    for f in ("prev_elected", "flip_sum", "valid_sum", "voted", "margin_hist"):
        assert torch.equal(getattr(t2.vote_health, f), getattr(ref.vote_health, f)), f


def test_lazy_stochastic_resume_equals_uninterrupted(tmp_path):
    """Under ``--max_grad_norm`` too, 2 steps + a resume + 2 steps is
    ``torch.equal`` to 4 steps (the draws replay from the restored seed and
    step count)."""
    ref, ref_losses = _train(_resume_cfg(None, 4, max_grad_norm=1.0))
    out = str(tmp_path / "run")
    _, first = _train(_resume_cfg(out, 2, max_grad_norm=1.0))
    t2, rest = _train(_resume_cfg(out, 4, max_grad_norm=1.0))
    assert first + rest == ref_losses
    for a, b in ((t2.flat.params, ref.flat.params), (t2.state.exp_avg, ref.state.exp_avg),
                 (t2.state.elected, ref.state.elected)):
        assert torch.equal(a, b)
    for f in ("prev_elected", "flip_sum", "valid_sum", "voted", "margin_hist", "stoch_flip_sum"):
        assert torch.equal(getattr(t2.vote_health, f), getattr(ref.vote_health, f)), f
    for k in (2, 1):
        with pytest.raises(ValueError, match=f"--vote_every 4, this run has --vote_every {k}"):
            Trainer.for_gpt2(_resume_cfg(out, 6, vote_every=k),
                             GPT2Config.tiny(compute_dtype=torch.float32), device="cpu")


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_lazy_kernels_are_the_xla_paths_bits(mdt):
    """Where the lazy step runs the fused kernels, their plain versions
    (what the card's kernels equal, chip_smoke.py) are the XLA path's
    plain ops bit for bit: at float32 the ballots equal
    ``lion_math.sign_vote_bool``, and ``fused_apply`` with the cache's bits
    as its tally equals ``lion_math.lazy_update`` over every coordinate,
    decay on. At bfloat16 momentum the ballot kernel (float32 math, float32
    constants) differs from XLA:CPU, which rounds each operation to
    bfloat16, as ``lion_math.sign_vote_bool`` does: that is the lazy path's
    ballot there, and equals the JAX package's on the same inputs."""
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.ops import lion_math as j_lion_math
    from distributed_lion_tpu_torch.ops import fused_lion, lion_math
    from distributed_lion_tpu_torch.ops.codec import pack_signs

    rng = np.random.default_rng(5)
    n = 200_003
    dt = getattr(torch, mdt)
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dt)
    m = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 0.3).to(dt)
    xla = np.asarray(jax.jit(lambda a, b: j_lion_math.sign_vote_bool(a, b, 0.9))(
        jnp.asarray(g.float().numpy()).astype(getattr(jnp, mdt)),
        jnp.asarray(m.float().numpy()).astype(getattr(jnp, mdt))))
    plain = lion_math.sign_vote_bool(g, m, 0.9)
    np.testing.assert_array_equal(plain.numpy(), xla)
    kernel = fused_lion.fused_ballots_plain(g, m, 0.9) > 0
    if mdt == "float32":
        assert torch.equal(kernel, plain)
        p = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        cache = pack_signs(torch.from_numpy(rng.random(n) < 0.5))
        tally = lion_math.cache_tally(cache, n)
        lr = torch.tensor(3e-3)
        want_p, want_m = lion_math.lazy_update(p.clone(), g, m, tally, n, lr, 0.1, 0.99)
        got_p, got_m = fused_lion.fused_apply_plain(p, g, m, tally, lr, 0.1, 0.99)
        assert torch.equal(got_p, want_p) and torch.equal(got_m, want_m)
    else:
        assert not torch.equal(kernel, plain)
