"""The port's vote-health telemetry vs the JAX package's, on the CPU.

- ``bucket_vote_stats_plain`` (what the CUDA kernel computes, and what its
  wrapper runs on CPU tensors) and ``margin_hist`` are bit-identical to the
  JAX package's Pallas ``bucket_vote_stats`` (interpret mode) and
  ``margin_hist``: the counts are integers.
- The optimizer's frames (margin histogram, packed elections, local
  disagreement) are bit-identical to the JAX ``distributed_lion(kernel=
  "pallas", telemetry=True)`` frames on the same ballots, at W = 1 and at
  W = 2 (two gloo ranks against a ``data=2`` mesh), on ``sign_psum`` and on
  ``packed_a2a``, whose histogram is zeroed; telemetry leaves the update
  unchanged.
- ``drain`` agrees with the JAX package's on the same frames to float32
  rounding (``rtol=1e-6``): both fold per-step fractions in float32.

This file imports jax only inside the test functions that use it, so the
spawned ranks import torch alone.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.cli import run_clm
from distributed_lion_tpu_torch.ops import fused_lion
from distributed_lion_tpu_torch.optim.distributed_lion import distributed_lion
from distributed_lion_tpu_torch.optim.lion import FlatParams
from distributed_lion_tpu_torch.train import telemetry
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer

torch.set_num_threads(2)

N = 1003
BUCKETS = 3
WIRES = ("sign_psum", "packed_a2a")


STATS_CASES = {  # id: (world, nbins, tally dtype)
    "int8": (8, 8, np.int8), "int32": (8, 8, np.int32),
    "W1-int8": (1, 8, np.int8),    # a vote of one: every coordinate in the last bin
    "W3-int8": (3, 8, np.int8),    # a world that does not divide the bins
    "W6-int32": (6, 8, np.int32),
    "W5-bins4-int32": (5, 4, np.int32),  # another bin count (the JAX kernel takes up to 128)
}


@pytest.mark.parametrize("world,nbins,tally", list(STATS_CASES.values()),
                         ids=list(STATS_CASES))
def test_bucket_vote_stats_plain_matches_jax_pallas(world, nbins, tally):
    import jax.numpy as jnp

    from distributed_lion_tpu.ops.pallas_lion import bucket_vote_stats as j_stats

    rng = np.random.default_rng(3 if world == 8 else 3 + world)
    n = 5003  # ragged: not a multiple of the Pallas grid's rows or a kernel step
    ballots = rng.choice([-1, 1], size=n).astype(np.int8)
    if world == 1:
        totals = ballots.astype(tally)
    else:
        totals = rng.integers(-world, world + 1, size=n).astype(tally)
    want_h, want_d = j_stats(jnp.asarray(ballots), jnp.asarray(totals), world, nbins,
                             interpret=True)
    got_h, got_d = fused_lion.bucket_vote_stats(torch.from_numpy(ballots),
                                                torch.from_numpy(totals), world, nbins)
    assert got_h.dtype == torch.int32 and got_d.dtype == torch.int32
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    assert int(got_d) == int(want_d)
    assert int(got_h.sum()) == n
    if world == 1:
        assert got_h.tolist() == [0] * (nbins - 1) + [n] and int(got_d) == 0


def test_margin_hist_matches_jax():
    import jax.numpy as jnp

    from distributed_lion_tpu.train import telemetry as j_telemetry

    rng = np.random.default_rng(4)
    totals = rng.integers(-5, 6, size=777).astype(np.int32)
    mask = rng.random(777) < 0.7
    for m in (None, mask):
        want = j_telemetry.margin_hist(jnp.asarray(totals), 5,
                                       None if m is None else jnp.asarray(m))
        got = telemetry.margin_hist(torch.from_numpy(totals), 5,
                                    None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert telemetry.tally_wire("sign_psum") and telemetry.tally_wire("packed_allgather")
    assert not telemetry.tally_wire("packed_a2a")


def test_popcount_counts_every_set_bit():
    rng = np.random.default_rng(7)
    for x in (rng.integers(0, 256, size=10_007).astype(np.uint8),
              np.array([0, 255], np.uint8), np.zeros(0, np.uint8)):
        got = telemetry._popcount(torch.from_numpy(x))
        assert got.dtype == torch.float32
        assert float(got) == float(np.unpackbits(x).sum())


def _port_step(rank, world, g, m, p, wire, on: bool):
    """One port optimizer step on rank ``rank``'s (g, m); returns (params,
    frame or None)."""
    flat = FlatParams([("p", torch.nn.Parameter(torch.from_numpy(p.copy())))])
    opt = distributed_lion(0.02, weight_decay=0.0, wire=wire, vote_buckets=BUCKETS,
                           telemetry=on)
    state = opt.init(flat)
    state.exp_avg.copy_(torch.from_numpy(m[rank]))
    flat.grads.copy_(torch.from_numpy(g[rank]))
    out = opt.step(flat, state)
    frame = out[1] if on else None
    return flat.params.numpy().copy(), frame


def _rank(rank, world, init, out, g, m, p):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        for wire in WIRES:
            p_on, frame = _port_step(rank, world, g, m, p, wire, True)
            p_off, _ = _port_step(rank, world, g, m, p, wire, False)
            np.savez(f"{out}/{wire}_{rank}.npz", p_on=p_on, p_off=p_off,
                     **{k: v.numpy() for k, v in frame.items()})
    finally:
        dist.destroy_process_group()


def _jax_frames(world, wire, g, m, p):
    """Per-worker frames of the JAX Pallas path on a ``data=world`` mesh."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.optim import (
        distributed_lion as j_distributed_lion,
        init_global_state,
        squeeze_worker_state,
    )
    from distributed_lion_tpu.optim.lion import LionState
    from distributed_lion_tpu.parallel import make_mesh

    mesh = make_mesh(data=world, devices=jax.devices()[:world])
    opt = j_distributed_lion(learning_rate=0.02, weight_decay=0.0, wire=wire,
                             kernel="pallas", vote_buckets=BUCKETS, telemetry=True)
    params = {"p": jnp.asarray(p)}
    state = init_global_state(opt, params, world)._replace(exp_avg={"p": jnp.asarray(m)})
    st_spec = LionState(count=P(), exp_avg={"p": P("data")}, rng=None, elected=None)

    def body(pp, gg, st):
        p2, _, frame = opt.step(pp, {"p": gg[0]}, squeeze_worker_state(st))
        return p2, jax.tree.map(lambda x: x[None], frame)

    step = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P("data"), st_spec),
                             out_specs=(P(), P("data")), check_vma=False))
    new_p, frames = step(params, jnp.asarray(g), state)
    return np.asarray(new_p["p"]), {k: np.asarray(v) for k, v in frames.items()}


def _assert_frame(got: dict, want: dict, r: int, wire: str):
    for key in ("margin_hist", "elected", "disagree", "voted", "valid", "flip_valid"):
        np.testing.assert_array_equal(np.asarray(got[key]), want[key][r], err_msg=key)
    if wire == "packed_a2a":
        assert not np.asarray(got["margin_hist"]).any()
    else:
        assert int(np.asarray(got["margin_hist"]).sum()) == N


def _data(world):
    rng = np.random.default_rng(5)
    g = rng.normal(size=(world, N)).astype(np.float32)
    m = rng.normal(size=(world, N)).astype(np.float32)
    return g, m, rng.normal(size=N).astype(np.float32)


@pytest.mark.parametrize("wire", WIRES)
def test_frames_match_jax_w1(wire):
    g, m, p = _data(1)
    p_on, frame = _port_step(0, 1, g, m, p, wire, True)
    p_off, _ = _port_step(0, 1, g, m, p, wire, False)
    want_p, want = _jax_frames(1, wire, g, m, p)
    _assert_frame({k: v.numpy() for k, v in frame.items()}, want, 0, wire)
    np.testing.assert_array_equal(p_on, p_off)
    np.testing.assert_array_equal(p_on, want_p)
    assert int(frame["disagree"]) == 0  # a vote of one: the ballot always wins


def test_frames_match_jax_two_gloo_ranks(tmp_path):
    g, m, p = _data(2)
    mp.spawn(_rank, args=(2, str(tmp_path / "pg"), str(tmp_path), g, m, p), nprocs=2,
             join=True)
    for wire in WIRES:
        want_p, want = _jax_frames(2, wire, g, m, p)
        assert want["disagree"].sum() > 0  # two workers do disagree somewhere
        for r in range(2):
            got = dict(np.load(tmp_path / f"{wire}_{r}.npz"))
            _assert_frame(got, want, r, wire)
            np.testing.assert_array_equal(got["p_on"], got["p_off"])
            np.testing.assert_array_equal(got["p_on"], want_p)


def test_drain_matches_jax():
    """Three folds of the same frames (one voted-coordinate count, a flip
    base that changes), drained, against the JAX accumulator at W = 1."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.train import telemetry as j_telemetry

    rng = np.random.default_rng(6)
    n = 1003
    frames = []
    for _ in range(3):
        hist = rng.multinomial(n, np.ones(8) / 8).astype(np.int32)
        frames.append({
            "margin_hist": hist,
            "elected": rng.integers(0, 256, size=telemetry.elected_packed_len(n)).astype(np.uint8),
            "disagree": np.int32(rng.integers(0, n)), "voted": np.int32(n),
            "valid": np.int32(n), "stoch_flip_frac": np.float32(0.0),
            "flip_valid": np.bool_(True)})

    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    vh = j_telemetry.init_vote_health(n)
    vh_spec = jax.tree.map(lambda _: P(), vh)
    fr_spec = jax.tree.map(lambda _: P(), frames[0])
    fold = jax.jit(shard_map(lambda v, f: j_telemetry.fold(v, f, "data", 1, n), mesh=mesh,
                             in_specs=(vh_spec, fr_spec), out_specs=vh_spec, check_vma=False))
    tvh = telemetry.init_vote_health(n)
    for f in frames:
        vh = fold(vh, jax.tree.map(jnp.asarray, f))
        tvh = telemetry.fold(tvh, {k: torch.from_numpy(np.asarray(v)) for k, v in f.items()},
                             None, 1, n)
    for exact in (True, False):
        want, got = j_telemetry.drain(vh, exact), telemetry.drain(tvh, exact)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=0, err_msg=key)
    assert got["flip_rate"] > 0 and got["steps"] == 3
    reset = telemetry.reset_counters(tvh)
    assert int(reset.steps) == 0 and torch.equal(reset.prev_elected, tvh.prev_elected)


def test_run_clm_telemetry_logs_vote_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    trainer = run_clm.main([
        "--model_name", "tiny", "--compute_dtype", "float32", "--dataset", "synthetic",
        "--synthetic_blocks", "64", "--block_size", "32", "--per_device_train_batch_size", "2",
        "--gradient_accumulation_steps", "1", "--max_steps", "2", "--logging_steps", "1",
        "--dropout", "0", "--telemetry", "--output_dir", str(tmp_path)])
    assert "vote-health telemetry on: margin histogram EXACT" in capsys.readouterr().out
    rows = [h for h in trainer.history if "loss" in h]
    assert len(rows) == 2
    for h in rows:
        assert h["vote/hist_mass"] == 1.0 and h["vote/disagree_frac"] == 0.0
        assert h["vote/margin_hist"][-1] == 1.0 and h["vote/steps"] == 1
        assert h["vote/valid_frac"] == 1.0 and h["vote/margin_exact"] == 1
    assert rows[0]["vote/flip_rate"] == 0.0 < rows[1]["vote/flip_rate"]
    assert '"train/vote/hist_mass": 1.0' in (tmp_path / "metrics.jsonl").read_text()


def test_telemetry_without_lion_raises():
    with pytest.raises(ValueError, match="--telemetry instruments"):
        Trainer.for_gpt2(TrainConfig(lion=False, async_grad=False, telemetry=True),
                         run_clm.model_config(run_clm.ModelArguments(model_name="tiny")),
                         device="cpu")
