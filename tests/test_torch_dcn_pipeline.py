"""The cross-step DCN pipeline (``dcn_pipeline_depth``), port against the
JAX package (tests/test_dcn_overlap.py, the depth cells of
tests/test_crash_resume.py and tests/test_control_plane.py).

Paths and tolerances:

- ring-slot sizes, the bytes accounting and the refusals equal JAX's
  exactly (its codec and its messages);
- the slot bytes of ``hier_launch`` on every rank equal JAX ``hier_launch``
  under ``shard_map`` on a ``data=4`` mesh at g = 2, byte for byte, and the
  consumed elections equal JAX ``hier_consume``'s, with group 1 fully
  quarantined at launch, at consume, or never;
- the optimizer at depth {1, 2} × vote_buckets {1, 3} × vote_every {1, 4}
  for 7 steps against JAX ``distributed_lion`` (its XLA path, where JAX
  routes every pipelined step): the elections (the telemetry frame's packed
  signs, under lazy refresh the cache) and every rank's ring bytes are
  bit-identical; params and momentum, which the port's ``fused_apply``
  rounds per op where XLA:CPU contracts multiply-adds into FMAs, agree
  within 2 float32 ulps of their magnitude per step;
- depth 0 given explicitly is ``torch.equal`` to the default wire, its
  ``WireTally`` records included; the trainer's ``comm_drift_bytes`` is 0
  at depth {0, 1, 2};
- the ``dcn_delay`` link leaves the trajectory bit-identical and depth 1
  records less wait than depth 0; a crash and resume at depth 2 is
  ``torch.equal`` to the uninterrupted run (params, momenta, rings).

Every W = 4 case rides the test session's one spawn of four gloo ranks
(``test_torch_control_plane``'s ``ranks``), which calls :func:`rank_cases`.
"""

import json
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.ops import codec
from distributed_lion_tpu_torch.optim.distributed_lion import distributed_lion
from distributed_lion_tpu_torch.optim.lion import FlatParams
from distributed_lion_tpu_torch.parallel import collectives
from distributed_lion_tpu_torch.train import resilience
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer, make_optimizer
from distributed_lion_tpu_torch.utils.argparsing import build_parser
from test_torch_control_plane import (  # noqa: F401
    CLI_GROUPS,
    TINY,
    WORLD,
    _cfg,
    _train,
    _trainer,
    ranks,
)

N, STEPS, LR, WD = 300, 7, 0.01, 0.05
MATRIX = tuple((d, vb, ve) for d in (1, 2) for vb in (1, 3) for ve in (1, 4))
SLOT_N = 257
MASKS = {"all": [True] * 4, "g1_dead": [True, True, False, False]}
SLOT_CASES = (("all", "all"), ("g1_dead", "all"), ("all", "g1_dead"))
DELAY = 0.2
DELAY_STEPS = 4


def _inputs():
    rng = np.random.default_rng(3)
    return (rng.normal(size=N).astype(np.float32),
            rng.normal(size=(STEPS, WORLD, N)).astype(np.float32),
            rng.integers(0, 2, size=(WORLD, SLOT_N)).astype(bool))


def _sha(t):
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _ring_state(tr):
    return {"params": _sha(tr.flat.params), "momentum": _sha(tr.state.exp_avg),
            "ring": None if tr.state.dcn_ring is None else _sha(tr.state.dcn_ring)}


def rank_cases(world, out) -> dict:
    """The W = 4 rank side, inside the shared spawn: the slot and matrix
    arrays go to ``dcn_rank<r>.npz``; the trainer runs' records are
    returned."""
    rank, group = dist.get_rank(), dist.group.WORLD
    p0, gs, ballots = _inputs()
    arrays = {}
    hier = collectives.HierGroups(group, 2)
    mine = torch.where(torch.from_numpy(ballots[rank]), 1, -1).to(torch.int8)
    for la, ca in SLOT_CASES:
        tally = collectives.WireTally()
        slot = collectives.hier_launch(mine, hier, tally, torch.tensor(MASKS[la]), group).wait()
        elected = collectives.hier_consume(slot, SLOT_N, hier, tally, torch.tensor(MASKS[ca]))
        arrays[f"slot_{la}_{ca}"] = slot.numpy()
        arrays[f"elected_{la}_{ca}"] = (elected > 0).numpy()
    for d, vb, ve in MATRIX:
        opt = distributed_lion(LR, weight_decay=WD, group=group, wire="hier:2",
                               vote_buckets=vb, vote_every=ve, dcn_pipeline_depth=d,
                               telemetry=True)
        flat = FlatParams([("w", torch.nn.Parameter(torch.from_numpy(p0.copy())))])
        state = opt.init(flat)
        rec = {"p": [], "m": [], "elected": [], "ring": []}
        for t in range(STEPS):
            flat.grads.copy_(torch.from_numpy(gs[t, rank]))
            state, frame = opt.step(flat, state)
            rec["p"].append(flat.params.clone())
            rec["m"].append(state.exp_avg.clone())
            rec["elected"].append(frame["elected"].clone())
            rec["ring"].append(state.dcn_ring.clone())
        for k, v in rec.items():
            arrays[f"{d}{vb}{ve}_{k}"] = torch.stack(v).numpy()
    # depth 0 given explicitly against the default wire, guard enforce
    depth0 = []
    for kw in ({}, {"dcn_pipeline_depth": 0}):
        tally = collectives.WireTally()
        opt = distributed_lion(LR, weight_decay=WD, group=group, wire="hier:2", vote_buckets=3,
                               guard="enforce", tally=tally, **kw)
        flat = FlatParams([("w", torch.nn.Parameter(torch.from_numpy(p0.copy())))])
        state = opt.init(flat)
        for t in range(3):
            flat.grads.copy_(torch.from_numpy(gs[t, rank]))
            state, _ = opt.step(flat, state)
        depth0.append([_sha(flat.params), _sha(state.exp_avg), tally.entries])
    np.savez(f"{out}/dcn_rank{rank}.npz", **arrays)
    res = {"depth0": depth0, "ledger": {}}
    for d in (0, 1, 2):
        tr, _, _ = _train(_cfg(2, 1, wire="hier:2", dcn_pipeline_depth=d, telemetry=True), group)
        res["ledger"][str(d)] = {k: tr.history[0].get(k) for k in (
            "comm_bytes_per_step", "comm_measured_bytes_per_step", "comm_drift_bytes",
            "comm_measured_dcn_bytes_per_step", "dcn_overlap_frac")}
    # the dcn_delay link: depth 0 and 1 armed, depth 1 unarmed
    res["delay"] = {}
    for d, armed in ((0, True), (1, True), (1, False)):
        resilience.inject_fault("dcn_delay", DELAY if armed else None)
        collectives.dcn_link_reset()
        try:
            tr, losses, _ = _train(_cfg(2, DELAY_STEPS, wire="hier:2", dcn_pipeline_depth=d),
                                   group)
        finally:
            resilience.inject_fault("dcn_delay", None)
            collectives.dcn_link_reset()
        res["delay"][f"{d}_{armed}"] = {
            "wait": sum(r.get("dcn_wait_s", 0.0) for r in tr.history if "loss" in r),
            "state": _ring_state(tr), "losses": losses}
    # crash and resume with two launches in flight, guard and telemetry on
    spec = dict(wire="hier:2", dcn_pipeline_depth=2, vote_guard="enforce", telemetry=True)
    tr, full, _ = _train(_cfg(2, 6, **spec), group)
    res["resume_full"] = {"losses": full, "state": _ring_state(tr)}
    run = f"{out}/dcn_resume"
    _, first, _ = _train(_cfg(2, 3, outdir=run, save_steps=3, **spec), group)
    tr = _trainer(_cfg(2, 6, outdir=run, save_steps=3, **spec), group)
    step = tr.step_count
    tr, second, _ = _train(None, group, trainer=tr)
    res["resume"] = {"losses": first + second, "state": _ring_state(tr), "step": step}
    # a drop at depth 1 runs (a rejoin is refused at construction)
    tr, losses, _ = _train(_cfg(2, 4, wire="hier:2", dcn_pipeline_depth=1, control_plane=True,
                                inject_membership="worker_drop:1:2"), group)
    resilience.clear_faults()
    res["drop"] = {"losses": losses, "lifecycle": tr._cplane.lifecycle(),
                   "state": _ring_state(tr)}
    return res


# ------------------------------------------------------------ ring layout
@pytest.mark.parametrize("w,g", [(4, 2), (8, 4), (4, 4), (1, 1)])
def test_slot_sizes_and_accounting_equal_jax(w, g):
    from distributed_lion_tpu.ops import codec as jcodec

    for n in (7, 64, 1003, 123_457):
        for vb in (1, 3, 4):
            for ve in (1, 4):
                assert (codec.hier_ring_slot_bytes(n, w, g, vb, ve)
                        == jcodec.hier_ring_slot_bytes(n, w, g, vb, ve))
                for d in (0, 1, 2):
                    assert (codec.wire_bytes_per_param(n, w, f"hier:{g}", vote_every=ve,
                                                       vote_buckets=vb, dcn_pipeline_depth=d)
                            == jcodec.wire_bytes_per_param(n, w, f"hier:{g}", vote_every=ve,
                                                           vote_buckets=vb,
                                                           dcn_pipeline_depth=d))
        assert codec.hier_chunk_slot_bytes(n, w, g) == jcodec.hier_chunk_slot_bytes(n, w, g)
    with pytest.raises(ValueError, match="does not divide"):
        codec.hier_ring_slot_bytes(100, 8, 3)


def test_ring_shape_and_validation():
    """The ring is this rank's ``[d, hier_ring_slot_bytes]`` uint8 (JAX's
    ``[world, d, …]`` row); depth 0 has none; the JAX package's refusals,
    with its messages."""
    from distributed_lion_tpu.optim import distributed_lion as j_distributed_lion
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import make_optimizer as j_make_optimizer

    flat = FlatParams([("w", torch.nn.Parameter(torch.zeros(N)))])
    opt = distributed_lion(LR, wire="hier:1", dcn_pipeline_depth=3, vote_buckets=2)
    ring = opt.init(flat).dcn_ring
    assert ring.shape == (3, codec.hier_ring_slot_bytes(N, 1, 1, 2)) and ring.dtype == torch.uint8
    assert not ring.any()
    assert distributed_lion(LR, wire="hier:1").init(flat).dcn_ring is None

    def message(fn, **kw):
        with pytest.raises(ValueError) as e:
            fn(**kw)
        return str(e.value)

    for kw in (dict(wire="hier:4", dcn_pipeline_depth=-1), dict(wire="sign_psum",
               dcn_pipeline_depth=1), dict(wire="packed_a2a", dcn_pipeline_depth=2),
               dict(axis_name=None, wire="hier:2", dcn_pipeline_depth=1)):
        assert message(distributed_lion, **kw) == message(j_distributed_lion, **kw)
    for kw in (dict(wire="packed_a2a", dcn_pipeline_depth=1), dict(dcn_pipeline_depth=1),
               dict(lion=False, async_grad=False, dcn_pipeline_depth=1)):
        assert (message(lambda **k: make_optimizer(TrainConfig(**k)), **kw)
                == message(lambda **k: j_make_optimizer(JTrainConfig(**k)), **kw))
    with pytest.raises(ValueError, match="does not divide world 1"):
        distributed_lion(LR, wire="hier:2", dcn_pipeline_depth=1)


@pytest.mark.parametrize("cli", sorted(CLI_GROUPS))
def test_clis_take_the_flags(cli):
    """``--dcn_pipeline_depth`` and ``--zero1`` come with ``TrainConfig`` on
    every entry point, with JAX's defaults; the combinations JAX refuses
    are refused by the trainer they all build (``make_optimizer``, above)."""
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig

    args = build_parser(CLI_GROUPS[cli] + (TrainConfig,)).parse_args(
        ["--dcn_pipeline_depth", "2", "--zero1", "--wire", "hier:2"])
    assert (args.dcn_pipeline_depth, args.zero1, args.wire) == (2, True, "hier:2")
    for key in ("dcn_pipeline_depth", "zero1"):
        assert getattr(TrainConfig(), key) == getattr(JTrainConfig(), key)


def test_rejoin_at_depth_refused_at_construction():
    cfg = _cfg(2, 8, wire="hier:1", dcn_pipeline_depth=1, control_plane=True,
               inject_membership="worker_drop:0:2,worker_rejoin:0:4")
    with pytest.raises(ValueError, match="worker_rejoin.*dcn_pipeline"):
        Trainer.for_gpt2(TrainConfig(**cfg), GPT2Config.tiny(**TINY), device="cpu")


# -------------------------------------------------- the W = 4 spawn, JAX
def _jax_slots():
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.parallel import collectives as jcoll
    from distributed_lion_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    _, _, ballots = _inputs()

    def body(b, la, ca):
        slot = jcoll.hier_launch(b[0], "data", WORLD, 2, la)
        return slot[None], jcoll.hier_consume(slot, SLOT_N, "data", WORLD, 2, ca)[None]

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P(), P()),
                           out_specs=(P("data"), P("data")), check_vma=False))
    return {(la, ca): [np.asarray(x) for x in fn(jnp.asarray(ballots), jnp.asarray(MASKS[la]),
                                                 jnp.asarray(MASKS[ca]))]
            for la, ca in SLOT_CASES}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX references of the W = 4 cases, computed before the tests
    wait for the shared spawn (listed ahead of ``ranks``)."""
    return {"slots": _jax_slots(), **{case: _jax_matrix(*case) for case in MATRIX}}


def test_slot_bytes_per_rank_equal_jax(jax_refs, ranks):
    """Every rank's slot segment (launch mask row, then the packed verdicts
    of the chunk it owns, by source group) equals JAX ``hier_launch``'s for
    that worker; the consume gates a group fully quarantined at either end
    of the flight, as JAX ``hier_consume`` does."""
    out, _ = ranks
    want = jax_refs["slots"]
    for r in range(WORLD):
        got = np.load(out / f"dcn_rank{r}.npz")
        for la, ca in SLOT_CASES:
            slot, elected = want[(la, ca)]
            np.testing.assert_array_equal(got[f"slot_{la}_{ca}"], slot[r])
            np.testing.assert_array_equal(got[f"elected_{la}_{ca}"], elected[r])
    ex = {k: want[k][1][0] for k in want}
    np.testing.assert_array_equal(ex[("g1_dead", "all")], ex[("all", "g1_dead")])
    assert not np.array_equal(ex[("all", "all")], ex[("all", "g1_dead")])


def _jax_matrix(d, vb, ve):
    """JAX ``distributed_lion`` (XLA path) on a ``data=4`` mesh: per step the
    params, stacked momenta, elections (frame) and stacked ring."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.optim import (
        expand_worker_state,
        init_global_state,
        squeeze_worker_state,
    )
    from distributed_lion_tpu.optim import distributed_lion as j_distributed_lion
    from distributed_lion_tpu.optim.lion import LionState
    from distributed_lion_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    p0, gs, _ = _inputs()
    opt = j_distributed_lion(LR, weight_decay=WD, wire="hier:2", vote_buckets=vb,
                             vote_every=ve, dcn_pipeline_depth=d, telemetry=True)
    params = {"w": jnp.asarray(p0)}
    state = init_global_state(opt, params, WORLD)
    spec = LionState(count=P(), exp_avg={"w": P("data")}, rng=None,
                     elected=P() if ve > 1 else None, dcn_ring=P("data"))

    def body(p, g, s):
        p2, s2, frame = opt.step(p, {"w": g[0]}, squeeze_worker_state(s))
        return p2, expand_worker_state(s2), frame["elected"][None]

    step = jax.jit(shard_map(body, mesh=mesh, in_specs=({"w": P()}, P("data"), spec),
                             out_specs=({"w": P()}, spec, P("data")), check_vma=False))
    rec = {"p": [], "m": [], "elected": [], "ring": []}
    for t in range(STEPS):
        params, state, elected = step(params, jnp.asarray(gs[t]), state)
        rec["p"].append(np.asarray(params["w"]))
        rec["m"].append(np.asarray(state.exp_avg["w"]))
        rec["elected"].append(np.asarray(elected))
        rec["ring"].append(np.asarray(state.dcn_ring))
    return {k: np.stack(v) for k, v in rec.items()}


@pytest.mark.parametrize("d,vb,ve", MATRIX, ids=[f"d{d}-vb{vb}-ve{ve}" for d, vb, ve in MATRIX])
def test_pipelined_steps_match_jax(jax_refs, ranks, d, vb, ve):
    """Elections, caches and rings bit-identical to JAX's every step on every
    rank; params and momentum within 2 float32 ulps a step (FMA
    contraction on the JAX side)."""
    out, _ = ranks
    want = jax_refs[(d, vb, ve)]
    key = f"{d}{vb}{ve}"
    for r in range(WORLD):
        got = np.load(out / f"dcn_rank{r}.npz")
        np.testing.assert_array_equal(got[f"{key}_elected"], want["elected"][:, r])
        np.testing.assert_array_equal(got[f"{key}_ring"], want["ring"][:, r])
        for k, j in (("p", want["p"]), ("m", want["m"][:, r])):
            for t in range(STEPS):
                tol = 2 * (t + 1) * np.spacing(np.abs(j[t]).max())
                np.testing.assert_allclose(got[f"{key}_{k}"][t], j[t], rtol=0, atol=tol)
    # the first d steps take no sign step: the params only decay
    p0 = _inputs()[0]
    lazy = ve > 1
    moved = np.abs(want["p"][d - 1] - p0 * np.float32(1 - LR * WD) ** d) > LR / 2
    assert not moved.any()
    if not lazy:  # from step d + 1 every coordinate moves by the sign step
        assert (np.abs(want["p"][d] - want["p"][d - 1]) > LR / 2).all()


def test_depth0_is_the_default_wire(ranks):
    _, recs = ranks
    for r in range(WORLD):
        default, explicit = recs[r]["dcn"]["depth0"]
        assert default == explicit


def test_drift_zero_at_every_depth(ranks):
    _, recs = ranks
    for r in range(WORLD):
        for d, row in recs[r]["dcn"]["ledger"].items():
            assert row["comm_drift_bytes"] == 0, (d, row)
            assert row["comm_measured_bytes_per_step"] == row["comm_bytes_per_step"]
            assert row["comm_measured_dcn_bytes_per_step"] > 0
            assert row["dcn_overlap_frac"] == (1.0 if d != "0" else 0.0)


def test_dcn_delay_is_timing_only_and_depth_hides_it(ranks):
    """Armed and unarmed runs are ``torch.equal``; depth 0 pays the delay
    every step, less the legs run between stamp and consume (at least one
    delay's worth over the run, whatever the load), and depth 1 leaves at
    most 3/4 of what depth 0 paid: its first step consumes no launch and
    the later ones count a whole step toward the round trip."""
    _, recs = ranks
    for r in range(WORLD):
        delay = recs[r]["dcn"]["delay"]
        assert delay["1_True"]["state"] == delay["1_False"]["state"]
        assert delay["1_True"]["losses"] == delay["1_False"]["losses"]
        assert delay["1_False"]["wait"] == 0.0
        wait0, wait1 = delay["0_True"]["wait"], delay["1_True"]["wait"]
        assert wait0 >= DELAY, wait0
        assert wait1 <= 0.75 * wait0, (wait0, wait1)


def test_crash_resume_mid_flight_equals_uninterrupted(ranks):
    _, recs = ranks
    for r in range(WORLD):
        rec = recs[r]["dcn"]
        assert rec["resume"]["step"] == 3
        assert rec["resume"]["losses"] == rec["resume_full"]["losses"]
        assert rec["resume"]["state"] == rec["resume_full"]["state"]
        assert rec["resume"]["state"]["params"] == recs[0]["dcn"]["resume"]["state"]["params"]


def test_drop_runs_at_depth(ranks):
    _, recs = ranks
    for r in range(WORLD):
        drop = recs[r]["dcn"]["drop"]
        assert drop["lifecycle"] == ["healthy", "departed", "healthy", "healthy"]
        assert len(drop["losses"]) == 4 and all(np.isfinite(drop["losses"]))
        assert drop["state"]["params"] == recs[0]["dcn"]["drop"]["state"]["params"]


def test_resume_refusals(ranks, tmp_path):
    """A depth toggle on resume, and an elastic resume at depth > 0, refuse
    with the JAX package's reasons."""
    out, _ = ranks
    run = tmp_path / "run"
    shutil.copytree(out / "dcn_resume", run)
    for other in (0, 1):
        with pytest.raises(ValueError, match="does not survive a depth change"):
            _trainer(_cfg(2, 8, outdir=str(run), wire="hier:1", dcn_pipeline_depth=other), None)
    with pytest.raises(NotImplementedError, match="cannot remap the DCN pipeline ring"):
        _trainer(_cfg(2, 8, outdir=str(run), wire="hier:1", dcn_pipeline_depth=2,
                      elastic_resume=True), None)
    meta = json.loads((run / "checkpoints" / "3" / "manifest.json").read_text())
    assert meta["meta"]["dcn_pipeline_depth"] == 2
