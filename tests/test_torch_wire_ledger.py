"""The measured wire ledger and the step-skew heartbeat, port against the
JAX package (tests/test_telemetry.py's measured-wire cases).

The ledger's bytes are exact: over the four wires at ``vote_every`` {1, 4}
and ``vote_buckets`` {1, 4} at W = 4, a trainer's first telemetry row has
``comm_measured_bytes_per_step`` equal to ``profiling.comm_report``'s
analytic bytes (``comm_drift_bytes`` 0) and ``host_step_skew`` 0, and its
ledger equals JAX ``measure_step_wire``'s on a ``data=4`` mesh at the same
coordinate count: the same totals and the same launches, each with its leg
and bytes. Their order is each package's own: the port starts bucket k + 1's
first collective before it finishes bucket k (packed_a2a's verdict gather,
hier's later legs), where JAX's trace records each bucket's collectives in
turn. The W = 4 runs ride the
session's one spawn of four gloo ranks (``test_torch_control_plane``'s
``ranks`` fixture); a world of one measures nothing and has no skew.
"""

import numpy as np
import pytest
import torch

from distributed_lion_tpu_torch.data.sources import batch_iterator
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.ops.codec import wire_bytes_per_param
from distributed_lion_tpu_torch.parallel import collectives
from distributed_lion_tpu_torch.train import telemetry
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.train.profiling import comm_report
from test_torch_control_plane import LEDGER_CASES, WORLD, _blocks, _cfg, ranks  # noqa: F401

CASE_IDS = [f"{w}-ve{ve}-vb{vb}" for w, ve, vb in LEDGER_CASES]


def _case(recs, rank, case):
    wire, ve, vb = case
    return recs[rank]["ledger"][f"{wire}|{ve}|{vb}"]


@pytest.mark.parametrize("case", LEDGER_CASES, ids=CASE_IDS)
def test_measured_bytes_equal_analytic_at_w4(ranks, case):
    """Drift 0 on every rank: the captured launches' bytes are the analytic
    bytes of ``comm_report`` and of ``codec.wire_bytes_per_param``, the
    hier wire's cross-group leg included; the heartbeat reads 0."""
    _, recs = ranks
    wire, ve, vb = case
    for r in range(WORLD):
        got = _case(recs, r, case)
        row, ledger = got["row"], got["ledger"]
        acct = wire_bytes_per_param(got["n"], WORLD, wire, vote_every=ve, vote_buckets=vb)
        analytic = comm_report(got["n"], WORLD, wire, vote_every=ve, vote_buckets=vb)
        assert row["comm_drift_bytes"] == 0, (r, row)
        assert row["comm_measured_bytes_per_step"] == row["comm_bytes_per_step"] \
            == analytic["comm_bytes_per_step"] == acct["bytes_per_step"] \
            == ledger["bytes_per_step"]
        assert row["comm_measured_calls_per_step"] == ledger["calls_per_step"] \
            == len(ledger["per_call"])
        assert ledger["dcn_bytes_per_step"] == acct.get("dcn_bytes_per_step", 0)
        assert row["comm_measured_dcn_bytes_per_step"] == (acct.get("dcn_bytes_per_step")
                                                           or None)
        assert row["host_step_skew"] == 0
        assert ledger == _case(recs, 0, case)["ledger"]


def _jax_ledger(n, wire, ve, vb):
    """JAX ``telemetry.measure_step_wire`` of one optimizer step at ``n``
    coordinates on a ``data=4`` mesh (an abstract trace: no compile)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.optim import (
        distributed_lion,
        expand_worker_state,
        init_global_state,
        squeeze_worker_state,
    )
    from distributed_lion_tpu.optim.lion import LionState
    from distributed_lion_tpu.parallel.mesh import make_mesh
    from distributed_lion_tpu.train import telemetry as j_telemetry

    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    params, grads = {"p": jnp.zeros((n,))}, {"p": jnp.zeros((WORLD, n))}
    opt = distributed_lion(0.01, wire=wire, vote_every=ve, vote_buckets=vb)
    state = init_global_state(opt, params, WORLD)
    p_spec = {"p": P()}
    st_spec = LionState(count=P(), exp_avg=jax.tree.map(lambda _: P("data"), state.exp_avg),
                        rng=None, elected=P() if ve > 1 else None)

    def step(params, grads, state):
        def body(p, g, st):
            p2, st2 = opt.step(p, jax.tree.map(lambda x: x[0], g), squeeze_worker_state(st))
            return p2, expand_worker_state(st2)

        return shard_map(body, mesh=mesh, in_specs=(p_spec, {"p": P("data")}, st_spec),
                         out_specs=(p_spec, st_spec), check_vma=False)(params, grads, state)

    return j_telemetry.measure_step_wire(step, params, grads, state)


@pytest.mark.parametrize("case", LEDGER_CASES, ids=CASE_IDS)
def test_ledger_equals_jax_measure_step_wire(ranks, case):
    """The port's ledger is the JAX package's at the same coordinate count,
    wire, vote_every and vote_buckets: the totals, and the launches with
    their legs and bytes (in each package's own launch order)."""
    _, recs = ranks
    got = dict(_case(recs, 0, case)["ledger"])
    want = _jax_ledger(_case(recs, 0, case)["n"], *case)

    def launches(ledger):
        return sorted((c["leg"], c["bytes"]) for c in ledger.pop("per_call"))

    assert launches(got) == launches(want)
    assert got == want


def test_capture_collects_every_tally_and_nothing_outside():
    tally = collectives.WireTally()
    tally.record("ici", 10)  # outside a capture: kept by the tally only
    with collectives.WIRE_TALLY.capture() as entries:
        tally.record("ici", 7)
        collectives.WireTally().record("dcn", 3)
        tally.record("ici", 0)  # nothing moved, nothing recorded
        with collectives.WIRE_TALLY.capture() as inner:
            tally.record("ici", 5)
        tally.record("dcn", 2)
    tally.record("ici", 1)
    assert entries == [("ici", 7), ("dcn", 3), ("dcn", 2)] and inner == [("ici", 5)]
    assert tally.entries == [("ici", 10), ("ici", 7), ("ici", 5), ("dcn", 2), ("ici", 1)]
    assert telemetry.ledger_of(entries) == {
        "bytes_per_step": 12, "dcn_bytes_per_step": 5, "calls_per_step": 3,
        "per_call": [{"leg": "ici", "bytes": 7}, {"leg": "dcn", "bytes": 3},
                     {"leg": "dcn", "bytes": 2}]}


def test_ledger_keys_equal_jax():
    want = _jax_ledger(1024, "packed_a2a", 1, 2)
    got = telemetry.ledger_of([(c["leg"], c["bytes"]) for c in want["per_call"]])
    assert got == want and set(got) == {"bytes_per_step", "dcn_bytes_per_step",
                                        "calls_per_step", "per_call"}


def test_measure_step_wire_returns_the_steps_result():
    def step(x):
        collectives.WireTally().record("ici", x)
        return x * 2

    out, ledger = telemetry.measure_step_wire(step, 21)
    assert out == 42 and ledger["bytes_per_step"] == 21 and ledger["calls_per_step"] == 1


@pytest.mark.parametrize("journal", [False, True])
def test_world_of_one_has_no_ledger_and_no_skew(tmp_path, journal):
    """A world of one moves no vote bytes: no ledger, no ``comm_*`` keys, no
    ``host_step_skew``; the journal's ``step_log`` events carry no
    ``skew_steps``."""
    cfg = _cfg(2, 2, telemetry=True, journal=journal, output_dir=str(tmp_path))
    tr = Trainer.for_gpt2(TrainConfig(**cfg), GPT2Config.tiny(compute_dtype=torch.float32,
                                                              dropout=0.0), device="cpu")
    try:
        tr.train(batch_iterator(_blocks(), tr.global_train_batch(), seed=0))
    finally:
        tr.close()
    assert tr._wire_measured is None and tr._side is None
    for row in tr.history:
        assert not [k for k in row if k.startswith("comm_") or k == "host_step_skew"], row
    assert telemetry.host_step_skew(2, None) is None
    logs = [r for r in tr.journal.tail() if r["name"] == "step_log"]
    assert len(logs) == (2 if journal else 0)
    assert not any("skew_steps" in r for r in logs)
    np.testing.assert_array_equal([r["step"] for r in logs], [1, 2][:len(logs)])
