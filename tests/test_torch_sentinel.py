"""The NaN sentinel and its crash bundle, port against the JAX package
(tests/test_vote_guard.py's sentinel cases and the JAX trainer's
``nan_sentinel``).

Tolerances: the tripping step, the trip reason and the bundle's poisoned
leaves (names and counts) are exact.

- At W = 1, ``--inject_poison nan_grads:0:2`` makes step 3's grads NaN: the
  port trips on the step the JAX trainer trips on, with its reason, and its
  bundle (strict JSON) names the same leaves: every momentum leaf, and no
  param (a NaN ballot votes −1, so the params move by a finite step).
- ``--trace_on_anomaly`` with a ``--profile_dir`` window: the
  ``profile_dir`` trace is written, then after the trip
  ``profile_num_steps`` more steps are traced into ``<bundle>/trace``
  before ``FloatingPointError`` (``torch.profiler`` runs on the CPU).
- At W = 4 (gloo, one spawn): under ``enforce`` a NaN rank is quarantined
  and the sentinel does not trip (the grad norm means over the finite
  ranks); under ``observe`` it trips and the bundle and the reason name the
  sick rank.

jax is imported inside the tests only, so the spawned ranks import torch
alone.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.parallel.mesh import data_grid
from distributed_lion_tpu_torch.train import resilience
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.utils.serialization import params_from_jax, save_pytree

TINY = dict(compute_dtype=torch.float32, dropout=0.0)
STEPS = 8
TRIP = 3  # the first NaN step (count 2) is folded after the next one is issued


def _cfg(out, steps=STEPS, poison="nan_grads:0:2", **kw):
    base = dict(lion=True, async_grad=True, wire="sign_psum", learning_rate=5e-3,
                lr_scheduler_type="constant", warmup_steps=0, max_steps=steps, weight_decay=0.0,
                per_device_train_batch_size=2, gradient_accumulation_steps=1, block_size=32,
                logging_steps=1, output_dir=out, nan_sentinel=True, inject_poison=poison,
                seed=42)
    base.update(kw)
    return base


def _blocks():
    return synthetic_lm_dataset(96, 32, 256, seed=4)


def _run(cfg: dict, group=None, init=None):
    """Train a port trainer; returns (trainer, the exception raised or None)."""
    tr = Trainer.for_gpt2(TrainConfig(**cfg), GPT2Config.tiny(**TINY), device="cpu",
                          grid=data_grid(group), initial_params=init)
    err = None
    try:
        tr.train(batch_iterator(_blocks(), tr.global_train_batch(), seed=0))
    except (FloatingPointError, RuntimeError) as e:
        err = e
    finally:
        tr.close()
    return tr, err


def _bundles(out):
    return sorted(pathlib.Path(out).glob("crash/step_*/bundle.json"))


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.models.gpt2 import gpt2_init

    path = tmp_path_factory.mktemp("init") / "init.npz"
    save_pytree(path, jax.tree.map(np.asarray, gpt2_init(
        jax.random.key(42), JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0))))
    return path


def test_sentinel_trips_on_jax_step_with_jax_leaves(init, tmp_path):
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.data.sources import batch_iterator as j_batch_iterator
    from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.parallel.mesh import make_mesh
    from distributed_lion_tpu.train import resilience as j_resilience
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer

    j_out = str(tmp_path / "jax")
    j_resilience.clear_faults()
    try:
        # no remat on the reference side: the same numbers, less to compile
        jtr = JTrainer.for_gpt2(JTrainConfig(**_cfg(j_out)), make_mesh(
            data=1, devices=jax.devices()[:1]), JConfig.tiny(compute_dtype=jnp.float32,
                                                              dropout=0.0, remat=False))
        with pytest.raises(FloatingPointError) as j_err:
            jtr.train(j_batch_iterator(j_synthetic(96, 32, 256, seed=4),
                                       jtr.global_train_batch(), seed=0))
        jtr.close()
    finally:
        j_resilience.clear_faults()
    out = str(tmp_path / "port")
    tr, err = _run(_cfg(out), init=params_from_jax(init))
    assert isinstance(err, FloatingPointError)
    assert str(err) == str(j_err.value) == f"non-finite grad_norm=nan at step {TRIP}"
    assert tr.step_count == TRIP + 1
    assert resilience.fault("ballot_poison") is None  # close() disarmed it
    (j_bundle,), (bundle,) = _bundles(j_out), _bundles(out)
    assert bundle.parent.name == j_bundle.parent.name == f"step_{TRIP:08d}"
    got = json.loads(bundle.read_text())  # strict JSON: json.loads refuses NaN only if
    # asked, so check the tokens too
    assert "NaN" not in bundle.read_text()
    want = json.loads(j_bundle.read_text())
    assert got["step"] == want["step"] == TRIP and got["reason"] == want["reason"]
    assert got["nonfinite_params"] == want["nonfinite_params"] == {}
    assert got["nonfinite_opt_state"] == want["nonfinite_opt_state"]
    n_leaves = len(tr.flat.names)
    assert len(got["nonfinite_opt_state"]) == n_leaves
    assert sum(got["nonfinite_opt_state"].values()) == tr.n_params
    assert got["metrics_window"][-1]["tripped"] is True
    assert got["metrics_window"][-1]["grad_norm"] == "nan"
    assert got["config"]["inject_poison"] == "nan_grads:0:2"


def test_trace_on_anomaly_traces_then_raises(init, tmp_path):
    out, prof = str(tmp_path / "run"), str(tmp_path / "prof")
    tr, err = _run(_cfg(out, trace_on_anomaly=True, profile_dir=prof, profile_start_step=1,
                        profile_num_steps=1), init=params_from_jax(init))
    assert isinstance(err, FloatingPointError)
    assert str(err) == f"non-finite grad_norm=nan at step {TRIP}"
    # tripped at the check after step TRIP + 1; 1 step traced, then 1 more
    assert tr.step_count == TRIP + 1 + 1 + 1
    assert [p.name for p in pathlib.Path(prof).iterdir()] == ["steps_1_2_rank0.trace.json"]
    (bundle,) = _bundles(out)
    traces = list((bundle.parent / "trace").iterdir())
    assert [p.name for p in traces] == [f"steps_{TRIP + 1}_{TRIP + 2}_rank0.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == f"train_step_{TRIP + 1}" for e in events)


def _work(rank, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/pg", rank=rank, world_size=4)
    try:
        res = {}
        tr, err = _run(_cfg(f"{out}/enforce", poison="nan_grads:3", vote_guard="enforce"),
                       dist.group.WORLD)
        res["enforce"] = {"error": None if err is None else str(err),
                          "mask": tr.state.health.tolist(),
                          "losses": [h["loss"] for h in tr.history if "loss" in h]}
        tr, err = _run(_cfg(f"{out}/observe", poison="nan_grads:3", vote_guard="observe"),
                       dist.group.WORLD)
        res["observe"] = {"error": repr(err), "step": tr.step_count}
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sentinel4")
    mp.spawn(_work, args=(str(out),), nprocs=4, join=True)
    return out, [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]


def test_enforce_degraded_mode_survives(four_ranks):
    out, recs = four_ranks
    for rec in recs:
        got = rec["enforce"]
        assert got["error"] is None and got["mask"] == [True, True, True, False]
        assert len(got["losses"]) == STEPS and np.isfinite(got["losses"]).all()
    assert not list((out / "enforce").glob("crash/*"))


def test_bundle_names_the_sick_rank(four_ranks):
    out, recs = four_ranks
    for rec in recs:
        assert rec["observe"]["error"].startswith("FloatingPointError(")
        assert "vote guard sick workers: [3]" in rec["observe"]["error"]
        assert rec["observe"]["step"] == 2  # step 1 trips after step 2 is issued
    (bundle,) = _bundles(out / "observe")
    got = json.loads(bundle.read_text())
    assert got["step"] == 1
    assert got["guard"]["sick_workers"]["3"]["nonfinite"] > 0
    assert got["guard"]["healthy_mask"] == [True] * 4
    # the NaN rank's momentum, summed over the ranks as JAX counts its stack
    assert sum(got["nonfinite_opt_state"].values()) > 0
