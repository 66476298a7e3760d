"""Crash and resume of the port's trainer, on the CPU at a tiny size.

A 4-step run must equal 2 steps + a resume from the step-2 checkpoint + 2
steps bit for bit (losses, params, momentum): at ``vote_buckets`` 1 and 4,
deterministic and stochastic (the draws seeded from the restored count and
seed), with dropout on (its masks seeded from the restored step), with
``--telemetry`` (the vote-health accumulator too), at W = 2 over gloo
(every rank's momentum file), and for the SFT trainer (NF4 base, LoRA,
packed rows replayed). The resumed losses are held within 1e-5 of the JAX
package's uninterrupted run on the same init and batches (the W = 1
slice's bound, tests/test_torch_gpt2.py). The elastic remap equals the JAX
package's ``remap_worker_momentum`` bit for bit; a world mismatch without
``elastic_resume`` and a resume whose every candidate fails are loud.

jax is imported inside the test functions only, so the spawned ranks
import torch alone.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.cli import run_sft
from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.optim.distributed_lion import remap_worker_momentum
from distributed_lion_tpu_torch.parallel.mesh import data_grid
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer, momentum_file

torch.set_num_threads(2)

BLOCKS = synthetic_lm_dataset(64, 32, 256, seed=1)


def _cfg(out, steps, **kw):
    base = dict(lion=True, async_grad=True, learning_rate=1e-3, warmup_steps=1, max_steps=steps,
                per_device_train_batch_size=2, gradient_accumulation_steps=2, block_size=32,
                logging_steps=1, save_steps=2, output_dir=out, seed=5)
    base.update(kw)
    return TrainConfig(**base)


def _trainer(cfg, group=None, model=None):
    model = model or GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.1)
    return Trainer.for_gpt2(cfg, model, device="cpu", grid=data_grid(group))


def _losses(history):
    return [h["loss"] for h in history if "loss" in h]


def _state(t):
    vh = (None if t.vote_health is None else
          {f.name: getattr(t.vote_health, f.name).clone()
           for f in dataclasses.fields(t.vote_health)})
    return t.flat.params.clone(), t.state.exp_avg.clone(), vh


def _run(cfg, group=None):
    t = _trainer(cfg, group)
    h = t.train(batch_iterator(BLOCKS, t.global_train_batch(), seed=5))
    t.close()
    return t, _losses(h)


def _assert_resumed_matches(tmp_path, group=None, **kw):
    """4 uninterrupted steps against 2 + resume + 2; returns the resumed
    trainer."""
    ref, ref_losses = _run(_cfg(None, 4, **kw), group)
    out = str(tmp_path / "run")
    _, first = _run(_cfg(out, 2, **kw), group)
    t2 = _trainer(_cfg(out, 4, **kw), group)
    assert t2.step_count == 2 and int(t2.state.count) == 2 and t2.state.steps == 2
    h2 = t2.train(batch_iterator(BLOCKS, t2.global_train_batch(), seed=5))
    t2.close()
    assert first + _losses(h2) == ref_losses
    (p, m, vh), (rp, rm, rvh) = _state(t2), _state(ref)
    assert torch.equal(p, rp) and torch.equal(m, rm)
    assert (vh is None) == (rvh is None)
    if vh is not None:
        for k, v in vh.items():
            assert torch.equal(v, rvh[k]), k
    return t2


@pytest.mark.parametrize("stoch", [False, True], ids=["det", "stoch"])
@pytest.mark.parametrize("buckets", [1, 4])
def test_crash_resume_bit_identical(tmp_path, buckets, stoch):
    kw = {"vote_buckets": buckets}
    if stoch:
        kw["max_grad_norm"] = 1.0
    t2 = _assert_resumed_matches(tmp_path, **kw)
    assert t2.cfg.vote_buckets == buckets


def test_crash_resume_with_telemetry_restores_vote_health(tmp_path):
    t2 = _assert_resumed_matches(tmp_path, telemetry=True, vote_buckets=4)
    assert int(t2.vote_health.has_prev) == 1


def test_trainer_writes_the_manifest_meta_and_files(tmp_path):
    out = str(tmp_path / "run")
    t, _ = _run(_cfg(out, 2, telemetry=True))
    meta = t.checkpointer.manifest_meta(2)
    assert meta == {"world": 1, "tag": "periodic", "step": 2, "batches_consumed": 2,
                    "has_vote_health": True, "has_guard": False, "wire": "sign_psum",
                    "vote_every": 1, "dcn_pipeline_depth": 0, "ep_dcn_pipeline": 0,
                    "control_plane": False}
    state = t.checkpointer.restore(2, "state.pt")
    assert (state["step"], state["batches_consumed"], state["world"], state["steps"],
            state["seed"]) == (2, 2, 1, 2, 5)
    assert torch.equal(t.checkpointer.restore(2, momentum_file(0)), t.state.exp_avg)


def _w2_rank(rank, world, pg, out):
    dist.init_process_group("gloo", init_method=f"file://{pg}", rank=rank, world_size=world)
    torch.set_num_threads(1)
    try:
        group = dist.group.WORLD
        ref, ref_losses = _run(_cfg(None, 4, max_grad_norm=1.0, telemetry=True), group)
        _, first = _run(_cfg(out, 2, max_grad_norm=1.0, telemetry=True), group)
        mine = torch.load(f"{out}/checkpoints/2/{momentum_file(rank)}", weights_only=True)
        t2 = _trainer(_cfg(out, 4, max_grad_norm=1.0, telemetry=True), group)
        assert t2.step_count == 2 and torch.equal(t2.state.exp_avg, mine)
        h2 = t2.train(batch_iterator(BLOCKS, t2.global_train_batch(), seed=5))
        t2.close()
        assert first + _losses(h2) == ref_losses
        assert torch.equal(t2.flat.params, ref.flat.params)
        assert torch.equal(t2.state.exp_avg, ref.state.exp_avg)
        np.save(f"{out}/momentum_{rank}.npy", t2.state.exp_avg.numpy())
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_resume_and_resume_elastically(tmp_path):
    """W = 2, stochastic, telemetry: each rank's resumed momentum is its own
    file; then a W = 1 trainer refuses the W = 2 checkpoint without
    ``elastic_resume`` and with it starts from the mean of the two."""
    out = str(tmp_path / "run")
    mp.spawn(_w2_rank, args=(2, str(tmp_path / "pg"), out), nprocs=2, join=True)
    rows = [torch.load(f"{out}/checkpoints/4/{momentum_file(r)}", weights_only=True)
            for r in range(2)]
    for r in range(2):
        np.testing.assert_array_equal(rows[r].numpy(), np.load(f"{out}/momentum_{r}.npy"))
    assert not torch.equal(rows[0], rows[1])  # async_grad: each rank's momentum is its own
    assert torch.load(f"{out}/checkpoints/4/state.pt", weights_only=True)["world"] == 2
    with pytest.raises(ValueError, match="elastic_resume"):
        _trainer(_cfg(out, 6, max_grad_norm=1.0))
    cfg = _cfg(out, 6, max_grad_norm=1.0, elastic_resume=True, telemetry=True,
               per_device_train_batch_size=4)
    t = _trainer(cfg)
    assert t.step_count == 4 and int(t.vote_health.steps) == 0  # a fresh telemetry window
    assert torch.equal(t.state.exp_avg, remap_worker_momentum(torch.stack(rows), 2, 1)[0])
    h = t.train(batch_iterator(BLOCKS, t.global_train_batch(), seed=5))
    t.close()
    assert t.step_count == 6 and all(np.isfinite(_losses(h)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_from,w_to", [(4, 2), (2, 4), (4, 1), (3, 2)])
def test_remap_worker_momentum_matches_jax(w_from, w_to, dtype):
    import jax.numpy as jnp

    from distributed_lion_tpu.optim.distributed_lion import (
        remap_worker_momentum as j_remap,
    )

    x = np.random.default_rng(w_from * 10 + w_to).normal(size=(w_from, 4099)).astype(np.float32)
    mom = torch.from_numpy(x).to(getattr(torch, dtype))
    got = remap_worker_momentum(mom, w_from, w_to)
    want = j_remap({"m": jnp.asarray(mom.float().numpy()).astype(getattr(jnp, dtype))},
                   w_from, w_to)["m"]
    assert got.dtype == mom.dtype and got.shape == (w_to, 4099)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    np.testing.assert_allclose(got.float().mean(0).numpy(), mom.float().mean(0).numpy(),
                               rtol=1e-2 if dtype == "bfloat16" else 1e-5, atol=1e-2)


def test_resume_exhaustion_is_loud_not_step_zero(tmp_path, monkeypatch):
    out = str(tmp_path / "run")
    _run(_cfg(out, 2))

    def boom(self, step, meta, ckpt_world):
        raise KeyError("structure mismatch (injected)")

    monkeypatch.setattr(Trainer, "_restore_step", boom)
    with pytest.raises(RuntimeError, match="failed to restore"):
        _trainer(_cfg(out, 4))


def test_a_changed_model_fails_to_restore_loudly(tmp_path):
    out = str(tmp_path / "run")
    _run(_cfg(out, 2))
    wider = dataclasses.replace(GPT2Config.tiny(compute_dtype=torch.float32), d_model=32,
                                n_head=2)
    with pytest.raises(RuntimeError, match="failed to restore"):
        _trainer(_cfg(out, 4), model=wider)
    t = _trainer(_cfg(out, 4, resume_from_checkpoint=False))
    assert t.step_count == 0
    t.close()


def test_sft_trainer_resumes_bit_identical(tmp_path, monkeypatch):
    """run_sft on a tiny Llama, NF4 base, LoRA adapters: the checkpoint holds
    the adapters and their momenta, the base is rebuilt from the seed, and
    the packed rows are replayed."""
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    base = ["--model_name", "tiny", "--quant", "nf4", "--seq_length", "32",
            "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "2",
            "--logging_steps", "1", "--save_steps", "2", "--num_train_samples", "64",
            "--size_valid_set", "4", "--learning_rate", "3e-3", "--warmup_steps", "1"]
    ref, _, _ = run_sft.main(base + ["--max_steps", "4"])
    out = str(tmp_path / "sft")
    first, _, _ = run_sft.main(base + ["--max_steps", "2", "--output_dir", out])
    second, _, _ = run_sft.main(base + ["--max_steps", "4", "--output_dir", out])
    assert second.step_count == 4
    assert _losses(first.history) + _losses(second.history) == _losses(ref.history)
    assert torch.equal(second.flat.params, ref.flat.params)
    assert torch.equal(second.state.exp_avg, ref.state.exp_avg)
    names = second.checkpointer.restore(4, "params.pt")["names"]
    assert names == second.flat.names and all("lora" in n or n.endswith(("A", "B"))
                                              for n in names)


def test_resumed_losses_match_the_jax_trainer(tmp_path):
    """The port's 2 steps + resume + 2 steps against the JAX package's
    uninterrupted 4 (W = 1, float32, dropout 0, weight decay 0, constant
    LR): losses within 1e-5."""
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.data.sources import batch_iterator as j_batch_iterator
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer
    from distributed_lion_tpu_torch.utils.serialization import params_from_jax

    common = dict(lion=True, async_grad=True, learning_rate=3e-3, weight_decay=0.0,
                  lr_scheduler_type="constant", per_device_train_batch_size=2,
                  gradient_accumulation_steps=2, block_size=32, logging_steps=1, seed=0)
    # no remat on the reference side: the same numbers, less to compile
    jtr = JTrainer.for_gpt2(JTrainConfig(max_steps=4, **common),
                            make_mesh(data=1, devices=jax.devices()[:1]),
                            JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0, remat=False))
    init = params_from_jax(jax.tree.map(np.asarray, jtr.params))
    jlosses = _losses(jtr.train(j_batch_iterator(BLOCKS, jtr.global_train_batch(), seed=0)))
    jtr.close()

    model = GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.0)
    out = str(tmp_path / "run")
    losses = []
    for steps in (2, 4):
        t = Trainer.for_gpt2(TrainConfig(max_steps=steps, save_steps=2, output_dir=out,
                                         **common), model, device="cpu", initial_params=init)
        losses += _losses(t.train(batch_iterator(BLOCKS, t.global_train_batch(), seed=0)))
        t.close()
    assert t.step_count == 4
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
