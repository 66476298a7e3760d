"""The AdamW baseline (``--lion false --async_grad false``): the port's
``optim/optax_adapter.adamw`` against ``optax.adamw`` and the port's
trainer against the JAX package's, on the CPU at a tiny size.

Tolerances, fixed before the runs:
- the optimizer alone, 6 steps under the cosine schedule with warmup, from
  the same seeded params and grads. float32: moments within rtol 1e-6 plus
  one ulp of their largest magnitude per step (XLA:CPU contracts
  ``(1-b)*g + b*m`` into one FMA, the port rounds twice; ``b**count`` is
  XLA's ``pow``, the port's ``torch.pow``, which can differ in the last
  bit), params within 4 float32 ulps of their largest magnitude per step.
  bfloat16: moments and params within one bfloat16 ulp of their largest
  magnitude per step (XLA:CPU rounds each bfloat16 operation, as the port
  does; the float32 bias correction may round apart once cast).
- the tiny GPT-2 trainer (float32, dropout 0) at W = 1 and at W = 2 over
  gloo against the JAX trainer at data = 1 and 2 on the same init and
  batches: per-step losses within 1e-5 (the slice's bound,
  tests/test_torch_gpt2.py).
- a resume: 2 steps + a resume + 2 steps ``torch.equal`` to 4 steps
  (losses, params, both moments, the count), and the JAX package's
  ``verify_step_dir`` accepts the port's step.

jax is imported inside the test functions only, so the spawned ranks
import torch alone.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.optim.lion import FlatParams
from distributed_lion_tpu_torch.optim.optax_adapter import AdamWState, adamw
from distributed_lion_tpu_torch.parallel.mesh import data_grid
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer, make_optimizer
from distributed_lion_tpu_torch.train.schedule import cosine_schedule_with_warmup
from distributed_lion_tpu_torch.utils.serialization import params_from_jax, save_pytree

torch.set_num_threads(2)

N, STEPS, PEAK, WARMUP = 4099, 6, 3e-3, 2
TRAIN = dict(lion=False, async_grad=False, learning_rate=1e-3, warmup_steps=1, max_steps=3,
             per_device_train_batch_size=2, gradient_accumulation_steps=2, block_size=32,
             logging_steps=1, eval_steps=1000, seed=0)


def _bf16_ulp(x: np.ndarray) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax(dtype):
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_lion_tpu.train.schedule import cosine_schedule_with_warmup as j_cosine

    rng = np.random.default_rng(7)
    p0 = rng.normal(size=N).astype(np.float32)
    grads = rng.normal(size=(STEPS, N)).astype(np.float32) * 0.1
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    tx = optax.adamw(j_cosine(PEAK, WARMUP, STEPS), b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.1)
    jp = jnp.asarray(p0).astype(jdt)
    jstate = tx.init(jp)

    @jax.jit
    def jstep(p, g, st):
        updates, st = tx.update(g, st, p)
        return optax.apply_updates(p, updates), st

    flat = FlatParams([("p", torch.nn.Parameter(torch.from_numpy(p0.copy()).to(tdt)))])
    opt = adamw(cosine_schedule_with_warmup(PEAK, WARMUP, STEPS))
    state = opt.init(flat)
    for t, g in enumerate(grads, 1):
        jp, jstate = jstep(jp, jnp.asarray(g).astype(jdt), jstate)
        flat.grads.copy_(torch.from_numpy(g).to(tdt))
        state = opt.step(flat, state)
        adam = jstate[0]
        for got, want, what in ((state.mu, adam.mu, "mu"), (state.nu, adam.nu, "nu"),
                                (flat.params, jp, "params")):
            got = got.float().numpy()
            want = np.asarray(want.astype(jnp.float32))
            if dtype == "bfloat16":
                tol = dict(rtol=0, atol=t * _bf16_ulp(want))
            elif what == "params":
                tol = dict(rtol=0, atol=4 * t * np.spacing(np.abs(want).max()))
            else:
                tol = dict(rtol=1e-6, atol=t * np.spacing(np.abs(want).max()))
            np.testing.assert_allclose(got, want, err_msg=f"{what} step {t}", **tol)
        assert int(state.count) == int(adam.count) == t


def _jax_losses(world):
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.data.sources import batch_iterator as j_batch_iterator
    from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer

    mesh = make_mesh(data=world, devices=jax.devices()[:world])
    # no remat on the reference side: the same numbers, less to compile
    jtr = JTrainer.for_gpt2(JTrainConfig(**TRAIN), mesh,
                            JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0, remat=False))
    hist = jtr.train(j_batch_iterator(j_synthetic(256, 32, 256), jtr.global_train_batch(),
                                      seed=0))
    jtr.close()
    return [h["loss"] for h in hist if "loss" in h], jtr


def _jax_init(out):
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
    from distributed_lion_tpu.models.gpt2 import gpt2_init

    init = gpt2_init(jax.random.key(TRAIN["seed"]),
                     JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0))
    save_pytree(out / "init.npz", jax.tree.map(np.asarray, init))


def _port_losses(out, group=None):
    tr = Trainer.for_gpt2(TrainConfig(**TRAIN),
                          GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.0),
                          device="cpu", initial_params=params_from_jax(f"{out}/init.npz"),
                          grid=data_grid(group))
    assert isinstance(tr.state, AdamWState) and tr.comm_stats() == {}
    hist = tr.train(batch_iterator(synthetic_lm_dataset(256, 32, 256), tr.global_train_batch(),
                                   seed=0))
    tr.close()
    return [h["loss"] for h in hist if "loss" in h], tr


def _two_rank_work(rank, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/pg", rank=rank, world_size=2)
    try:
        losses, tr = _port_losses(out, dist.group.WORLD)
        np.save(f"{out}/loss_{rank}.npy", np.array(losses))
        np.save(f"{out}/params_{rank}.npy", tr.flat.params.numpy())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [1, 2])
def test_adamw_trainer_matches_jax(world, tmp_path):
    _jax_init(tmp_path)
    want, _ = _jax_losses(world)
    if world == 1:
        got, _ = _port_losses(tmp_path)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    mp.spawn(_two_rank_work, args=(str(tmp_path),), nprocs=2, join=True)
    for r in range(2):
        np.testing.assert_allclose(np.load(tmp_path / f"loss_{r}.npy"), want, atol=1e-5, rtol=0)
    # replicated state: both ranks hold the same params
    np.testing.assert_array_equal(np.load(tmp_path / "params_0.npy"),
                                  np.load(tmp_path / "params_1.npy"))


def test_adamw_resume_equals_uninterrupted_and_verifies(tmp_path):
    from distributed_lion_tpu.train.resilience import verify_step_dir

    blocks = synthetic_lm_dataset(64, 32, 256, seed=1)
    model = GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.1)

    def run(out, steps):
        cfg = TrainConfig(**dict(TRAIN, max_steps=steps, save_steps=2, output_dir=out, seed=5))
        t = Trainer.for_gpt2(cfg, model, device="cpu")
        h = t.train(batch_iterator(blocks, t.global_train_batch(), seed=5))
        t.close()
        return t, [x["loss"] for x in h if "loss" in x]

    ref, ref_losses = run(None, 4)
    out = str(tmp_path / "run")
    _, first = run(out, 2)
    assert verify_step_dir(f"{out}/checkpoints/2")
    resumed, rest = run(out, 4)
    assert first + rest == ref_losses
    for a, b in ((resumed.flat.params, ref.flat.params), (resumed.state.mu, ref.state.mu),
                 (resumed.state.nu, ref.state.nu), (resumed.state.count, ref.state.count)):
        assert torch.equal(a, b)
    assert verify_step_dir(f"{out}/checkpoints/4")


def test_adamw_refusals_keep_the_jax_packages_words():
    for kw, match in ((dict(async_grad=True), "--async_grad without --lion"),
                      (dict(async_grad=False, telemetry=True), "--telemetry instruments")):
        with pytest.raises(ValueError, match=match):
            make_optimizer(TrainConfig(lion=False, **kw))
