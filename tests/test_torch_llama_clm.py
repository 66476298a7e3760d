"""Full-parameter Llama pretraining (``run_clm --model_family llama``) vs the
JAX package's ``Trainer.for_llama``, on the CPU at ``LlamaConfig.tiny``.

The port's trainable tree lists its parameters in ``jax.tree.leaves``
order, so its flat buffer and offsets are the JAX package's. From JAX's
init carried across (``utils.serialization.llama_params_from_jax``), at
float32 compute, the same batches and no weight decay, the per-step losses
of the two trainers are held to 1e-4 at step 1 and to 2e-2 after it (the
JAX package's own tolerance for its Llama trajectories,
tests/test_llama_clm.py), densely and with ``--vocab_chunks 4``, at W = 1
and at W = 2 (two gloo ranks against a ``data=2`` mesh). ``model.npz``
written by ``run_clm`` gives the port's logits through the JAX package's
``load_pytree`` and ``llama_apply`` within 1e-5. The CLI's guards, and
the int32 limit of ``--telemetry``, raise by name.

jax is imported at the top, so the spawned ranks import it too; they use
only torch.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu.data.sources import batch_iterator as j_batch_iterator
from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
from distributed_lion_tpu.models.llama import LlamaConfig as JConfig
from distributed_lion_tpu.models.llama import llama_apply as j_apply
from distributed_lion_tpu.models.llama import llama_init as j_init
from distributed_lion_tpu.parallel import make_mesh
from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
from distributed_lion_tpu.train.loop import Trainer as JTrainer
from distributed_lion_tpu.utils.serialization import load_pytree as j_load_pytree
from distributed_lion_tpu_torch.cli import run_clm
from distributed_lion_tpu_torch.data.sources import batch_iterator
from distributed_lion_tpu_torch.models.llama import Llama, LlamaConfig, as_parameters
from distributed_lion_tpu_torch.parallel.mesh import data_grid
from distributed_lion_tpu_torch.train.loop import (
    TrainConfig,
    Trainer,
    check_telemetry_size,
)
from distributed_lion_tpu_torch.utils.serialization import (
    llama_params_from_jax,
    load_pytree,
    save_pytree,
)

torch.set_num_threads(2)

STEPS = 4
VOCAB_CHUNKS = (0, 4)
T = 32
COMMON = dict(lion=True, async_grad=True, learning_rate=3e-3, weight_decay=0.0,
              lr_scheduler_type="constant", max_steps=STEPS, per_device_train_batch_size=2,
              gradient_accumulation_steps=2, block_size=T, logging_steps=1, eval_steps=1000,
              seed=0)


def _jax_init():
    return jax.tree.map(np.asarray, j_init(jax.random.key(0), JConfig.tiny(
        compute_dtype=jnp.float32)))


def _jax_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)


def test_named_parameters_are_the_jax_leaf_order_and_offsets():
    init = _jax_init()
    leaves, _ = jax.tree_util.tree_flatten_with_path(init)
    model = Llama(LlamaConfig.tiny(), as_parameters(llama_params_from_jax(init)))
    named = model.jax_named_parameters()
    assert [n for n, _ in named] == [_jax_name(p) for p, _ in leaves]
    assert [n for n, _ in named][:9] == [
        "blocks.0.attn.wk", "blocks.0.attn.wo", "blocks.0.attn.wq", "blocks.0.attn.wv",
        "blocks.0.ln_attn.scale", "blocks.0.ln_mlp.scale", "blocks.0.mlp.w_down",
        "blocks.0.mlp.w_gate", "blocks.0.mlp.w_up"]
    assert [n for n, _ in named][-3:] == ["lm_head", "ln_f.scale", "wte"]
    trainer = Trainer.for_llama(TrainConfig(**COMMON), LlamaConfig.tiny(), device="cpu",
                                initial_params=llama_params_from_jax(init))
    trainer.close()
    sizes = [leaf.size for _, leaf in leaves]
    assert trainer.flat.offsets == list(np.cumsum([0] + sizes[:-1]))
    want = np.concatenate([leaf.reshape(-1) for _, leaf in leaves])
    np.testing.assert_array_equal(trainer.flat.params.numpy(), want)
    with pytest.raises(TypeError, match="as_parameters"):
        Llama(LlamaConfig.tiny(), llama_params_from_jax(init)).jax_named_parameters()


def _jax_losses(world: int, vocab_chunks: int, init, blocks) -> list:
    mesh = make_mesh(data=world, devices=jax.devices()[:world])
    # no remat on the reference side: the same numbers, less to compile
    jtr = JTrainer.for_llama(JTrainConfig(**COMMON, vocab_chunks=vocab_chunks), mesh,
                             JConfig.tiny(compute_dtype=jnp.float32, remat=False),
                             initial_params=init)
    hist = jtr.train(j_batch_iterator(blocks, jtr.global_train_batch(), seed=0))
    jtr.close()
    return [h["loss"] for h in hist if "loss" in h]


def _port_losses(vocab_chunks: int, init, blocks, group=None) -> list:
    trainer = Trainer.for_llama(TrainConfig(**COMMON, vocab_chunks=vocab_chunks),
                                LlamaConfig.tiny(compute_dtype=torch.float32), device="cpu",
                                initial_params=llama_params_from_jax(init), grid=data_grid(group))
    hist = trainer.train(batch_iterator(blocks, trainer.global_train_batch(), seed=0))
    trainer.close()
    return [h["loss"] for h in hist if "loss" in h]


def _w2_rank(rank, pg, tmp, out):
    dist.init_process_group("gloo", init_method=f"file://{pg}", rank=rank, world_size=2)
    torch.set_num_threads(1)
    try:
        init, blocks = load_pytree(f"{tmp}/init.npz"), np.load(f"{tmp}/blocks.npy")
        losses = [_port_losses(vc, init, blocks, dist.group.WORLD) for vc in VOCAB_CHUNKS]
        if rank == 0:
            with open(out, "w") as f:
                json.dump(losses, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [1, 2])
def test_losses_match_jax_trainer_for_llama(world, tmp_path):
    """Dense and ``--vocab_chunks 4``; at W = 2 both run in one spawn."""
    init = _jax_init()
    blocks = j_synthetic(128, T, JConfig.tiny().vocab_size)
    want = [_jax_losses(world, vc, init, blocks) for vc in VOCAB_CHUNKS]
    if world == 1:
        got = [_port_losses(vc, init, blocks) for vc in VOCAB_CHUNKS]
    else:
        save_pytree(tmp_path / "init.npz", init)  # spawn arguments go through files
        np.save(tmp_path / "blocks.npy", blocks)
        out = tmp_path / "losses.json"
        mp.spawn(_w2_rank, args=(str(tmp_path / "pg"), str(tmp_path), str(out)), nprocs=2,
                 join=True)
        got = json.loads(out.read_text())
    for vc, g, w in zip(VOCAB_CHUNKS, got, want):
        assert len(g) == len(w) == STEPS, vc
        np.testing.assert_allclose(g[0], w[0], atol=1e-4, rtol=0, err_msg=str(vc))
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=2e-2, err_msg=str(vc))
    np.testing.assert_allclose(got[1], got[0], atol=1e-4, rtol=0)  # chunked against dense


def test_loss_decreases():
    blocks = j_synthetic(256, T, 256)
    cfg = TrainConfig(**(COMMON | dict(max_steps=12, learning_rate=3e-3,
                                       lr_scheduler_type="cosine", warmup_steps=2)))
    trainer = Trainer.for_llama(cfg, LlamaConfig.tiny(), device="cpu")
    hist = trainer.train(batch_iterator(blocks, trainer.global_train_batch(), seed=0))
    trainer.close()
    losses = [h["loss"] for h in hist if "loss" in h]
    assert np.all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(losses[:3])


def test_run_clm_llama_model_npz_reproduces_in_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    trainer = run_clm.main([
        "--model_family", "llama", "--model_name", "tiny", "--compute_dtype", "float32",
        "--dataset", "synthetic", "--synthetic_blocks", "64", "--block_size", "32",
        "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "1",
        "--max_steps", "2", "--logging_steps", "1", "--learning_rate", "3e-3",
        "--warmup_steps", "1", "--vocab_chunks", "3", "--per_device_eval_batch_size", "2",
        "--eval_iters", "1", "--output_dir", str(tmp_path)])
    rows = [h for h in trainer.history if "loss" in h]
    assert len(rows) == 2 and np.isfinite([h["loss"] for h in rows]).all()
    tokens = np.random.default_rng(1).integers(0, 256, size=(2, 32)).astype(np.int32)
    want = j_apply(j_load_pytree(tmp_path / "model.npz"), jnp.asarray(tokens),
                   JConfig.tiny(compute_dtype=jnp.float32))
    with torch.no_grad():
        got = trainer.model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("flags,error,match", [
    (["--dropout", "0.1"], ValueError, "no dropout"),
    (["--vocab_pad_multiple", "64"], ValueError, "GPT-2 layout option"),
    (["--model_path", "/nonexistent"], ValueError, "unrecognized checkpoint format"),
    (["--hf_export", "hf_dir"], None, "config.json"),
    (["--model_name", "gpt2_124m"], ValueError, "unknown llama model_name")])
def test_cli_guards_raise_by_name(flags, error, match, monkeypatch, tmp_path):
    """The JAX CLI's guards; since the HF slice ``--model_path`` meets the
    JAX importer's own error for the same path and ``--hf_export`` writes
    the HF directory, as the JAX CLI does."""
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    argv = ["--model_family", "llama", "--model_name", "tiny", *flags]
    if error is None:
        run_clm.main(argv + ["--dataset", "synthetic", "--synthetic_blocks", "16",
                             "--block_size", "32", "--per_device_train_batch_size", "2",
                             "--gradient_accumulation_steps", "1", "--max_steps", "1"])
        assert (tmp_path / flags[1] / match).exists()
        return
    with pytest.raises(error, match=match):
        run_clm.main(argv)


def test_telemetry_refused_at_2_31_voted_coordinates():
    check_telemetry_size(2**31 - 1, 1, True)
    check_telemetry_size(2**33, 1, False)
    check_telemetry_size(2**33, 8, True)  # a step votes one eighth
    for n, ve in ((2**31, 1), (8_030_261_248, 1), (2**33, 4)):
        with pytest.raises(ValueError, match="--telemetry.*int32.*Queue 1 item 10"):
            check_telemetry_size(n, ve, True)
