"""The port's GPT-2, trainer and CLI vs the JAX package, on the CPU at the
``tiny`` size (2 layers, d 64), from carried-over weights.

Tolerances: float32 logits and grads ``atol=1e-5, rtol=1e-4`` (the two
frameworks sum matmuls and softmaxes in different orders); bfloat16-compute
logits ``atol=2e-2``. At bfloat16 compute the tied head and the attention
scores are float32-result products in both packages; at logits and scores
of GPT-2's magnitude, where one bfloat16 ulp is 0.03–0.06, the port holds
the head to ``1e-4`` and attention to a quarter ulp of its output. The slice test holds per-step losses to ``1e-5`` and
needs ≥ 99.9% of the final params bit-equal, with every coordinate within
``2·lr·steps`` (a flipped election moves a coordinate by 2·lr). It runs
with weight decay 0: with decay the JAX reference's CPU update is one FMA
and the port's two roundings (tests/test_torch_fused_lion.py), which would
leave most coordinates one ulp apart for a reason that is not the slice's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.data.sources import batch_iterator as j_batch_iterator
from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
from distributed_lion_tpu.models.gpt2 import gpt2_apply as j_apply
from distributed_lion_tpu.models.gpt2 import gpt2_hidden as j_hidden
from distributed_lion_tpu.models.gpt2 import gpt2_init as j_init
from distributed_lion_tpu.models.loss import clm_loss_and_metrics as j_loss
from distributed_lion_tpu.ops.attention import attention_xla as j_attention_xla
from distributed_lion_tpu.parallel import make_mesh
from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
from distributed_lion_tpu.train.loop import Trainer as JTrainer
from distributed_lion_tpu.utils.serialization import load_pytree as j_load_pytree
from distributed_lion_tpu_torch.cli import run_clm
from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_lion_tpu_torch.models.loss import clm_loss_and_metrics
from distributed_lion_tpu_torch.ops.attention import attention_xla, resolve_impl
from distributed_lion_tpu_torch.ops.products import matmul_f32
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.utils.serialization import (
    momentum_from_jax,
    params_from_jax,
    params_to_jax,
)

# tiny shapes: more intra-op threads only add contention with the other
# test workers
torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-4)


def _carried(compute: str):
    jcfg = JConfig.tiny(compute_dtype=getattr(jnp, compute))
    jparams = jax.tree.map(np.asarray, j_init(jax.random.key(0), jcfg))
    model = GPT2(GPT2Config.tiny(compute_dtype=getattr(torch, compute)), device="cpu")
    model.load_state_dict(params_from_jax(jparams))
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 32)).astype(np.int32)
    return jcfg, jparams, model, tokens


def test_carried_weights_logits_and_grads_float32():
    jcfg, jparams, model, tokens = _carried("float32")

    def loss_fn(p):
        return j_loss(j_apply(p, jnp.asarray(tokens), jcfg), jnp.asarray(tokens))[0]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    logits = model(torch.from_numpy(tokens))
    want_logits = jax.jit(lambda p: j_apply(p, jnp.asarray(tokens), jcfg))(jparams)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **TOL)
    loss, _ = clm_loss_and_metrics(logits, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)


def test_carried_weights_logits_bfloat16_compute():
    jcfg, jparams, model, tokens = _carried("bfloat16")
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    want = jax.jit(lambda p: j_apply(p, jnp.asarray(tokens), jcfg))(jparams)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=2e-2, rtol=0)


def test_bfloat16_tied_head_keeps_float32_logits_like_jax():
    """The head fed the JAX model's own bfloat16 final hidden state, with
    ``wte`` scaled so the logits reach GPT-2's magnitude: the port's
    logits equal the JAX package's to far below one bfloat16 ulp, where
    rounding the product to bfloat16 first would miss by up to half an
    ulp."""
    jcfg, jparams, model, tokens = _carried("bfloat16")
    jparams = dict(jparams, wte=jparams["wte"] * 10)
    model.load_state_dict(params_from_jax(jparams))
    want = np.asarray(jax.jit(lambda p: j_apply(p, jnp.asarray(tokens), jcfg))(jparams))
    hidden = jax.jit(lambda p: j_hidden(p, jnp.asarray(tokens), jcfg)[0])(jparams)
    with torch.no_grad():
        got = model.head(torch.from_numpy(np.asarray(hidden, np.float32)).bfloat16())
    assert got.dtype == torch.float32 and np.abs(want).max() > 8.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_bfloat16_attention_keeps_float32_scores_like_jax():
    """``attention_xla`` at bfloat16 with scores of several units, against
    the JAX package's: within a quarter of a bfloat16 ulp of the output's
    largest binade [2, 4)."""
    rng = np.random.default_rng(3)
    q, k = (rng.normal(size=(2, 4, 32, 16)).astype(np.float32) * 3 for _ in range(2))
    v = rng.normal(size=(2, 4, 32, 16)).astype(np.float32)
    want = np.asarray(j_attention_xla(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))),
                      np.float32)
    got = attention_xla(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16 and 2.0 <= np.abs(want).max() < 4.0
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -9, rtol=0)


@pytest.mark.parametrize("shape_b", [(16, 24), (3, 16, 24)], ids=["shared", "batched"])
def test_matmul_f32_forward_and_grads(shape_b):
    """float32: value and grads of ``torch.matmul``. bfloat16: a float32
    value equal to the upcast product, and grads that are the bfloat16
    products of the cotangent rounded to bfloat16."""
    rng = np.random.default_rng(4)
    a0 = torch.from_numpy(rng.normal(size=(3, 8, 16)).astype(np.float32))
    b0 = torch.from_numpy(rng.normal(size=shape_b).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 8, 24)).astype(np.float32))

    a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    ra, rb = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    matmul_f32(a, b).backward(g)
    torch.matmul(ra, rb).backward(g)
    torch.testing.assert_close(a.grad, ra.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(b.grad, rb.grad, rtol=1e-6, atol=1e-6)

    a, b = (t.bfloat16().requires_grad_() for t in (a0, b0))
    out = matmul_f32(a, b)
    assert out.dtype == torch.float32
    assert torch.equal(out, torch.matmul(a.detach().float(), b.detach().float()))
    out.backward(g)
    gb16 = g.bfloat16()
    assert torch.equal(a.grad, torch.matmul(gb16, b.detach().transpose(-1, -2)))
    want_b = (a.detach().reshape(-1, 16).t() @ gb16.reshape(-1, 24) if len(shape_b) == 2
              else torch.matmul(a.detach().transpose(-1, -2), gb16))
    assert b.grad.dtype == torch.bfloat16 and torch.equal(b.grad, want_b)


def test_serialization_round_trip_and_momentum_row():
    _, jparams, model, _ = _carried("float32")
    back = params_to_jax(model)
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    stacked = jax.tree.map(lambda a: np.stack([a, 2 * a]), jparams)
    row1 = momentum_from_jax(stacked, 1)
    np.testing.assert_array_equal(row1["blocks.1.mlp.fc"].numpy(),
                                  2 * jparams["blocks"][1]["mlp"]["fc"])


def test_remat_redraws_the_same_dropout_masks():
    """With dropout on, a rematerialized block regenerates its masks from
    the seed, so remat changes neither the loss nor the grads."""
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, size=(2, 32)))
    out = []
    for remat in (True, False):
        model = GPT2(GPT2Config.tiny(dropout=0.1, remat=remat,
                                     compute_dtype=torch.float32), device="cpu", seed=4)
        loss, _ = clm_loss_and_metrics(model(tokens, dropout_seed=123), tokens)
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert out[0][0] == out[1][0]
    for name, g in out[0][1].items():
        torch.testing.assert_close(g, out[1][1][name], rtol=1e-6, atol=1e-7)
    model = GPT2(GPT2Config.tiny(dropout=0.1, compute_dtype=torch.float32), device="cpu")
    with torch.no_grad():
        a, b, c = (model(tokens, dropout_seed=s) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_slice_trainer_matches_jax_trainer():
    """The port's Trainer vs the JAX Trainer.for_gpt2 (W=1, XLA path on the
    CPU): float32 compute, dropout 0, same init and batches, 3 steps with 2
    accumulated microbatches."""
    lr, steps = 3e-3, 3
    common = dict(lion=True, async_grad=True, learning_rate=lr, weight_decay=0.0,
                  lr_scheduler_type="constant", max_steps=steps,
                  per_device_train_batch_size=2, gradient_accumulation_steps=2,
                  block_size=32, logging_steps=1, eval_steps=1000, seed=0)
    # no remat on the reference side: the same numbers, less to compile
    jtr = JTrainer.for_gpt2(JTrainConfig(**common), make_mesh(data=1, devices=jax.devices()[:1]),
                            JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0, remat=False))
    init = jax.tree.map(np.asarray, jtr.params)
    blocks = j_synthetic(256, 32, 256)
    jhist = jtr.train(j_batch_iterator(blocks, jtr.global_train_batch(), seed=0))
    jtr.close()

    ttr = Trainer.for_gpt2(TrainConfig(**common),
                           GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.0),
                           device="cpu", initial_params=params_from_jax(init))
    np.testing.assert_array_equal(synthetic_lm_dataset(256, 32, 256), blocks)
    thist = ttr.train(batch_iterator(blocks, ttr.global_train_batch(), seed=0))
    ttr.close()

    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist],
                               atol=1e-5, rtol=0)
    got = np.concatenate([v.reshape(-1) for v in jax.tree.leaves(params_to_jax(ttr.model))])
    want = np.concatenate([np.asarray(v).reshape(-1) for v in jax.tree.leaves(jtr.params)])
    assert np.mean(got == want) >= 0.999
    assert np.max(np.abs(got - want)) <= 2 * lr * steps * (1 + 1e-6)


def test_run_clm_writes_a_model_the_jax_package_reproduces(tmp_path, monkeypatch):
    """``DLION_PLATFORM=cpu`` run of the port's CLI (default dropout 0.1,
    remat on) writes ``model.npz``; the JAX package's ``load_pytree`` and
    ``gpt2_apply`` give the port's logits from it."""
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    trainer = run_clm.main([
        "--model_name", "tiny", "--compute_dtype", "float32", "--dataset", "synthetic",
        "--synthetic_blocks", "64", "--block_size", "32", "--per_device_train_batch_size", "2",
        "--gradient_accumulation_steps", "2", "--max_steps", "2", "--logging_steps", "1",
        "--learning_rate", "3e-3", "--warmup_steps", "1", "--output_dir", str(tmp_path)])
    assert (tmp_path / "metrics.jsonl").exists()
    assert all(np.isfinite(h["loss"]) for h in trainer.history if "loss" in h)
    tokens = np.random.default_rng(1).integers(0, 256, size=(2, 32)).astype(np.int32)
    jparams = j_load_pytree(tmp_path / "model.npz")
    want = jax.jit(lambda p: j_apply(p, jnp.asarray(tokens),
                                     JConfig.tiny(compute_dtype=jnp.float32)))(jparams)
    trainer.model.eval()
    with torch.no_grad():
        got = trainer.model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unported_options_refused():
    with pytest.raises(SystemExit):  # not a flag of the port: argparse refuses it
        run_clm.main(["--row_block", "256"])
    with pytest.raises(ValueError, match="unrecognized checkpoint format"):  # HF import runs
        run_clm.load_pretrained(run_clm.ModelArguments(model_family="llama", model_path="x"),
                                "cpu")
    with pytest.raises(NotImplementedError, match="Queue 2 item 4"):  # float32 flash on the card
        resolve_impl("flash", "cuda", 1024, 64, torch.float32)
    with pytest.raises(ValueError, match="--async_grad without --lion"):  # AdamW is ported
        Trainer.for_gpt2(TrainConfig(lion=False, async_grad=True), GPT2Config.tiny(),
                         device="cpu")
