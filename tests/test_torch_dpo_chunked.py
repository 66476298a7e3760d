"""DPO's chunked-vocabulary scoring (``train.dpo.sequence_logprob_chunked``,
``run_dpo --vocab_chunks``) vs the JAX package's and vs the dense scoring,
on the CPU.

Tolerances, set before the first run (the JAX package's
tests/test_dpo_chunked.py): ``sequence_logprob_chunked`` within 1e-5 of
JAX's on the same hidden states and head, its grads within rtol 1e-4 /
atol 1e-5; at ``LlamaConfig.tiny`` with float32 compute the chunked DPO
loss within 1e-5 of the dense one and every adapter grad within rtol 1e-4
/ atol 1e-5; ``run_dpo --vocab_chunks 4`` against ``run_dpo`` dense, from
one seed: the first loss within 1e-5 (bfloat16 compute; both sum the same
float32 products) and the next within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.train import dpo as j_train_dpo
from distributed_lion_tpu_torch.cli import run_dpo
from distributed_lion_tpu_torch.data import dpo
from distributed_lion_tpu_torch.data.sft import synthetic_qa_pairs
from distributed_lion_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_lion_tpu_torch.models.llama import Llama, LlamaConfig, llama_init
from distributed_lion_tpu_torch.models.lora import DPO_TARGET_PATTERNS, LoraConfig, lora_init
from distributed_lion_tpu_torch.train.dpo import (
    make_dpo_loss_fn,
    sequence_logprob,
    sequence_logprob_chunked,
)

torch.set_num_threads(2)


def test_sequence_logprob_chunked_matches_jax_and_dense():
    rng = np.random.default_rng(0)
    B, T, D, V = 2, 10, 8, 37
    hidden = rng.normal(size=(B, T, D)).astype(np.float32)
    head = rng.normal(size=(D, V)).astype(np.float32)
    tokens = rng.integers(0, V, size=(B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.4).astype(np.float32)

    def jf(h, e):
        return j_train_dpo.sequence_logprob_chunked(h, e, jnp.asarray(tokens), jnp.asarray(mask),
                                                    n_chunks=4, emb_layout="dv")

    want, vjp = jax.vjp(jf, jnp.asarray(hidden), jnp.asarray(head))
    cot = rng.normal(size=B).astype(np.float32)
    jgh, jge = vjp(jnp.asarray(cot))
    outs = []
    for chunked in (True, False):
        h = torch.tensor(hidden, requires_grad=True)
        e = torch.tensor(head, requires_grad=True)
        got = (sequence_logprob_chunked(h, e, torch.from_numpy(tokens), torch.from_numpy(mask), 4)
               if chunked else sequence_logprob(h @ e, torch.from_numpy(tokens),
                                                torch.from_numpy(mask)))
        (got * torch.from_numpy(cot)).sum().backward()
        outs.append((got.detach().numpy(), h.grad.numpy(), e.grad.numpy()))
    for got, gh, ge in outs:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gh, np.asarray(jgh), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ge, np.asarray(jge), rtol=1e-4, atol=1e-5)


def _batch(n=4, T=64):
    return dpo.prepare_dpo_batch(synthetic_qa_pairs(n, seed=6), ByteTokenizer(), max_length=T,
                                 max_prompt_length=48)


def test_dpo_loss_and_adapter_grads_chunked_match_dense():
    cfg = LlamaConfig.tiny(vocab_size=259, compute_dtype=torch.float32)
    base = llama_init(cfg, seed=0, device="cpu")
    lcfg = LoraConfig(r=4, alpha=8, target_patterns=DPO_TARGET_PATTERNS)
    rng = np.random.default_rng(4)
    adapters = {p: {"A": torch.nn.Parameter(ab["A"]),
                    "B": torch.nn.Parameter(torch.from_numpy(
                        rng.normal(size=tuple(ab["B"].shape)).astype(np.float32) * 0.05))}
                for p, ab in lora_init(base, lcfg, seed=1).items()}
    model = Llama(cfg, base)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    results = []
    for vc in (0, 4):
        loss_fn = run_dpo.dpo_loss_fn(model, base, base, adapters, lcfg, 0.1, vocab_chunks=vc)
        assert getattr(loss_fn, "_vocab_chunked", False) == (vc > 0)
        loss, m = loss_fn(batch, None)
        grads = torch.autograd.grad(loss, [t for ab in adapters.values() for t in ab.values()])
        results.append((loss.detach(), m, grads))
    (ld, md, gd), (lc, mc, gc) = results
    np.testing.assert_allclose(float(lc), float(ld), rtol=1e-5, atol=1e-5)
    for k in md:
        np.testing.assert_allclose(float(mc[k]), float(md[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(md["reward_margin"]) != 0.0
    for a, b in zip(gd, gc):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(TypeError, match=r"\(hidden, head\)"):
        make_dpo_loss_fn(lambda t, s: model(t), lambda t: model(t), vocab_chunks=4)(batch, None)


def test_run_dpo_cli_vocab_chunks_smoke(monkeypatch):
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    argv = ["--model_name", "tiny", "--max_length", "96", "--max_prompt_length", "48",
            "--num_train_samples", "32", "--size_valid_set", "8", "--quant_ref", "nf4",
            "--per_device_train_batch_size", "1", "--gradient_accumulation_steps", "2",
            "--per_device_eval_batch_size", "2", "--eval_iters", "1", "--eval_steps", "2",
            "--max_steps", "2",
            "--logging_steps", "1", "--learning_rate", "3e-3", "--warmup_steps", "1"]
    runs = [run_dpo.main(argv + ["--vocab_chunks", str(vc)])[0] for vc in (0, 4)]
    dense, chunked = ([h["loss"] for h in t.history if "loss" in h] for t in runs)
    assert len(chunked) == 2 and np.isfinite(chunked).all()
    np.testing.assert_allclose(chunked[0], dense[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(chunked, dense, atol=2e-2, rtol=0)
    evals = [h for h in runs[1].history if "eval/loss" in h]
    assert evals and set(evals[-1]) == {"step", "eval/loss", "eval/reward_accuracy",
                                        "eval/reward_margin"}
