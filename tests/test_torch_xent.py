"""The chunked-vocabulary cross entropy (``ops/xent.py``) vs the dense
``log_softmax`` path and vs the JAX package's ``chunked_softmax_xent``, on
the CPU; and ``--vocab_chunks`` in ``Trainer.for_gpt2`` and ``run_sft``.

Tolerances, set before the first run. float32: nll within rtol/atol 1e-5 of
JAX's and of the dense path's, the grads of hidden and head within rtol
1e-4 / atol 1e-5 (sums in other orders), ``correct`` bit-identical. At
bfloat16 hidden and head, against JAX's chunked path on XLA:CPU: nll
within rtol 1e-5 (both sum the exact float32 products of bfloat16 values),
and each grad within 2⁻⁷ of its largest element: the port rounds the
logits' cotangent to bfloat16 before the two products, as
``ops.products.matmul_f32`` does and the TPU's DEFAULT precision does,
where XLA:CPU keeps it float32 (one bfloat16 rounding, 2⁻⁸ relative, of a
sum of products of one sign pattern). The GPT-2 trainer with ``vocab_chunks
4`` against the dense one: per-step losses within 1e-4 (the JAX package's
``test_trainer_vocab_chunks_matches_dense``) and every param within the
ballot-flip envelope 2·lr·steps; ``run_sft`` at the tiny Llama: the first
loss within 1e-4 and the later ones within 2e-2 (bfloat16 compute, where
an election near zero may go the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.ops import xent as j_xent
from distributed_lion_tpu_torch.cli import run_sft
from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.models.loss import clm_loss_and_metrics
from distributed_lion_tpu_torch.ops.xent import (
    chunked_clm_loss_and_metrics,
    chunked_softmax_xent,
    masked_local_nll,
)
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer

torch.set_num_threads(2)

N, D = 17, 16
# (n_chunks, V, layout, valid_v): a tail chunk overlapping the one before
# (259 = 4·65 − 1), an exact split, padding columns, more chunks than
# columns need (all-masked chunks), one chunk
CASES = [(4, 259, "vd", 0), (4, 259, "dv", 0), (4, 256, "vd", 0), (4, 256, "dv", 0),
         (3, 101, "dv", 90), (5, 259, "vd", 250), (7, 10, "vd", 0), (16, 17, "dv", 0),
         (1, 101, "vd", 0)]


def _inputs(v, layout, valid, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    e = (rng.normal(size=(v, D) if layout == "vd" else (D, v)) * 0.5).astype(np.float32)
    lab = rng.integers(0, valid or v, N).astype(np.int32)
    w = rng.normal(size=N).astype(np.float32)  # a weighted sum, so each row's grad differs
    return h, e, lab, w


def _port(h, e, lab, w, nc, layout, valid, dtype=torch.float32):
    th = torch.tensor(h, dtype=dtype, requires_grad=True)
    te = torch.tensor(e, dtype=dtype, requires_grad=True)
    nll, correct = chunked_softmax_xent(th, te, torch.from_numpy(lab), nc, layout, valid)
    (nll * torch.from_numpy(w)).sum().backward()
    return nll.detach(), correct, th.grad.float().numpy(), te.grad.float().numpy()


@pytest.mark.parametrize("nc,v,layout,valid", CASES)
def test_chunked_matches_dense(nc, v, layout, valid):
    h, e, lab, w = _inputs(v, layout, valid)
    nll, correct, gh, ge = _port(h, e, lab, w, nc, layout, valid)
    th, te = torch.tensor(h, requires_grad=True), torch.tensor(e, requires_grad=True)
    logits = th @ (te.t() if layout == "vd" else te)
    if valid:
        logits = logits[:, :valid]
    logp = torch.log_softmax(logits, -1)
    ref = -logp[torch.arange(N), torch.from_numpy(lab).long()]
    (ref * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(nll.numpy(), ref.detach().numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(correct, logits.argmax(-1) == torch.from_numpy(lab).long())
    np.testing.assert_allclose(gh, th.grad.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ge, te.grad.numpy(), rtol=1e-4, atol=1e-5)
    if valid:  # the padding columns take no gradient
        pad = ge[valid:] if layout == "vd" else ge[:, valid:]
        assert not pad.any()


def _jax(h, e, lab, w, nc, layout, valid, dtype=jnp.float32):
    def f(hh, ee):
        nll, correct = j_xent.chunked_softmax_xent(hh, ee, jnp.asarray(lab), nc, layout, valid)
        return (nll * jnp.asarray(w)).sum(), (nll, correct)

    (_, (nll, correct)), (gh, ge) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h, dtype), jnp.asarray(e, dtype))
    return (np.asarray(nll), np.asarray(correct), np.asarray(gh, np.float32),
            np.asarray(ge, np.float32))


@pytest.mark.parametrize("nc,v,layout,valid", CASES)
def test_chunked_matches_jax(nc, v, layout, valid):
    h, e, lab, w = _inputs(v, layout, valid, seed=1)
    nll, correct, gh, ge = _port(h, e, lab, w, nc, layout, valid)
    jnll, jcorrect, jgh, jge = _jax(h, e, lab, w, nc, layout, valid)
    np.testing.assert_allclose(nll.numpy(), jnll, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(correct.numpy(), jcorrect)
    np.testing.assert_allclose(gh, jgh, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ge, jge, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["vd", "dv"])
def test_chunked_matches_jax_at_bfloat16(layout):
    h, e, lab, w = _inputs(259, layout, 0, seed=2)
    # inputs exact in bfloat16 on both sides
    h = torch.tensor(h).bfloat16().float().numpy()
    e = torch.tensor(e).bfloat16().float().numpy()
    nll, correct, gh, ge = _port(h, e, lab, w, 4, layout, 0, torch.bfloat16)
    jnll, jcorrect, jgh, jge = _jax(h, e, lab, w, 4, layout, 0, jnp.bfloat16)
    np.testing.assert_allclose(nll.numpy(), jnll, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(correct.numpy(), jcorrect)
    for got, want in ((gh, jgh), (ge, jge)):
        assert np.abs(got - want).max() <= 2**-7 * np.abs(want).max()


def test_forward_saves_no_chunk_logits():
    """Under autograd the chunked forward keeps its inputs and the [N]
    logsumexp, no [N, vc] chunk; the dense path keeps an [N, V] tensor."""
    v, nc = 259, 4
    h, e, lab, _ = _inputs(v, "dv", 0)
    th, te = torch.tensor(h, requires_grad=True), torch.tensor(e, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        nll, _ = chunked_softmax_xent(th, te, torch.from_numpy(lab), nc, "dv")
    assert sorted(map(tuple, saved)) == sorted([(N, D), (D, v), (N,), (N,)])
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        torch.log_softmax(th @ te, -1)
    assert (N, v) in map(tuple, saved)


def test_clm_loss_and_masked_nll_match_jax():
    rng = np.random.default_rng(3)
    b, t, v = 2, 9, 37
    hidden = rng.normal(size=(b, t, D)).astype(np.float32)
    head = rng.normal(size=(D, v)).astype(np.float32)
    tokens = rng.integers(0, v, (b, t)).astype(np.int32)
    mask = (rng.random((b, t)) > 0.3).astype(np.float32)
    loss, m = chunked_clm_loss_and_metrics(torch.from_numpy(hidden), torch.from_numpy(head),
                                           torch.from_numpy(tokens), 4,
                                           torch.from_numpy(mask), emb_layout="dv")
    jloss, jm = j_xent.chunked_clm_loss_and_metrics(jnp.asarray(hidden), jnp.asarray(head),
                                                    jnp.asarray(tokens), 4, jnp.asarray(mask),
                                                    emb_layout="dv")
    dense, dm = clm_loss_and_metrics(torch.from_numpy(hidden) @ torch.from_numpy(head),
                                     torch.from_numpy(tokens), torch.from_numpy(mask))
    assert set(m) == set(jm) == set(dm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(m[k]), float(dm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    labels = rng.integers(0, v, (b, t)).astype(np.int32)
    for nc in (0, 3):
        got = masked_local_nll(torch.from_numpy(hidden), torch.from_numpy(head),
                               torch.from_numpy(labels), torch.from_numpy(mask), nc, "dv")
        want = j_xent.masked_local_nll(jnp.asarray(hidden), jnp.asarray(head),
                                       jnp.asarray(labels), jnp.asarray(mask), nc, "dv")
        np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want],
                                   rtol=1e-5, atol=1e-5)


def _gpt2_run(vocab_chunks, lr=1e-3, steps=5):
    cfg = TrainConfig(lion=True, async_grad=True, learning_rate=lr, warmup_steps=1,
                      max_steps=steps, per_device_train_batch_size=2,
                      gradient_accumulation_steps=1, block_size=32, logging_steps=1,
                      vocab_chunks=vocab_chunks, seed=3)
    t = Trainer.for_gpt2(cfg, GPT2Config.tiny(compute_dtype=torch.float32, vocab_pad_multiple=64),
                         device="cpu")
    blocks = synthetic_lm_dataset(64, 32, 256, seed=7)
    hist = t.train(batch_iterator(blocks, t.global_train_batch(), seed=0))
    t.close()
    return [h["loss"] for h in hist if "loss" in h], t.flat.params.clone()


def test_trainer_vocab_chunks_matches_dense():
    """5 steps of the tiny GPT-2 (its head padded to 320 rows, masked by
    ``valid_v``) with ``vocab_chunks`` 4 against the dense loss."""
    lr, steps = 1e-3, 5
    losses_d, params_d = _gpt2_run(0, lr, steps)
    losses_c, params_c = _gpt2_run(4, lr, steps)
    np.testing.assert_allclose(losses_c, losses_d, rtol=1e-4, atol=1e-4)
    assert (params_c - params_d).abs().max() <= 2 * lr * steps + 1e-6


def test_trainer_refuses_vocab_chunks_for_a_loss_that_ignores_it():
    p = torch.nn.Parameter(torch.zeros(4))
    with pytest.raises(NotImplementedError, match="--vocab_chunks is not wired"):
        Trainer(TrainConfig(vocab_chunks=4), [("p", p)], lambda batch, seed: (p.sum(), {}))


def test_run_sft_vocab_chunks_matches_dense(monkeypatch):
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    argv = ["--model_name", "tiny", "--quant", "nf4", "--seq_length", "64",
            "--num_train_samples", "32", "--size_valid_set", "8",
            "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "1",
            "--max_steps", "3", "--logging_steps", "1", "--warmup_steps", "1",
            "--learning_rate", "3e-3", "--per_device_eval_batch_size", "2", "--eval_iters", "1"]
    runs = [run_sft.main(argv + ["--vocab_chunks", str(vc)])[0] for vc in (0, 4)]
    dense, chunked = ([h["loss"] for h in t.history if "loss" in h] for t in runs)
    assert len(dense) == len(chunked) == 3
    np.testing.assert_allclose(chunked[0], dense[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(chunked, dense, atol=2e-2, rtol=2e-2)
    evals = [[h["eval/loss"] for h in t.history if "eval/loss" in h] for t in runs]
    np.testing.assert_allclose(evals[1], evals[0], atol=2e-2, rtol=0)
