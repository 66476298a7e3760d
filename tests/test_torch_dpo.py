"""The port's DPO workload vs the JAX package's, on the CPU: the data, the
logprobs and the loss, the DPO adapter targets, and the ``run_dpo`` CLI.

Tolerances, set before the first run: the data arrays and the shuffle
order exact (the same numpy code); ``sequence_logprob`` within rtol 1e-6
(float32 sums in other orders); at ``LlamaConfig.tiny`` with float32
compute and JAX's weights and adapters carried across
(``utils.serialization``), the policy logits within atol 1e-5 and the DPO
loss and its metrics within 1e-5, with the reference dense and NF4
(block 32). ``run_dpo`` on both packages from one ``--sft_checkpoint``
(the JAX package's init), JAX's adapters carried into the port, ``--lora_dropout
0``, 3 steps at W = 1 and W = 2 (two gloo ranks against a ``data=2``
mesh): per-step losses within 1e-5. Three patches make the two CLIs'
runs the same computation: the JAX CLI's mesh is cut to the port's world
(it takes every CPU device otherwise) through its ``build_mesh``; the
port's ``lora_init`` returns JAX's adapters, as the two frameworks'
generators differ; and both packages' ``LlamaConfig.tiny`` computes in
float32, as the trainer comparison of tests/test_torch_sft.py does (at
bfloat16, step 1's losses are equal and B's grads differ in their last
bits, so a few elections and step 2's loss differ, by 4e-4 in a first
run).

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

from distributed_lion_tpu.data import dpo as j_dpo
from distributed_lion_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from distributed_lion_tpu.models import lora as j_lora
from distributed_lion_tpu.models.llama import LlamaConfig as JConfig
from distributed_lion_tpu.models.llama import llama_apply as j_apply
from distributed_lion_tpu.models.llama import llama_init as j_init
from distributed_lion_tpu.ops.quant import quantize_tree as j_quantize_tree
from distributed_lion_tpu.train import dpo as j_train_dpo
from distributed_lion_tpu.utils.serialization import load_pytree as j_load_pytree
from distributed_lion_tpu.utils.serialization import save_pytree as j_save_pytree
from distributed_lion_tpu_torch.cli import run_dpo, run_sft
from distributed_lion_tpu_torch.data import dpo
from distributed_lion_tpu_torch.data.sft import synthetic_qa_pairs
from distributed_lion_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_lion_tpu_torch.models.llama import Llama, LlamaConfig
from distributed_lion_tpu_torch.models.lora import (
    DPO_TARGET_PATTERNS,
    LoraConfig,
    adapter_named_parameters,
    apply_adapters,
    iter_paths,
    lora_apply_fn,
    lora_init,
)
from distributed_lion_tpu_torch.ops.quant import quantize_tree
from distributed_lion_tpu_torch.parallel.mesh import SeqAxis
from distributed_lion_tpu_torch.train.dpo import make_dpo_loss_fn, sequence_logprob
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.utils.serialization import (
    adapters_from_jax,
    llama_params_from_jax,
    load_pytree,
)

torch.set_num_threads(2)

T = 64        # the carried-weights comparisons' row length
CLI_STEPS = 3
CLI_ARGS = ["--model_name", "tiny", "--max_length", "96", "--max_prompt_length", "48",
            "--num_train_samples", "32", "--size_valid_set", "0", "--lora_dropout", "0",
            "--lion", "--async_grad", "--max_steps", str(CLI_STEPS), "--logging_steps", "1",
            "--lr_scheduler_type", "constant", "--learning_rate", "3e-3", "--weight_decay", "0",
            "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "2",
            "--seed", "3"]


def _records():
    recs = synthetic_qa_pairs(40, seed=2)
    recs.append({"question": "x" * 600, "response_j": "a", "response_k": "b"})  # prompt too long
    recs.append({"question": "q", "response_j": "y" * 200, "response_k": "b"})  # chosen too long
    return recs


def test_dpo_batches_equal_jax():
    recs = _records()
    assert dpo.return_prompt_and_responses(recs[0]) == j_dpo.return_prompt_and_responses(recs[0])
    # the second setting drops the 40-byte prompts and the longest pairs
    for kw in (dict(max_length=128, max_prompt_length=64), dict(max_length=58,
                                                                max_prompt_length=39)):
        got = dpo.prepare_dpo_batch(recs, ByteTokenizer(), **kw)
        want = j_dpo.prepare_dpo_batch(recs, JByteTokenizer(), **kw)
        assert got.keys() == want.keys() and 0 < len(got["chosen"]) <= 40
        assert len(got["chosen"]) < 40 or kw["max_length"] == 128
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    many = synthetic_qa_pairs(1003)
    assert len(dpo.prepare_dpo_batch(many, ByteTokenizer(), sanity_check=True)["chosen"]) == 1000
    it, jit_ = dpo.dpo_batch_iterator(got, 6, seed=5), j_dpo.dpo_batch_iterator(want, 6, seed=5)
    for _ in range(3 * len(got["chosen"]) // 6):  # into the third epoch
        a, b = next(it), next(jit_)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="survived"):
        dpo.prepare_dpo_batch(recs[-2:], ByteTokenizer(), max_length=32, max_prompt_length=16)


def test_sequence_logprob_equals_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 17, 11)).astype(np.float32) * 3
    tokens = rng.integers(0, 11, size=(3, 17)).astype(np.int32)
    mask = rng.random((3, 17)) < 0.7
    got = sequence_logprob(torch.from_numpy(logits), torch.from_numpy(tokens),
                           torch.from_numpy(mask))
    want = j_train_dpo.sequence_logprob(jnp.asarray(logits), jnp.asarray(tokens),
                                        jnp.asarray(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # uniform logits: -ln 4 per masked label (the JAX package's hand check)
    hand = sequence_logprob(torch.zeros(1, 3, 4), torch.tensor([[0, 1, 2]]),
                            torch.tensor([[False, True, True]]))
    np.testing.assert_allclose(float(hand[0]), -2 * np.log(4), rtol=1e-6)


def test_dpo_loss_is_ln2_at_the_reference_and_falls_as_the_policy_prefers_chosen():
    def apply_const(delta):
        def f(tokens):
            base = torch.zeros(tokens.shape[0], tokens.shape[1], 4)
            base[:, :, 1] += delta  # favours token 1, the chosen side's
            return base
        return f

    batch = {"chosen": torch.tensor([[0, 1, 1]]), "rejected": torch.tensor([[0, 2, 2]]),
             "chosen_mask": torch.ones(1, 3, dtype=torch.bool),
             "rejected_mask": torch.ones(1, 3, dtype=torch.bool)}
    ref = apply_const(0.0)
    loss0, m0 = make_dpo_loss_fn(lambda t, s: ref(t), ref)(batch, None)
    np.testing.assert_allclose(float(loss0), np.log(2), rtol=1e-6)
    assert float(m0["reward_margin"]) == 0.0 and float(m0["reward_accuracy"]) == 0.0
    pol = apply_const(1.0)
    loss1, m1 = make_dpo_loss_fn(lambda t, s: pol(t), ref)(batch, 7)
    assert float(loss1) < float(loss0)
    assert float(m1["reward_margin"]) > 0 and float(m1["reward_accuracy"]) == 1.0
    with pytest.raises(TypeError, match=r"\(hidden, head\)"):  # chunked scoring takes hidden states
        make_dpo_loss_fn(lambda t, s: pol(t), ref, vocab_chunks=4)(batch, None)
    # a seq axis of one is the unsplit loss (the seq-parallel logprobs run in
    # tests/test_torch_seq_parallel.py's ranks)
    loss2, _ = make_dpo_loss_fn(lambda t, s: pol(t), ref, seq_axis=SeqAxis())(batch, 7)
    assert float(loss2) == float(loss1)


def _tiny(quant_ref="none", b_scale=0.0):
    """JAX's tiny Llama (float32 compute, vocabulary 259), its reference
    (dense or NF4 at block 32) and DPO adapters with B drawn at ``b_scale``;
    the port's counterparts carried over."""
    jcfg = JConfig.tiny(vocab_size=259, compute_dtype=jnp.float32)
    jbase = j_init(jax.random.key(0), jcfg)
    jref = jbase if quant_ref == "none" else j_quantize_tree(jbase, quant_ref, block=32)
    jlcfg = j_lora.LoraConfig(r=4, alpha=8, target_patterns=j_lora.DPO_TARGET_PATTERNS)
    jad = jax.tree.map(np.asarray, j_lora.lora_init(jax.random.key(1), jbase, jlcfg))
    rng = np.random.default_rng(4)
    jad = {p: {"A": ab["A"], "B": (rng.normal(size=ab["B"].shape) * b_scale).astype(np.float32)}
           for p, ab in jad.items()}
    cfg = LlamaConfig.tiny(vocab_size=259, compute_dtype=torch.float32)
    base = llama_params_from_jax(jax.tree.map(np.asarray, jbase))
    ref = base if quant_ref == "none" else llama_params_from_jax(jax.tree.map(np.asarray, jref))
    return (jcfg, jbase, jref, jlcfg, jad), (cfg, base, ref, adapters_from_jax(jad))


@pytest.mark.parametrize("quant", ["none", "nf4"])
def test_dpo_adapter_targets_equal_jax_and_carried_logits_agree(quant):
    jcfg = JConfig.tiny(vocab_size=259)
    jbase = j_init(jax.random.key(0), jcfg)
    if quant != "none":
        jbase = j_quantize_tree(jbase, quant, block=32)
    jlcfg = j_lora.LoraConfig(r=4, alpha=8, target_patterns=j_lora.DPO_TARGET_PATTERNS)
    want = {p: {k: v.shape for k, v in ab.items()}
            for p, ab in j_lora.lora_init(jax.random.key(1), jbase, jlcfg).items()}
    base = llama_params_from_jax(jax.tree.map(np.asarray, jbase))
    assert DPO_TARGET_PATTERNS == j_lora.DPO_TARGET_PATTERNS
    got = {p: {k: tuple(v.shape) for k, v in ab.items()}
           for p, ab in lora_init(base, LoraConfig(r=4, alpha=8,
                                                   target_patterns=DPO_TARGET_PATTERNS)).items()}
    assert got == want
    leaves = {p.split("/")[-1] for p in got}
    assert leaves == {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "wte"}
    assert "lm_head" not in leaves and len(got) == 7 * jcfg.n_layer + 1
    if quant != "none":
        return
    (jcfg, jbase, _, jlcfg, jad), (cfg, base, _, ad) = _tiny(b_scale=0.05)
    tokens = np.random.default_rng(5).integers(0, 259, size=(2, T)).astype(np.int32)
    jpol = j_lora.lora_apply_fn(lambda p, t: j_apply(p, t, jcfg), jbase, jlcfg)
    model = Llama(cfg, base)
    pol = lora_apply_fn(lambda p, t: model(t, p), base, LoraConfig(
        r=4, alpha=8, target_patterns=DPO_TARGET_PATTERNS))
    with torch.no_grad():
        got_logits = pol(ad, torch.from_numpy(tokens)).numpy()
    want_logits = np.asarray(jax.jit(jpol)(jax.tree.map(jnp.asarray, jad), jnp.asarray(tokens)))
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-5, rtol=0)


def _dpo_batch(n=4):
    return dpo.prepare_dpo_batch(synthetic_qa_pairs(n, seed=6), ByteTokenizer(), max_length=T,
                                 max_prompt_length=48)


@pytest.mark.parametrize("quant_ref", ["none", "nf4"])
def test_dpo_loss_on_tiny_llama_matches_jax(quant_ref):
    (jcfg, jbase, jref, jlcfg, jad), (cfg, base, ref, ad) = _tiny(quant_ref, b_scale=0.05)
    batch = _dpo_batch()
    jpol = j_lora.lora_apply_fn(lambda p, t: j_apply(p, t, jcfg), jbase, jlcfg)
    jloss_fn = j_train_dpo.make_dpo_loss_fn(jpol, lambda t: j_apply(jref, t, jcfg), beta=0.1)
    jloss, jm = jax.jit(lambda p, b: jloss_fn(p, b, None))(jax.tree.map(jnp.asarray, jad),
                                                            jax.tree.map(jnp.asarray, batch))
    model = Llama(cfg, base)
    lcfg = LoraConfig(r=4, alpha=8, target_patterns=DPO_TARGET_PATTERNS)
    loss_fn = run_dpo.dpo_loss_fn(model, base, ref, ad, lcfg, 0.1)
    with torch.no_grad():
        loss, m = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, None)
    assert set(m) == set(jm) == {"loss", "reward_accuracy", "reward_margin"}
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=0)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-5, rtol=0, err_msg=k)
    assert float(m["reward_margin"]) != 0.0


def test_evaluate_takes_dpo_batches_and_writes_no_perplexity():
    _, (cfg, base, ref, ad) = _tiny(b_scale=0.05)
    params = {p: {k: torch.nn.Parameter(t) for k, t in ab.items()} for p, ab in ad.items()}
    model = Llama(cfg, base)
    lcfg = LoraConfig(r=4, alpha=8, target_patterns=DPO_TARGET_PATTERNS)
    trainer = Trainer(TrainConfig(max_steps=1, per_device_eval_batch_size=2, eval_iters=2),
                      adapter_named_parameters(params),
                      run_dpo.dpo_loss_fn(model, base, ref, params, lcfg, 0.1), model=model)
    batch = _dpo_batch()
    out = trainer.evaluate(batch)
    trainer.close()
    assert set(out) == {"eval/loss", "eval/reward_accuracy", "eval/reward_margin"}
    with torch.no_grad():
        want = [run_dpo.dpo_loss_fn(model, base, ref, params, lcfg, 0.1)(
            {k: torch.from_numpy(v[i:i + 2]) for k, v in batch.items()}, None)[0].item()
            for i in (0, 2)]
    assert out["eval/loss"] == pytest.approx(float(np.mean(want)), abs=1e-7)


def _jax_cli_losses(monkeypatch, world, sft):
    """``distributed_lion_tpu.cli.run_dpo.main`` on a ``data=world`` mesh:
    the per-step losses and the adapters it started from."""
    from distributed_lion_tpu.cli import run_clm as j_run_clm
    from distributed_lion_tpu.cli import run_dpo as j_run_dpo
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.train.loop import Trainer as JTrainer

    monkeypatch.setattr(j_run_clm, "build_mesh", lambda *a, **k: make_mesh(
        data=world, devices=jax.devices()[:world]))
    hist, init = [], {}
    orig_train, orig_init = JTrainer.train, JTrainer.__init__

    def train(self, *a, **k):
        h = orig_train(self, *a, **k)
        hist.extend(h)
        return h

    def init_(self, cfg, mesh, apply_fn, params, **k):
        init.update(jax.tree.map(np.asarray, params))
        orig_init(self, cfg, mesh, apply_fn, params, **k)

    monkeypatch.setattr(JTrainer, "train", train)
    monkeypatch.setattr(JTrainer, "__init__", init_)
    tiny = JConfig.tiny
    monkeypatch.setattr(JConfig, "tiny", staticmethod(
        lambda **kw: tiny(**({"compute_dtype": jnp.float32} | kw))))
    j_run_dpo.main(CLI_ARGS + ["--sft_checkpoint", str(sft)])
    return [h["loss"] for h in hist if "loss" in h], init


def _port_cli(adapters_npz, argv):
    """The port's ``run_dpo.main`` with its ``lora_init`` returning the
    adapters saved in ``adapters_npz`` (JAX's) and ``LlamaConfig.tiny`` at
    float32 compute."""
    with np.load(adapters_npz) as f:
        saved = {key: f[key] for key in f.files}
    run_dpo.lora_init = lambda base, cfg, seed=0: {
        p: {k: torch.from_numpy(saved[f"{p}:{k}"]) for k in ("A", "B")}
        for p in {key.rsplit(":", 1)[0] for key in saved}}
    tiny = LlamaConfig.tiny
    LlamaConfig.tiny = staticmethod(lambda **kw: tiny(**({"compute_dtype": torch.float32} | kw)))
    try:
        trainer, *_ = run_dpo.main(argv)
    finally:
        LlamaConfig.tiny = tiny
    return [h["loss"] for h in trainer.history if "loss" in h]


def _w2_rank(rank, pg, adapters_npz, argv, out):
    dist.init_process_group("gloo", init_method=f"file://{pg}", rank=rank, world_size=2)
    torch.set_num_threads(1)
    try:
        losses = _port_cli(adapters_npz, argv)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(losses, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [1, 2])
def test_run_dpo_cli_losses_match_jax(world, tmp_path, monkeypatch):
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    sft = tmp_path / "sft.npz"
    j_save_pytree(sft, jax.tree.map(np.asarray, j_init(jax.random.key(9), JConfig.tiny(
        vocab_size=259))))
    want, init = _jax_cli_losses(monkeypatch, world, sft)
    adapters_npz = tmp_path / "adapters.npz"
    np.savez(adapters_npz, **{f"{p}:{k}": v for p, ab in init.items() for k, v in ab.items()})
    argv = CLI_ARGS + ["--sft_checkpoint", str(sft)]
    if world == 1:
        monkeypatch.setattr(run_dpo, "lora_init", run_dpo.lora_init)  # restored after the test
        monkeypatch.setattr(LlamaConfig, "tiny", LlamaConfig.tiny)
        got = _port_cli(adapters_npz, argv)
    else:
        out = tmp_path / "losses.json"
        mp.spawn(_w2_rank, args=(str(tmp_path / "pg"), str(adapters_npz), argv, str(out)),
                 nprocs=2, join=True)
        got = json.loads(out.read_text())
    assert len(got) == len(want) == CLI_STEPS
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_sft_merged_output_feeds_run_dpo_and_dpo_merged_output_round_trips(tmp_path,
                                                                          monkeypatch):
    """``run_sft --merged_output x.npz`` → ``run_dpo --sft_checkpoint x.npz``:
    the policy's base is the merged SFT model; DPO's own ``--merged_output``
    holds the policy with its adapters merged, which the JAX package's
    ``load_pytree`` and ``llama_apply`` turn into the port's logits."""
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    sft = tmp_path / "sft.npz"
    run_sft.main(["--model_name", "tiny", "--quant", "nf4", "--seq_length", "48",
                  "--num_train_samples", "32", "--size_valid_set", "8",
                  "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "1",
                  "--max_steps", "2", "--logging_steps", "1", "--warmup_steps", "1",
                  "--merged_output", str(sft)])
    merged = tmp_path / "dpo.npz"
    trainer, model, adapters, ref = run_dpo.main([
        "--model_name", "tiny", "--max_length", "96", "--max_prompt_length", "48",
        "--num_train_samples", "40", "--size_valid_set", "8", "--quant_ref", "nf4",
        "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "1",
        "--per_device_eval_batch_size", "2", "--eval_iters", "1", "--eval_steps", "2",
        "--max_steps", "2", "--logging_steps", "1", "--warmup_steps", "1",
        "--sft_checkpoint", str(sft), "--merged_output", str(merged)])
    rows = [h for h in trainer.history if "loss" in h]
    assert len(rows) == 2 and np.isfinite([h["loss"] for h in rows]).all()
    evals = [h for h in trainer.history if "eval/loss" in h]
    assert evals and all("eval/perplexity" not in h for h in evals)
    loaded = dict(iter_paths(load_pytree(sft)))
    for path, t in iter_paths(model.params):
        np.testing.assert_array_equal(t.numpy(), loaded[path])
    assert all(not isinstance(v, torch.Tensor) or v.dim() < 2 or v.numel() < 4096
               for _, v in iter_paths(ref))  # the reference is the NF4 copy
    jcfg = JConfig.tiny(vocab_size=259, compute_dtype=jnp.float32)
    tokens = np.random.default_rng(1).integers(0, 259, size=(2, 48)).astype(np.int32)
    want = np.asarray(j_apply(j_load_pytree(merged), jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        eff = apply_adapters(model.params, adapters, LoraConfig(
            r=8, alpha=16, target_patterns=DPO_TARGET_PATTERNS))
        got = Llama(LlamaConfig.tiny(vocab_size=259, compute_dtype=torch.float32),
                    eff)(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("flag,item", [
    (["--model_path", "/nonexistent"], 9), (["--adapter_path", "x"], 9),
    (["--adapter_output", "x"], 9), (["--merged_output", "hf_dir"], 9),
    (["--tensor_parallel", "2", "--vocab_chunks", "4"], 11), (["--pipeline_parallel", "2"], 11),
    (["--tensor_parallel", "2"], 11), (["--moe_experts", "2"], 11),
    (["--expert_parallel", "2"], 11)])
def test_unported_flags_are_refused_by_name(flag, item, monkeypatch, tmp_path, capsys):
    """Item 9's flags run since the HF slice: each gets the JAX package's own
    outcome for the same argument (an error from its importer, or the
    written directory). ``--moe_experts`` stays refused by name, as in the
    JAX package, whose run_dpo has no MoE: argparse names the flag it does
    not know. ``--expert_parallel`` is
    a trainer flag since item 11(e), and ``--pipeline_parallel`` since item
    11(f), and the JAX run_dpo builds its mesh without either (run_dpo.py:83):
    the run trains as if it were absent, the same losses on a grid of ep 1
    and pp 1. ``--tensor_parallel``
    runs since item 11(c): with ``--vocab_chunks`` it meets the JAX
    package's refusal in its words, and alone in a world of one the grid's
    refusal (the multi-rank runs are tests/test_torch_tensor_parallel.py's,
    and ``--seq_parallel``'s tests/test_torch_seq_parallel.py's)."""
    from distributed_lion_tpu.models import hf_import as j_hf_import

    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    if flag == ["--tensor_parallel", "2", "--vocab_chunks", "4"]:
        with pytest.raises(NotImplementedError,
                           match="--vocab_chunks x --tensor_parallel on the DPO path is not "
                                 "wired"):
            run_dpo.main(["--model_name", "tiny", *flag])
        return
    if flag == ["--tensor_parallel", "2"]:
        with pytest.raises(ValueError, match="--tensor_parallel 2 needs 2 ranks"):
            run_dpo.main(["--model_name", "tiny", *flag])
        return
    if flag in (["--expert_parallel", "2"], ["--pipeline_parallel", "2"]):
        run = ["--model_name", "tiny", "--max_length", "96", "--max_prompt_length", "48",
               "--num_train_samples", "32", "--size_valid_set", "0", "--max_steps", "1",
               "--per_device_train_batch_size", "1", "--gradient_accumulation_steps", "1"]
        runs = [run_dpo.main(run + f)[0] for f in ([], flag)]
        assert getattr(runs[1].cfg, flag[0][2:]) == 2 and runs[1].grid.ep == runs[1].grid.pp == 1
        assert ([h["loss"] for h in runs[1].history if "loss" in h]
                == [h["loss"] for h in runs[0].history if "loss" in h])
        return
    if item == 11:
        with pytest.raises(SystemExit):
            run_dpo.main(["--model_name", "tiny", *flag])
        assert f"unrecognized arguments: {' '.join(flag)}" in capsys.readouterr().err
        return
    name, value = flag
    run = ["--model_name", "tiny", *flag, "--max_length", "96", "--max_prompt_length", "48",
           "--num_train_samples", "32", "--size_valid_set", "0", "--max_steps", "1",
           "--per_device_train_batch_size", "1", "--gradient_accumulation_steps", "1"]
    if name in ("--adapter_output", "--merged_output"):
        run_dpo.main(run)
        want = "adapter_config.json" if name == "--adapter_output" else "config.json"
        assert (tmp_path / value / want).exists()
        return
    jax_side = (lambda: j_hf_import.llama_from_hf(value)) if name == "--model_path" else (
        lambda: j_hf_import.peft_to_lora(value, JConfig.tiny()))
    with pytest.raises(Exception) as want:
        jax_side()
    with pytest.raises(type(want.value)) as got:
        run_dpo.main(run)
    assert str(got.value) == str(want.value)


def test_quantized_reference_is_a_copy_and_the_base_stays_dense():
    _, (cfg, base, _, _) = _tiny()
    ref = quantize_tree(base, "nf4", block=32)
    assert ref is not base and ref["blocks"][0]["attn"]["wq"].fmt == "nf4"
    assert isinstance(base["blocks"][0]["attn"]["wq"], torch.Tensor)
