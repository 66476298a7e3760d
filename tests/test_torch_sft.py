"""The port's SFT path vs the JAX package's, on the CPU: the data pipeline,
the trainer over LoRA adapters on a frozen NF4 base, and the CLI.

Tolerances: packed and padded batches exact (the same numpy code). The
trainer comparison runs ``LlamaConfig.tiny`` at the byte vocabulary (259),
float32 compute, an NF4 base (block 32), LoRA r 4 on wq/wv at dropout 0,
W = 1 on a ``data=1`` mesh, 3 steps of 2 accumulated microbatches; the
bound was set before the first run: per-step losses within ``1e-5`` (float
sums in other orders), ≥ 99.9% of the adapters' coordinates bit-equal
after training and every one within ``2·lr·steps`` (a flipped election
moves a coordinate by 2·lr). Weight decay is 0 for the reason
tests/test_torch_gpt2.py states. At step 1 B is 0, so A's gradient is 0
and its ballots are all −1: A moves by +lr in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from distributed_lion_tpu.data import packing as j_packing
from distributed_lion_tpu.data import sft as j_sft
from distributed_lion_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from distributed_lion_tpu.models.llama import LlamaConfig as JConfig
from distributed_lion_tpu.models.llama import llama_apply as j_apply
from distributed_lion_tpu.models.llama import llama_init as j_init
from distributed_lion_tpu.models.lora import LoraConfig as JLoraConfig
from distributed_lion_tpu.models.lora import apply_adapters as j_apply_adapters
from distributed_lion_tpu.models.lora import lora_init as j_lora_init
from distributed_lion_tpu.models.loss import clm_loss_and_metrics as j_loss
from distributed_lion_tpu.ops.quant import quantize_tree as j_quantize_tree
from distributed_lion_tpu.parallel import make_mesh
from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
from distributed_lion_tpu.train.loop import Trainer as JTrainer
from distributed_lion_tpu.utils.serialization import load_pytree as j_load_pytree
from distributed_lion_tpu_torch.cli import run_sft
from distributed_lion_tpu_torch.data import packing, sft
from distributed_lion_tpu_torch.data.tokenizer import ByteTokenizer, load_tokenizer
from distributed_lion_tpu_torch.models.llama import Llama, LlamaConfig, llama_init
from distributed_lion_tpu_torch.models.loss import clm_loss_and_metrics
from distributed_lion_tpu_torch.models.lora import (
    LoraConfig,
    adapter_named_parameters,
    apply_adapters,
    lora_init,
)
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer, clm_loss_fn
from distributed_lion_tpu_torch.utils.serialization import (
    adapters_from_jax,
    llama_params_from_jax,
)

torch.set_num_threads(2)


def test_packed_and_padded_batches_equal_jax():
    records = sft.synthetic_qa_pairs(40, seed=3)
    assert records == j_sft.synthetic_qa_pairs(40, seed=3)
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    assert sft.chars_token_ratio(records, tok) == j_sft.chars_token_ratio(records, jtok)
    got = list(sft.constant_length_batches(records, tok, 48, infinite=False))
    want = list(j_sft.constant_length_batches(records, jtok, 48, infinite=False))
    assert len(got) == len(want) > 10
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    inf_got = sft.constant_length_batches(records, tok, 48, num_sequences_buffer=4)
    inf_want = j_sft.constant_length_batches(records, jtok, 48, num_sequences_buffer=4)
    for _ in range(3 * len(got)):   # past the end of the records: they repeat
        np.testing.assert_array_equal(next(inf_got), next(inf_want))
    for grouped in (False, True):
        tokens, mask = sft.padded_examples(records, tok, 40, group_by_length=grouped)
        jt, jm = j_sft.padded_examples(records, jtok, 40, group_by_length=grouped)
        np.testing.assert_array_equal(tokens, jt)
        np.testing.assert_array_equal(mask, jm)
        it = sft.padded_batch_iterator(tokens, mask, 6, seed=5, length_grouped=grouped)
        jit_ = j_sft.padded_batch_iterator(jt, jm, 6, seed=5, length_grouped=grouped)
        for _ in range(9):   # into the second epoch
            a, b = next(it), next(jit_)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["mask"], b["mask"])
    docs = [tok.encode(sft.prepare_sample_text(r)) for r in records]
    np.testing.assert_array_equal(packing.group_texts(docs, 32), j_packing.group_texts(docs, 32))


def _batches(n_batches, rows, T):
    gen = sft.constant_length_batches(sft.synthetic_qa_pairs(64), ByteTokenizer(), T)
    return [np.stack([next(gen) for _ in range(rows)]) for _ in range(n_batches)]


def test_sft_trainer_matches_jax_trainer():
    lr, steps, T = 3e-3, 3, 32
    common = dict(lion=True, async_grad=True, learning_rate=lr, weight_decay=0.0,
                  lr_scheduler_type="constant", max_steps=steps,
                  per_device_train_batch_size=2, gradient_accumulation_steps=2,
                  block_size=T, logging_steps=1, eval_steps=1000, seed=0)
    jcfg = JConfig.tiny(vocab_size=259, compute_dtype=jnp.float32)
    jbase = j_quantize_tree(j_init(jax.random.key(0), jcfg), "nf4", block=32)
    jlcfg = JLoraConfig(r=4, alpha=8, dropout=0.0)
    jad = j_lora_init(jax.random.key(1), jbase, jlcfg)
    init_ad = jax.tree.map(np.asarray, jad)
    batches = _batches(steps, 4, T)

    def j_loss_fn(params, batch, dropout_key):
        eff = j_apply_adapters(jbase, params, jlcfg, dropout_key=dropout_key)
        return j_loss(j_apply(eff, batch, jcfg), batch)

    jtr = JTrainer(JTrainConfig(**common), make_mesh(data=1, devices=jax.devices()[:1]),
                   apply_fn=None, params=jad, loss_fn=j_loss_fn)
    jhist = jtr.train(iter(batches))
    jtr.close()

    cfg = LlamaConfig.tiny(vocab_size=259, compute_dtype=torch.float32)
    base = llama_params_from_jax(jax.tree.map(np.asarray, jbase))
    ad = {p: {k: nn.Parameter(t) for k, t in ab.items()}
          for p, ab in adapters_from_jax(init_ad).items()}
    model, lcfg = Llama(cfg, base), LoraConfig(r=4, alpha=8, dropout=0.0)
    ttr = Trainer(TrainConfig(**common), adapter_named_parameters(ad),
                  clm_loss_fn(lambda tokens, seed: model(
                      tokens, apply_adapters(base, ad, lcfg, dropout_seed=seed))),
                  model=model)
    assert ttr.n_params == sum(a.size for ab in init_ad.values() for a in ab.values())
    thist = ttr.train(iter(batches))
    ttr.close()

    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist],
                               atol=1e-5, rtol=0)
    flat, _ = jax.tree_util.tree_flatten_with_path(jtr.params)
    want = np.concatenate([np.asarray(v).reshape(-1) for _, v in flat])
    got = np.concatenate([p.detach().numpy().reshape(-1)
                          for _, p in adapter_named_parameters(ad)])
    assert np.mean(got == want) >= 0.999
    assert np.max(np.abs(got - want)) <= 2 * lr * steps * (1 + 1e-6)
    # step 1: A's gradient is 0 (B = 0), so its ballots are -1 and it moves by +lr
    a0 = init_ad["blocks/0/attn/wq"]["A"]
    assert np.all(got[: a0.size] != a0.reshape(-1))


def test_padded_rows_carry_the_loss_mask():
    """Non-packed rows: the port's trainer hands ``{"tokens", "mask"}`` to
    ``clm_loss_and_metrics``, so padding contributes no loss and no tokens."""
    cfg = LlamaConfig.tiny(vocab_size=259, compute_dtype=torch.float32)
    base = llama_init(cfg, seed=0, device="cpu")
    ad = {p: {k: nn.Parameter(t) for k, t in ab.items()}
          for p, ab in lora_init(base, LoraConfig(), seed=1).items()}
    model = Llama(cfg, base)
    trainer = Trainer(TrainConfig(max_steps=1, per_device_eval_batch_size=4, eval_iters=1,
                                  per_device_train_batch_size=2, gradient_accumulation_steps=1),
                      adapter_named_parameters(ad),
                      clm_loss_fn(lambda t, s: model(t, apply_adapters(base, ad, LoraConfig()))),
                      model=model)
    tokens, mask = sft.padded_examples(sft.synthetic_qa_pairs(4), ByteTokenizer(), 64)
    assert 0 < mask.sum() < mask.size
    masked = trainer.evaluate({"tokens": tokens, "mask": mask})["eval/loss"]
    full = trainer.evaluate(tokens)["eval/loss"]
    with torch.no_grad():
        t = torch.from_numpy(tokens.astype(np.int64))
        logits = model(t)
        want_masked = clm_loss_and_metrics(logits, t, torch.from_numpy(mask))[0].item()
        want_full = clm_loss_and_metrics(logits, t)[0].item()
    assert masked == pytest.approx(want_masked, abs=1e-6) and masked != full
    assert full == pytest.approx(want_full, abs=1e-6)
    trainer.close()


def test_run_sft_cli_writes_a_merged_model_the_jax_package_reproduces(tmp_path, monkeypatch):
    """``DLION_PLATFORM=cpu`` run of the port's CLI (tiny, NF4 base, packed
    rows, dropout on) writes the merged, dequantized model; the JAX
    package's ``load_pytree`` and ``llama_apply`` give the port's logits
    from it (float32 compute, ``atol=1e-5``)."""
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    out = tmp_path / "merged.npz"
    trainer, model, adapters = run_sft.main([
        "--model_name", "tiny", "--quant", "nf4", "--seq_length", "48",
        "--num_train_samples", "48", "--size_valid_set", "16",
        "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "2",
        "--max_steps", "2", "--logging_steps", "1", "--learning_rate", "3e-3",
        "--warmup_steps", "1", "--merged_output", str(out), "--output_dir", str(tmp_path)])
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert np.isfinite([h["eval/loss"] for h in trainer.history if "eval/loss" in h]).all()
    merged = j_load_pytree(out)
    jcfg = JConfig.tiny(vocab_size=259, compute_dtype=jnp.float32)
    tokens = np.random.default_rng(1).integers(0, 259, size=(2, 48)).astype(np.int32)
    want = np.asarray(j_apply(merged, jnp.asarray(tokens), jcfg))
    eval_cfg = LlamaConfig.tiny(vocab_size=259, compute_dtype=torch.float32)
    with torch.no_grad():
        eff = apply_adapters(model.params, adapters, LoraConfig())
        got = Llama(eval_cfg, eff)(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


TINY_RUN = ["--seq_length", "64", "--num_train_samples", "16", "--size_valid_set", "0",
            "--max_steps", "1", "--per_device_train_batch_size", "1",
            "--gradient_accumulation_steps", "1"]


def _jax_outcome(fn):
    """``(type name, message)`` of what ``fn`` raises."""
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("flag", [
    ["--model_path", "/nonexistent"], ["--adapter_path", "x"], ["--adapter_output", "x"],
    ["--merged_output", "hf_dir"], ["--pipeline_parallel", "2"], ["--tensor_parallel", "2"],
    ["--moe_experts", "2"], ["--tokenizer_name", "sp:tokenizer.model"],
    ["--expert_parallel", "2"]])
def test_unported_flags_are_refused_by_name(flag, monkeypatch, tmp_path, capsys):
    """Since the HF slice the first four flags and SentencePiece run; each
    gets the JAX package's own outcome for the same argument.
    ``--moe_experts`` stays refused by name, as in the JAX package, whose
    run_sft has no MoE: argparse names the flag it does not know. ``--expert_parallel`` is a trainer flag since item
    11(e), and ``--pipeline_parallel`` since item 11(f), and the JAX
    run_sft builds its mesh without either (run_sft.py:140): the run trains
    as if it were absent, the same losses on a grid of ep 1 and pp 1.
    ``--tensor_parallel`` runs since item 11(c), and in a world of one meets
    the grid's refusal (the multi-rank runs are
    tests/test_torch_tensor_parallel.py's, and ``--seq_parallel``'s
    tests/test_torch_seq_parallel.py's)."""
    from distributed_lion_tpu.data.tokenizer import load_tokenizer as j_load_tokenizer
    from distributed_lion_tpu.models import hf_import as j_hf_import

    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    name, value = flag
    if name in ("--adapter_output", "--merged_output"):  # JAX writes the HF directory
        run_sft.main(["--model_name", "tiny", *flag, *TINY_RUN])
        want = "adapter_config.json" if name == "--adapter_output" else "config.json"
        assert (tmp_path / value / want).exists()
        return
    jax_side = {
        "--model_path": lambda: j_hf_import.llama_from_hf(value),
        "--adapter_path": lambda: j_hf_import.peft_to_lora(value, JConfig.tiny()),
        "--tokenizer_name": lambda: j_load_tokenizer(value)}
    if name == "--tensor_parallel":
        with pytest.raises(ValueError, match="--tensor_parallel 2 needs 2 ranks"):
            run_sft.main(["--model_name", "tiny", *flag])
        return
    if name in ("--expert_parallel", "--pipeline_parallel"):
        runs = [run_sft.main(["--model_name", "tiny", *f, *TINY_RUN])[0] for f in ([], flag)]
        assert getattr(runs[1].cfg, name[2:]) == 2 and runs[1].grid.ep == runs[1].grid.pp == 1
        assert ([h["loss"] for h in runs[1].history if "loss" in h]
                == [h["loss"] for h in runs[0].history if "loss" in h])
        return
    if name not in jax_side:
        with pytest.raises(SystemExit):
            run_sft.main(["--model_name", "tiny", *flag])
        assert f"unrecognized arguments: {name} {value}" in capsys.readouterr().err
        return
    kind, msg = _jax_outcome(jax_side[name])
    with pytest.raises(Exception) as got:
        run_sft.main(["--model_name", "tiny", *flag, *TINY_RUN])
    assert (type(got.value).__name__, str(got.value)) == (kind, msg)


def test_reference_guards():
    with pytest.raises(ValueError, match="packing and group by length"):
        run_sft.main(["--group_by_length"])
    with pytest.raises(ValueError, match="gradient_checkpointing"):
        run_sft.main(["--gradient_checkpointing"])
    from distributed_lion_tpu.data.tokenizer import load_tokenizer as j_load_tokenizer

    with pytest.raises(FileNotFoundError) as got:  # SentencePiece is ported: JAX's outcome
        load_tokenizer("sp:tokenizer.model")
    assert ("FileNotFoundError", str(got.value)) == _jax_outcome(
        lambda: j_load_tokenizer("sp:tokenizer.model"))
    assert load_tokenizer(None).vocab_size == 259
