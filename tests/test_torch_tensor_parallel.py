"""Tensor parallelism (dp 2 × tp 2) against the JAX package on its CPU mesh.

Four gloo ranks on the CPU form the grid (``parallel.mesh.make_grid``: data
rank ``r // 2``, tensor rank ``r % 2``); the JAX references run on
``make_mesh(data=2, tensor=2)`` from the same numpy-seeded weights and
batches, carried across by ``utils.serialization``'s converters. One spawn
runs every multi-rank case (the ``grid_run`` fixture) while the fixture
computes the JAX references; the tests compare what both wrote.

- *f* and *g* at tp 2: identity forward and a sum over the tensor group
  backward, and the reverse.
- GPT-2 tiny and Llama tiny (GQA: 4 query, 2 kv heads, one kv head a rank),
  3 steps at float32 compute, weight decay 0, constant LR, on ``sign_psum``:
  per-step losses within 1e-5 of JAX's (the port's data-parallel bound);
  each rank's momentum after step 1, ``(1 − β₂)·g``, within 1e-6 of
  ``max|m|`` of JAX's ``exp_avg[data rank]`` sliced by the shard rule (the
  TP reductions sum in another order); at least 99.9% of the final params
  bit-equal to JAX's slices and every coordinate within ``2·lr·steps`` (a
  flipped election moves a coordinate by 2·lr). ``--tp_vocab`` (GPT-2 over
  a padded 250-row vocabulary, so the pad columns are masked) is held to
  JAX's ``--tp_vocab`` run the same way, and Llama's to the port's own
  replicated head within 1e-5.
- The replicated leaves stay ``torch.equal`` across the tensor ranks after
  every step, and the logged losses are equal across them.
- QLoRA SFT at tp 2 over an NF4 base (block 16, min size 1024) against the
  JAX trainer of ``tests/test_lora_tp.py::test_sft_tp_matches_dp_nf4_base``
  on the same quantized base: losses within 1e-5; each rank's momentum
  after step 2 (B is zero at step 1, so A's gradient is too) within 1e-6
  of each leaf's ``max|m|`` of JAX's ``exp_avg[data rank]`` sliced; the
  adapters ≥ 99.9% bit-equal to JAX's slices and within ``2·lr·steps``,
  and most of A moved; each rank's NF4 codes and absmax ``torch.equal`` to
  the slice of the whole quantized weight, the port's and the JAX
  package's. ``run_dpo --tensor_parallel 2`` trains
  (``test_dpo_tp_trains``).
- A save at dp 2 × tp 2 and its resume reproduce an uninterrupted run
  ``torch.equal``; the step's files have a data-parallel run's names and
  shapes. So does the DCN pipeline's (``hier:1``, two groups of one in
  each data group, ``--dcn_pipeline_depth 1``), its ring included, whose
  files are a tensor rank's each.
- Every refusal, by message.

This file imports jax only inside the fixture and the tests, so the
spawned ranks import torch alone.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from distributed_lion_tpu_torch.cli import run_clm, run_dpo, run_sft
from distributed_lion_tpu_torch.data.sources import batch_iterator
from distributed_lion_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_lion_tpu_torch.models.llama import Llama, LlamaConfig, llama_init
from distributed_lion_tpu_torch.models.lora import (
    LoraConfig,
    adapter_named_parameters,
    adapter_shard_rule,
    apply_adapters,
    lora_adapter_specs,
)
from distributed_lion_tpu_torch.ops.quant import QuantizedTensor, quantize_tree, validate_quant_tp
from distributed_lion_tpu_torch.parallel import tensor_parallel as tpar
from distributed_lion_tpu_torch.parallel.mesh import make_grid
from distributed_lion_tpu_torch.train.checkpoint import Checkpointer
from distributed_lion_tpu_torch.train.loop import (
    TrainConfig,
    Trainer,
    check_resume_meta,
    clm_loss_fn,
    resolve_auto_comm,
)
from distributed_lion_tpu_torch.utils.serialization import (
    adapter_momentum_from_jax,
    adapters_from_jax,
    llama_params_from_jax,
    load_pytree,
    momentum_from_jax,
    params_from_jax,
    state_dict_from_tree,
)

WORLD, TP = 4, 2
LR, STEPS, T = 3e-3, 3, 32
COMMON = dict(lion=True, async_grad=True, learning_rate=LR, weight_decay=0.0,
              lr_scheduler_type="constant", max_steps=STEPS, per_device_train_batch_size=2,
              gradient_accumulation_steps=2, block_size=T, logging_steps=1, eval_steps=1000,
              seed=0, wire="sign_psum")
# name: (family, tp_vocab, vocab_size, vocab_pad_multiple)
RUNS = {"gpt2": ("gpt2", False, 256, 0), "gpt2_vocab": ("gpt2", True, 250, 64),
        "llama": ("llama", False, 256, 0), "llama_vocab": ("llama", True, 256, 0)}
JAX_RUNS = ("gpt2", "gpt2_vocab", "llama")
# the QLoRA case: tests/test_lora_tp.py's model, adapters and base
SFT_LR, SFT_STEPS, SFT_SEED = 1e-3, 3, 7
SFT_MOM_STEP = 2   # B is zero until step 1's update: A's first gradient is at step 2
LORA = LoraConfig(r=4, alpha=8)
NF4 = dict(min_size=1024, block=16)
SFT_CFG = dict(lion=True, async_grad=True, learning_rate=SFT_LR, weight_decay=0.0,
               lr_scheduler_type="constant", max_steps=SFT_STEPS,
               per_device_train_batch_size=2, gradient_accumulation_steps=1, block_size=T,
               logging_steps=1, eval_steps=1000, seed=SFT_SEED, wire="sign_psum")
DCN_FLAGS = ["--wire", "hier:1", "--dcn_pipeline_depth", "1"]
CLM_ARGV = ["--model_name", "tiny", "--dataset", "synthetic", "--synthetic_blocks", "64",
            "--block_size", "32", "--per_device_train_batch_size", "2",
            "--gradient_accumulation_steps", "1", "--logging_steps", "1", "--dropout", "0",
            "--lr_scheduler_type", "constant", "--learning_rate", "3e-3",
            "--tensor_parallel", "2", "--eval_iters", "1", "--per_device_eval_batch_size", "1"]
DPO_BASE = ["--model_name", "tiny", "--max_length", "96", "--max_prompt_length", "48",
            "--num_train_samples", "32", "--size_valid_set", "0", "--max_steps", "2",
            "--per_device_train_batch_size", "1", "--gradient_accumulation_steps", "1",
            "--logging_steps", "1", "--quant_ref", "nf4", "--tensor_parallel", "2"]
DPO_ARGV = DPO_BASE + ["--quant_block", "16"]
TINY32 = dict(compute_dtype=torch.float32)
# name: (what it builds, the exception, the message)
REFUSALS = {
    "vote_every": ("gpt2", dict(vote_every=4), ValueError,
                   r"--vote_every > 1 is incompatible with params sharded over \['tensor'\]"),
    "telemetry": ("gpt2", dict(telemetry=True), ValueError,
                  r"--telemetry is incompatible with params sharded over \['tensor'\]"),
    "vote_guard": ("gpt2", dict(vote_guard="enforce"), ValueError,
                   r"--vote_guard is incompatible with params sharded over \['tensor'\]"),
    "control_plane": ("gpt2", dict(control_plane=True), ValueError,
                      r"--vote_guard is incompatible with params sharded"),
    "zero1": ("gpt2", dict(lion=False, async_grad=False, zero1=True), ValueError,
              r"--zero1 is incompatible with a 'tensor' mesh axis of size 2"),
    "adamw": ("gpt2", dict(lion=False, async_grad=False), NotImplementedError,
              r"tensor-parallel param_specs require the Lion path"),
    "tp_vocab_chunks": ("gpt2", dict(tp_vocab=True, vocab_chunks=4), NotImplementedError,
                        r"--tp_vocab and --vocab_chunks are alternative head strategies"),
    "gpt2_vocab_rows": ("gpt2_v255", dict(tp_vocab=True), ValueError,
                        r"--tp_vocab: embedding rows 255 not divisible by tensor axis 2; "
                        r"vocab_pad_multiple"),
    "gpt2_heads": ("gpt2_h1", {}, ValueError, r"n_head 1 not divisible by tensor axis 2"),
    "llama_heads": ("llama_kv1", {}, ValueError,
                    r"heads \(4/1kv\) not divisible by tensor axis 2"),
    "llama_d_ff": ("llama_ff", {}, ValueError, r"d_ff 129 not divisible by tensor axis 2"),
    "llama_vocab": ("llama_v255", dict(tp_vocab=True), ValueError,
                    r"--tp_vocab: vocab 255 not divisible by tensor axis 2"),
    "grid_3": ("grid_3", {}, ValueError,
               r"--tensor_parallel 3 does not divide the world of 4 ranks"),
    "sft_tp_vocab": ("sft", {}, NotImplementedError,
                     r"--tp_vocab is wired for run_clm's dense dp x tp paths .* run_sft's loss"),
    "dpo_tp_vocab": ("dpo_tp_vocab", {}, NotImplementedError,
                     r"--tp_vocab is wired for run_clm's dense dp x tp paths .* run_dpo's loss"),
    "dpo_quant_flat": ("dpo_flat", {}, ValueError,
                       r"quantized leaf 'blocks/0/attn/wq' has the flat layout"),
}


def _model(kind: str):
    return {"gpt2": GPT2Config.tiny(**TINY32),
            "gpt2_v255": GPT2Config.tiny(vocab_size=255, **TINY32),
            "gpt2_h1": GPT2Config.tiny(n_head=1, **TINY32),
            "llama_kv1": LlamaConfig.tiny(n_kv_head=1, **TINY32),
            "llama_ff": LlamaConfig.tiny(d_ff=129, **TINY32),
            "llama_v255": LlamaConfig.tiny(vocab_size=255, **TINY32)}[kind]


# ------------------------------------------------------------ the ranks
def _fg(grid) -> dict:
    """*f* and *g* on a rank-dependent vector: values and gradients."""
    t = grid.tensor
    x = (torch.arange(4.0) * (t.rank + 1)).requires_grad_()
    y = tpar.copy_to_tp_region(x, t.group)
    (y * (t.rank + 2)).sum().backward()
    x2 = (torch.arange(4.0) * (t.rank + 1)).requires_grad_()
    z = tpar.reduce_from_tp_region(x2, t.group)
    (z * (t.rank + 2)).sum().backward()
    return {"f_fwd": y.tolist(), "f_bwd": x.grad.tolist(), "g_fwd": z.tolist(),
            "g_bwd": x2.grad.tolist()}


def _replicated_equal(trainer) -> bool:
    """The replicated leaves of this rank equal its tensor peer's bit for bit."""
    views = trainer.flat.views(trainer.flat.params)
    rep = torch.cat([views[n].reshape(-1) for n, d in zip(trainer.flat.names, trainer._dims)
                     if d is None])
    both = [torch.empty_like(rep) for _ in range(TP)]
    dist.all_gather(both, rep, group=trainer.tensor.group)
    return all(torch.equal(both[0], b) for b in both[1:])


def _train_steps(trainer, blocks, out: str, name: str, rank: int, mom_step: int = 1) -> dict:
    """Train ``cfg.max_steps`` steps one at a time: the momentum after step
    ``mom_step``, the replicated leaves' equality after every step, the
    final params."""
    steps = trainer.cfg.max_steps
    it = batch_iterator(blocks, trainer.global_train_batch(), seed=0)
    equal = []
    for k in range(1, steps + 1):
        trainer.cfg.max_steps = k
        trainer.train(it)
        if k == mom_step:
            np.save(f"{out}/{name}_mom_{rank}.npy", trainer.state.exp_avg.numpy())
        equal.append(_replicated_equal(trainer))
    np.save(f"{out}/{name}_params_{rank}.npy", trainer.flat.params.detach().numpy())
    rec = {"losses": [h["loss"] for h in trainer.history if "loss" in h],
           "replicated_equal": equal, "names": trainer.flat.names,
           "n_params": trainer.n_params, "n_global": trainer.n_global}
    trainer.close()
    return rec


def _clm_case(grid, out: str, name: str, rank: int) -> dict:
    family, tp_vocab, vocab, pad = RUNS[name]
    cfg = TrainConfig(**COMMON, tensor_parallel=TP, tp_vocab=tp_vocab)
    init = load_pytree(f"{out}/{family}_{vocab}_init.npz")
    if family == "gpt2":
        mcfg = GPT2Config.tiny(vocab_size=vocab, vocab_pad_multiple=pad, dropout=0.0, **TINY32)
        trainer = Trainer.for_gpt2(cfg, mcfg, device="cpu", initial_params=params_from_jax(init),
                                   grid=grid)
    else:
        trainer = Trainer.for_llama(cfg, LlamaConfig.tiny(**TINY32), device="cpu",
                                    initial_params=llama_params_from_jax(init), grid=grid)
    return _train_steps(trainer, np.load(f"{out}/blocks_{vocab}.npy"), out, name, rank)


def _hier_case(grid, out: str, rank: int) -> list:
    """The ``gpt2`` run on ``hier:2``; its final params to a file."""
    cfg = TrainConfig(**(COMMON | dict(wire="hier:2", tensor_parallel=TP)))
    trainer = Trainer.for_gpt2(cfg, GPT2Config.tiny(dropout=0.0, **TINY32), device="cpu",
                               initial_params=params_from_jax(
                                   load_pytree(f"{out}/gpt2_256_init.npz")), grid=grid)
    hist = trainer.train(batch_iterator(np.load(f"{out}/blocks_256.npy"),
                                        trainer.global_train_batch(), seed=0))
    np.save(f"{out}/hier_params_{rank}.npy", trainer.flat.params.detach().numpy())
    trainer.close()
    return [h["loss"] for h in hist if "loss" in h]


def _sft_case(grid, out: str, rank: int) -> dict:
    """The QLoRA trainer at tp 2, wired as run_sft wires it."""
    t = grid.tensor
    whole = quantize_tree(llama_params_from_jax(load_pytree(f"{out}/sft_base.npz")), "nf4",
                          **NF4)
    validate_quant_tp(whole, tpar.llama_shard_dim, TP)
    base = tpar.shard_tree(whole, tpar.llama_shard_dim, TP, t.rank)
    codes = {}
    for path in ("blocks.0.attn.wq", "blocks.0.attn.wo", "blocks.1.mlp.w_down"):
        leaf = base
        for p in path.split("."):
            leaf = leaf[int(p)] if p.isdigit() else leaf[p]
        codes[path] = [leaf.codes.numpy().tolist(), leaf.absmax.numpy().tolist()]
    # llama_init's own slices: the slices of its whole quantized init
    mine = llama_init(LlamaConfig.tiny(), seed=3, device="cpu", quant="nf4", quant_block=16,
                      tp=t)
    full = llama_init(LlamaConfig.tiny(), seed=3, device="cpu", quant="nf4", quant_block=16)
    init_equal = []
    for (name, a), (_, b) in zip(_leaves(mine), _leaves(full)):
        b = tpar.shard(b, tpar.llama_shard_dim(name), TP, t.rank)
        if isinstance(a, QuantizedTensor):
            init_equal.append(torch.equal(a.codes, b.codes) and torch.equal(a.absmax, b.absmax)
                              and a.shape == b.shape)
        else:
            init_equal.append(torch.equal(a, b))
    adapters = adapters_from_jax(_adapters(out), tp=TP, t=t.rank,
                                 base_rule=tpar.llama_shard_dim)
    specs = lora_adapter_specs(adapters, tpar.llama_shard_dim)
    params = {p: {k: nn.Parameter(v) for k, v in ab.items()} for p, ab in adapters.items()}
    model = Llama(LlamaConfig.tiny(**TINY32), base, tp=t)
    loss_fn = clm_loss_fn(lambda tokens, seed: model(tokens, apply_adapters(
        base, params, LORA, dropout_seed=seed, tp=t, base_rule=tpar.llama_shard_dim)))
    trainer = Trainer(TrainConfig(**SFT_CFG, tensor_parallel=TP),
                      adapter_named_parameters(params), loss_fn, grid=grid,
                      shard_rule=adapter_shard_rule(specs))
    rec = _train_steps(trainer, np.load(f"{out}/sft_blocks.npy"), out, "sft", rank,
                       SFT_MOM_STEP)
    rec.update(codes=codes, init_equal=init_equal)
    return rec


def _adapters(out: str) -> dict:
    """The JAX adapters ``{path: {"A", "B"}}`` as numpy arrays (their paths
    hold "/", so the file keys are ``path:A``)."""
    with np.load(f"{out}/sft_adapters.npz") as f:
        adapters: dict = {}
        for key in f.files:
            path, k = key.rsplit(":", 1)
            adapters.setdefault(path, {})[k] = f[key]
    return adapters


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _dpo_case(grid) -> dict:
    """``run_dpo --tensor_parallel 2`` trains; its replicated adapter
    factors stay equal across the tensor ranks."""
    trainer, _, adapters, _ = run_dpo.main(DPO_ARGV)
    rows = [h for h in trainer.history if "loss" in h]
    specs = lora_adapter_specs(adapters, tpar.llama_shard_dim)
    rep = torch.cat([adapters[p][k].detach().reshape(-1) for p in sorted(adapters)
                     for k in ("A", "B") if specs[p][k] is None])
    both = [torch.empty_like(rep) for _ in range(TP)]
    dist.all_gather(both, rep, group=grid.tensor.group)
    return {"losses": [r["loss"] for r in rows], "world": trainer.world,
            "replicated_equal": torch.equal(both[0], both[1])}


def _resume_case(out: str, tag: str = "resume", flags: tuple = ()) -> dict:
    """A save at step 2 and its resume to 4 against an uninterrupted run."""
    argv = CLM_ARGV + list(flags)
    a, b = f"{out}/{tag}_a", f"{out}/{tag}_b"
    run_clm.main(argv + ["--output_dir", a, "--save_steps", "2", "--max_steps", "2"])
    resumed = run_clm.main(argv + ["--output_dir", a, "--save_steps", "2", "--max_steps", "4"])
    straight = run_clm.main(argv + ["--output_dir", b, "--save_steps", "1000",
                                    "--max_steps", "4"])
    rings = [resumed.state.dcn_ring, straight.state.dcn_ring]
    return {"resumed_from": [h["step"] for h in resumed.history if "loss" in h],
            "params_equal": torch.equal(resumed.flat.params, straight.flat.params),
            "momentum_equal": torch.equal(resumed.state.exp_avg, straight.state.exp_avg),
            "ring_bytes": None if rings[0] is None else rings[0].numel(),
            "ring_equal": rings[0] is None or torch.equal(*rings)}


def _refusals(grid) -> dict:
    """Each refusal's (type, message), or None where nothing was raised."""
    got = {}
    for name, (kind, flags, _, _) in REFUSALS.items():
        try:
            if kind == "grid_3":
                make_grid(3)
            elif kind == "sft":
                run_sft.main(["--model_name", "tiny", "--seq_length", "32", "--max_steps", "1",
                              "--tensor_parallel", "2", "--tp_vocab"])
            elif kind == "dpo_flat":   # block 24 divides no width of the tiny model
                run_dpo.main(DPO_BASE + ["--quant_block", "24"])
            elif kind == "dpo_tp_vocab":
                run_dpo.main(DPO_ARGV + ["--tp_vocab"])
            else:
                cfg = TrainConfig(**(COMMON | dict(tensor_parallel=TP) | flags))
                build = Trainer.for_gpt2 if kind.startswith("gpt2") else Trainer.for_llama
                build(cfg, _model(kind), device="cpu", grid=grid).close()
            got[name] = None
        except Exception as e:  # noqa: BLE001 - the message is what is held
            got[name] = [type(e).__name__, str(e)]
    return got


def _rank(rank: int, out: str) -> None:
    os.environ["DLION_PLATFORM"] = "cpu"
    dist.init_process_group("gloo", init_method=f"file://{out}/pg", rank=rank,
                            world_size=WORLD)
    torch.set_num_threads(1)
    try:
        grid = make_grid(TP)
        rec = {"grid": [grid.rank, grid.data_rank, grid.tensor.rank, grid.dp, grid.tp],
               "fg": _fg(grid)}
        for name in RUNS:
            rec[name] = _clm_case(grid, out, name, rank)
        rec["hier"] = _hier_case(grid, out, rank)
        rec["sft"] = _sft_case(grid, out, rank)
        rec["dpo"] = _dpo_case(grid)
        rec["resume"] = _resume_case(out)
        rec["dcn_resume"] = _resume_case(out, "dcn", DCN_FLAGS)
        rec["refusals"] = _refusals(grid)
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the JAX side
def _jax_inputs(out: str) -> None:
    """Weights and batches, numpy-seeded through the JAX package, to files."""
    import jax

    from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2
    from distributed_lion_tpu.models.gpt2 import gpt2_init
    from distributed_lion_tpu.models.llama import LlamaConfig as JLlama
    from distributed_lion_tpu.models.llama import llama_init as j_llama_init
    from distributed_lion_tpu.models.lora import LoraConfig as JLora
    from distributed_lion_tpu.models.lora import lora_init as j_lora_init
    from distributed_lion_tpu.utils.serialization import save_pytree as j_save

    for family, _, vocab, pad in RUNS.values():
        if family == "gpt2":
            init = gpt2_init(jax.random.key(0), JGPT2.tiny(vocab_size=vocab,
                                                           vocab_pad_multiple=pad))
        else:
            init = j_llama_init(jax.random.key(0), JLlama.tiny())
        j_save(f"{out}/{family}_{vocab}_init.npz", jax.tree.map(np.asarray, init))
        np.save(f"{out}/blocks_{vocab}.npy", j_synthetic(256, T, vocab))
    base = j_llama_init(jax.random.key(0), JLlama.tiny())
    j_save(f"{out}/sft_base.npz", jax.tree.map(np.asarray, base))
    adapters = j_lora_init(jax.random.key(1), base, JLora(r=LORA.r, alpha=LORA.alpha))
    np.savez(f"{out}/sft_adapters.npz", **{f"{path}:{k}": np.asarray(ab[k])
                                          for path, ab in adapters.items() for k in ab})
    np.save(f"{out}/sft_blocks.npy", j_synthetic(64, T, 256, seed=11))


def _jax_references(out: str) -> dict:
    """The JAX trainers at data=2 × tensor=2: losses, the stacked momentum
    after step 1 and the final params of each run; the QLoRA trainer's
    losses, adapters and quantized base."""
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.data.sources import batch_iterator as j_batches
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2
    from distributed_lion_tpu.models.llama import LlamaConfig as JLlama
    from distributed_lion_tpu.models.llama import llama_apply
    from distributed_lion_tpu.models.lora import LoraConfig as JLora
    from distributed_lion_tpu.models.lora import apply_adapters as j_apply_adapters
    from distributed_lion_tpu.models.lora import lora_adapter_specs as j_adapter_specs
    from distributed_lion_tpu.models.loss import clm_loss_and_metrics
    from distributed_lion_tpu.ops.quant import quantize_tree as j_quantize_tree
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.parallel.mesh import TENSOR_AXIS
    from distributed_lion_tpu.parallel.tensor_parallel import llama_param_specs
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer
    from distributed_lion_tpu.utils.serialization import load_pytree as j_load

    mesh = make_mesh(data=2, tensor=2, devices=jax.devices()[:4])

    def run(jtr, blocks, steps, mom_step=1):
        it = j_batches(blocks, jtr.global_train_batch(), seed=0)
        hist = jtr.train(it, max_steps=mom_step)
        mom = jax.tree.map(np.asarray, jtr.state.exp_avg)
        hist += jtr.train(it, max_steps=steps - mom_step)
        rec = {"losses": [h["loss"] for h in hist if "loss" in h], "mom": mom,
               "params": jax.tree.map(np.asarray, jtr.params)}
        jtr.close()
        return rec

    refs = {}
    for name in JAX_RUNS:
        family, tp_vocab, vocab, pad = RUNS[name]
        cfg = JTrainConfig(**COMMON, tensor_parallel=TP, tp_vocab=tp_vocab)
        init = j_load(f"{out}/{family}_{vocab}_init.npz")
        if family == "gpt2":
            jtr = JTrainer.for_gpt2(cfg, mesh, JGPT2.tiny(vocab_size=vocab, vocab_pad_multiple=pad,
                                                          compute_dtype=jnp.float32, dropout=0.0),
                                    initial_params=init)
        else:
            jtr = JTrainer.for_llama(cfg, mesh, JLlama.tiny(compute_dtype=jnp.float32),
                                     initial_params=init)
        refs[name] = run(jtr, np.load(f"{out}/blocks_{vocab}.npy"), STEPS)
    model = JLlama.tiny(compute_dtype=jnp.float32)
    lora = JLora(r=LORA.r, alpha=LORA.alpha)
    qbase = j_quantize_tree(j_load(f"{out}/sft_base.npz"), "nf4", **NF4)
    base_specs = llama_param_specs(model)
    adapters = _adapters(out)

    def loss_fn(params, frozen, batch, dropout_key):
        eff = j_apply_adapters(frozen, params, lora, tp_axis=TENSOR_AXIS, base_specs=base_specs)
        return clm_loss_and_metrics(llama_apply(eff, batch, model, tp_axis=TENSOR_AXIS), batch)

    jtr = JTrainer(JTrainConfig(**SFT_CFG, tensor_parallel=TP), mesh, apply_fn=None,
                   params=adapters, param_specs=j_adapter_specs(adapters, base_specs, TENSOR_AXIS),
                   loss_fn=loss_fn, frozen_params=qbase, frozen_specs=base_specs)
    refs["sft"] = run(jtr, np.load(f"{out}/sft_blocks.npy"), SFT_STEPS, SFT_MOM_STEP)
    refs["sft"]["qbase"] = qbase
    return refs


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    """Start the four ranks, compute the JAX references meanwhile, then wait
    for the ranks: ``(their records, the JAX references, the directory)``."""
    out = tmp_path_factory.mktemp("tp")
    _jax_inputs(str(out))
    ctx = mp.start_processes(_rank, args=(str(out),), nprocs=WORLD, join=False,
                             start_method="spawn")
    refs = _jax_references(str(out))
    while not ctx.join():
        pass
    recs = [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return recs, refs, out


# ----------------------------------------------------------- the tests
def _flat(named: dict, names: list) -> np.ndarray:
    return np.concatenate([named[n].reshape(-1).numpy() for n in names])


def _jax_params(name: str, tree, t: int) -> dict:
    """Tensor rank ``t``'s slices of a JAX params tree, through the
    converters, keyed like the port's flat names."""
    family, tp_vocab, _, _ = RUNS[name]
    if family == "gpt2":
        return params_from_jax(tree, TP, t, tp_vocab)
    return state_dict_from_tree(llama_params_from_jax(tree, tp=TP, t=t, vocab_parallel=tp_vocab))


def test_grid_layout(grid_run):
    recs, _, _ = grid_run
    assert [r["grid"] for r in recs] == [[r, r // TP, r % TP, 2, TP] for r in range(WORLD)]


def test_f_and_g_forward_and_backward(grid_run):
    recs, _, _ = grid_run
    base = np.arange(4.0)
    for r, rec in enumerate(recs):
        t = r % TP
        np.testing.assert_array_equal(rec["fg"]["f_fwd"], base * (t + 1))
        np.testing.assert_array_equal(rec["fg"]["f_bwd"], np.full(4, 2.0 + 3.0))
        np.testing.assert_array_equal(rec["fg"]["g_fwd"], base * (1 + 2))
        np.testing.assert_array_equal(rec["fg"]["g_bwd"], np.full(4, t + 2.0))


@pytest.mark.parametrize("name", JAX_RUNS)
def test_losses_match_jax(grid_run, name):
    recs, refs, _ = grid_run
    for rec in recs:
        assert len(rec[name]["losses"]) == STEPS
        np.testing.assert_allclose(rec[name]["losses"], refs[name]["losses"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", JAX_RUNS)
def test_momentum_shards_match_jax_exp_avg(grid_run, name):
    """After step 1 the momentum is (1 − β₂)·g: each rank's flat buffer is
    JAX's ``exp_avg[data rank]`` sliced by the shard rule
    (``momentum_from_jax`` at ``(tp, t)``)."""
    recs, refs, out = grid_run
    family, tp_vocab, _, _ = RUNS[name]
    for r in range(WORLD):
        names = recs[r][name]["names"]
        want = _flat(momentum_from_jax(refs[name]["mom"], r // TP, TP, r % TP, tp_vocab,
                                       family), names)
        got = np.load(out / f"{name}_mom_{r}.npy")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", JAX_RUNS)
def test_elections_match_jax(grid_run, name):
    """The final params: every data rank's equal, ≥ 99.9% bit-equal to JAX's
    slices and within 2·lr·steps everywhere."""
    recs, refs, out = grid_run
    for r in range(WORLD):
        got = np.load(out / f"{name}_params_{r}.npy")
        want = _flat(_jax_params(name, refs[name]["params"], r % TP), recs[r][name]["names"])
        np.testing.assert_array_equal(got, np.load(out / f"{name}_params_{r % TP}.npy"))
        assert np.mean(got == want) >= 0.999, (name, r)
        assert np.max(np.abs(got - want)) <= 2 * LR * STEPS * (1 + 1e-6), (name, r)


def test_hier_wire_under_tensor_parallelism(grid_run):
    """``hier:2`` over the two data ranks (one group: the flat majority,
    every data group's subgroups built on every process) trains to the
    params of the ``sign_psum`` run, bit for bit."""
    recs, _, out = grid_run
    for r in range(WORLD):
        np.testing.assert_array_equal(np.load(out / f"hier_params_{r}.npy"),
                                      np.load(out / f"gpt2_params_{r}.npy"))
        assert recs[r]["hier"] == recs[r]["gpt2"]["losses"]


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("vocab_parallel", [False, True])
def test_shard_rules_are_the_jax_partition_specs(family, vocab_parallel):
    import jax
    from jax.sharding import PartitionSpec

    from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2
    from distributed_lion_tpu.models.llama import LlamaConfig as JLlama
    from distributed_lion_tpu.parallel.tensor_parallel import gpt2_param_specs, llama_param_specs

    specs, rule = ((gpt2_param_specs(JGPT2.tiny(), vocab_parallel), tpar.gpt2_shard_dim)
                   if family == "gpt2" else
                   (llama_param_specs(JLlama.tiny(), vocab_parallel), tpar.llama_shard_dim))
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert leaves
    for path, spec in leaves:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)
        want = next((i for i, p in enumerate(spec) if p == "tensor"), None)
        assert rule(name, vocab_parallel) == want, name
        assert tpar.spec_uses_axis(rule(name, vocab_parallel)) == (want is not None)


@pytest.mark.parametrize("name", list(RUNS) + ["sft"])
def test_replicated_leaves_and_losses_equal_across_tensor_ranks(grid_run, name):
    recs, _, _ = grid_run
    for r, rec in enumerate(recs):
        assert rec[name]["replicated_equal"] == [True] * len(rec[name]["losses"]), (name, r)
        assert rec[name]["losses"] == recs[r - r % TP][name]["losses"], (name, r)


def test_llama_tp_vocab_matches_the_replicated_head(grid_run):
    recs, _, out = grid_run
    for r, rec in enumerate(recs):
        np.testing.assert_allclose(rec["llama_vocab"]["losses"], rec["llama"]["losses"],
                                   atol=1e-5, rtol=0)
    # the whole-model count is the JAX package's; each rank holds less
    rec = recs[0]["llama_vocab"]
    assert rec["n_global"] == recs[0]["llama"]["n_global"] > rec["n_params"]


def test_gpt2_wire_counts_the_whole_model(grid_run):
    """The banner's and ``comm_stats``' count is the whole model's, at the
    data world (JAX's ``count_params`` of global arrays); each rank votes its
    slice."""
    recs, _, _ = grid_run
    rec = recs[0]["gpt2"]
    n_whole = sum(p.numel() for p in GPT2(GPT2Config.tiny(), device="cpu").parameters())
    assert rec["n_global"] == n_whole
    assert rec["n_params"] < n_whole


def _adapter_named(tree: dict, t: int) -> dict:
    """Tensor rank ``t``'s slices of a JAX adapter tree, keyed ``path/A``,
    ``path/B`` as the port's flat names."""
    return {f"{p}/{k}": v for p, ab in adapters_from_jax(
        tree, tp=TP, t=t, base_rule=tpar.llama_shard_dim).items() for k, v in ab.items()}


def test_sft_tp_matches_jax_nf4_base(grid_run):
    """Losses within 1e-5; the adapters ≥ 99.9% bit-equal to JAX's slices
    and within 2·lr·steps everywhere (a flipped election moves a coordinate
    by 2·lr); and the check is not of unmoved factors: B is zero at step 1,
    so A moves only at steps 2 and 3, and most of it did."""
    recs, refs, out = grid_run
    ref = refs["sft"]
    for r, rec in enumerate(recs):
        np.testing.assert_allclose(rec["sft"]["losses"], ref["losses"], atol=1e-5, rtol=0)
        names = rec["sft"]["names"]   # path/A, path/B in the JAX leaf order
        want = _flat(_adapter_named(ref["params"], r % TP), names)
        got = np.load(out / f"sft_params_{r}.npy")
        np.testing.assert_array_equal(got, np.load(out / f"sft_params_{r % TP}.npy"))
        assert np.mean(got == want) >= 0.999, r
        assert np.max(np.abs(got - want)) <= 2 * SFT_LR * SFT_STEPS * (1 + 1e-6), r
        init = _adapter_named(_adapters(str(out)), r % TP)
        is_a = np.concatenate([np.full(init[n].numel(), n.endswith("/A")) for n in names])
        assert np.mean(got[is_a] != _flat(init, names)[is_a]) >= 0.9, r


def test_sft_momentum_matches_jax_exp_avg_after_step_2(grid_run):
    """After step 2 each rank's adapter momentum is JAX's ``exp_avg[data
    rank]`` sliced by the adapter rule, leaf by leaf within 1e-6 of the
    leaf's ``max|m|``; every leaf has a gradient by then, A's included."""
    recs, refs, out = grid_run
    for r in range(WORLD):
        want = adapter_momentum_from_jax(refs["sft"]["mom"], r // TP, tp=TP, t=r % TP,
                                         base_rule=tpar.llama_shard_dim)
        names = recs[r]["sft"]["names"]
        got = np.split(np.load(out / f"sft_mom_{r}.npy"),
                       np.cumsum([want[n].numel() for n in names])[:-1])
        for n, g in zip(names, got):
            w = want[n].reshape(-1).numpy()
            assert g.shape == w.shape and np.abs(w).max() > 0, (n, r)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{n} rank {r}")


def test_nf4_shards_equal_the_slices_of_the_whole_weight(grid_run):
    recs, refs, _ = grid_run
    qbase = refs["sft"]["qbase"]
    for r, rec in enumerate(recs):
        assert rec["sft"]["init_equal"] and all(rec["sft"]["init_equal"]), r
        for path, (codes, absmax) in rec["sft"]["codes"].items():
            leaf = qbase
            for p in path.split("."):
                leaf = leaf[int(p)] if p.isdigit() else leaf[p]
            dim = tpar.llama_shard_dim(path)
            for got, whole in ((codes, leaf.codes), (absmax, leaf.absmax)):
                want = tpar.shard(torch.from_numpy(np.asarray(whole).copy()), dim, TP, r % TP)
                assert torch.equal(torch.tensor(got, dtype=want.dtype), want), (path, r)


def test_dpo_tp_trains(grid_run):
    recs, _, _ = grid_run
    for r, rec in enumerate(recs):
        assert rec["dpo"]["world"] == 2 and len(rec["dpo"]["losses"]) == 2
        assert np.isfinite(rec["dpo"]["losses"]).all() and rec["dpo"]["replicated_equal"]
        assert rec["dpo"]["losses"] == recs[r - r % TP]["dpo"]["losses"]


def test_dcn_pipeline_save_and_resume_at_dp2_tp2(grid_run):
    """``hier:1 --dcn_pipeline_depth 1`` at dp 2 × tp 2: each data group's
    two groups of one vote over a cross leg (every data group's subgroups
    built on every process). A resume from step 2 reproduces the
    uninterrupted run bit for bit, its ring included; the params and the
    momentum files are a data-parallel run's, the ring's a tensor rank's
    each, and the manifest names the tp they resume at."""
    recs, _, out = grid_run
    for rec in recs:
        got = rec["dcn_resume"]
        assert got["resumed_from"] == [3, 4] and got["ring_bytes"] > 0, got
        assert got["params_equal"] and got["momentum_equal"] and got["ring_equal"], got
    step = out / "dcn_a" / "checkpoints" / "2"
    assert sorted(p.relative_to(step).as_posix() for p in step.rglob("*.pt")) == sorted(
        [f"dcn_ring/rank{d:05d}_tensor{t:05d}.pt" for d in range(2) for t in range(TP)]
        + ["exp_avg/rank00000.pt", "exp_avg/rank00001.pt", "params.pt", "state.pt"])
    meta = Checkpointer(str(out / "dcn_a" / "checkpoints")).manifest_meta(2)
    assert (meta["tensor_parallel"], meta["dcn_pipeline_depth"], meta["wire"]) == (2, 1,
                                                                                 "hier:1")


def test_save_and_resume_at_dp2_tp2(grid_run):
    """A resume from step 2 reproduces the uninterrupted run bit for bit on
    every rank; the step's files are a data-parallel run's."""
    recs, _, out = grid_run
    for rec in recs:
        assert rec["resume"]["resumed_from"] == [3, 4]
        assert rec["resume"]["params_equal"] and rec["resume"]["momentum_equal"]
    step = out / "resume_a" / "checkpoints" / "2"
    assert sorted(p.relative_to(step).as_posix() for p in step.rglob("*.pt")) == [
        "exp_avg/rank00000.pt", "exp_avg/rank00001.pt", "params.pt", "state.pt"]
    whole = GPT2(GPT2Config.tiny(), device="cpu").jax_named_parameters()
    params = torch.load(step / "params.pt")
    assert params["names"] == [n for n, _ in whole]
    assert [tuple(s) for s in params["shapes"]] == [tuple(p.shape) for _, p in whole]
    n = sum(p.numel() for _, p in whole)
    assert params["flat"].shape == (n,)
    for r in range(2):
        assert torch.load(step / f"exp_avg/rank{r:05d}.pt").shape == (n,)
    assert torch.load(step / "state.pt")["world"] == 2


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_under_tensor_parallelism(grid_run, name):
    recs, _, _ = grid_run
    _, _, error, match = REFUSALS[name]
    import re

    for rec in recs:
        got = rec["refusals"][name]
        assert got is not None, name
        assert got[0] == error.__name__ and re.search(match, got[1]), got


@pytest.mark.parametrize("case", ["tp_vocab_without_tp", "world_of_one", "quant_misaligned",
                                  "dcn_ring_at_another_tp"])
def test_refusals_in_a_world_of_one(case):
    if case == "dcn_ring_at_another_tp":   # the ring's files are a tensor rank's each
        cfg = TrainConfig(wire="hier:1", dcn_pipeline_depth=1)
        meta = {"dcn_pipeline_depth": 1, "tensor_parallel": 2}
        check_resume_meta(2, meta, cfg, 2)
        with pytest.raises(ValueError, match=r"checkpoint step 2 was written at "
                                             r"--tensor_parallel 2 with a DCN ring, and this "
                                             r"run has --tensor_parallel 1"):
            check_resume_meta(2, meta, cfg, 1)
    elif case == "tp_vocab_without_tp":
        with pytest.raises(ValueError, match=r"--tp_vocab needs --tensor_parallel > 1 \(it "
                                             r"shards the tied embedding"):
            Trainer.for_gpt2(TrainConfig(tp_vocab=True), GPT2Config.tiny(), device="cpu")
    elif case == "world_of_one":
        with pytest.raises(ValueError, match="--tensor_parallel 2 needs 2 ranks"):
            make_grid(2)
    else:   # a shaped leaf whose blocks do not split 2-way at block 64
        tree = quantize_tree({"blocks": [{"attn": {"wq": torch.randn(64, 64)}}]}, "nf4",
                             min_size=16, block=64)
        with pytest.raises(ValueError, match=r"quantized leaf 'blocks/0/attn/wq' last dim 64 "
                                             r"cannot shard 2-way"):
            validate_quant_tp(tree, tpar.llama_shard_dim, TP)


@pytest.mark.parametrize("replicated", [True, False])
def test_the_lazy_refresh_announce_is_for_replicated_params(replicated, capsys):
    """Auto comm names lazy refresh's saving only over replicated params:
    split ones refuse ``--vote_every`` > 1 (JAX loop.py:489-500, 2405-2410)."""
    cfg = resolve_auto_comm(TrainConfig(), 2, 20_000_000, announce=True,
                            params_replicated=replicated)
    assert cfg.vote_every == 1
    assert ("Lazy --vote_every 4 would cut" in capsys.readouterr().out) == replicated
