"""Sequence parallelism (dp × tp × sp) against the JAX package on its CPU mesh.

Four gloo ranks on the CPU form the grids (``parallel.mesh.make_grid``:
global rank ``r = (d·tp + t)·sp + s``); one spawn runs every multi-rank case
(the ``sp_run`` fixture) while the fixture computes the JAX references on
``make_mesh(data=1, seq=4)``, ``make_mesh(data=2, seq=2)`` and
``make_mesh(data=1, tensor=2, seq=2)`` from the same numpy-seeded weights,
batches and q, k, v. The tests compare what both wrote.

- Ring and Ulysses attention at sp 4 against JAX's ``ring_attention`` and
  ``ulysses_attention``: forward within rtol 2e-4, atol 2e-5, the q, k, v
  gradients of ``Σ out²`` within rtol 5e-3, atol 1e-4 (JAX
  ``tests/test_ring_attention.py``'s own); Ulysses refuses a head count
  that does not divide over the axis.
- GPT-2 tiny at float32 compute, 3 steps, weight decay 0, constant LR, on
  ``sign_psum``: ring and Ulysses at dp 2 × sp 2, ring at dp 1 × tp 2 × sp
  2, and Llama tiny (GQA) on the ring at dp 1 × tp 2 × sp 2. Per-step losses within 1e-5 of JAX's; each rank's momentum after step
  1 within 1e-6 of ``max|m|`` of JAX's ``exp_avg[data rank]`` sliced to
  the rank's tensor rank (``momentum_from_jax`` at the rank's ``(tp, t)``,
  its seq index > 0 for half the ranks); the final params ≥ 99.9% bit-equal
  to JAX's slices and within ``2·lr·steps`` everywhere.
- Every other composition the port allows under sp through the entry
  points, each against the same command without ``--seq_parallel`` run by
  both pairs of ranks ({0, 1} and {2, 3}, each a world of two):
  ``run_clm`` GPT-2 (with eval at sp against eval at dp), with
  ``--vocab_chunks``, ``--remat_policy dots``, ``--max_grad_norm``
  (stochastic ballots) and ``packed_a2a``; Llama with ``--vocab_chunks``;
  AdamW; ``--telemetry --vote_guard enforce``; ``--vote_every 4``; the
  control plane (data rank 1 leaves at step 2 and rejoins at 4, both its
  seq ranks with it); the DCN pipeline (``hier:1 --dcn_pipeline_depth
  1``); ``run_sft --packing`` over an NF4 base, at dp 2 and at tp 2, and
  ``run_dpo``, their models at float32 compute and no adapter dropout. Losses within 1e-5 of the dp
  run's, the final params within ``2·lr·steps`` of it and ≥ 99% bit-equal.
- In every run the params and momentum are ``torch.equal`` across the seq
  ranks after every step, and the logged losses equal.
- A save at dp 2 × sp 2 and its resume reproduce an uninterrupted run
  ``torch.equal``; the step's files are a dp run's.
- Every refusal, by message; and in one process, ``remat_policy`` full ≡
  dots ≡ no remat with ``torch.equal`` (float32 and bfloat16, GPT-2 and
  Llama), what ``dots`` saves counted.

This file imports jax only inside the fixture and the tests, so the
spawned ranks import torch alone.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.cli import run_clm, run_dpo, run_sft
from distributed_lion_tpu_torch.data.sources import batch_iterator
from distributed_lion_tpu_torch.models import gpt2 as gpt2_mod
from distributed_lion_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_lion_tpu_torch.models.llama import Llama, LlamaConfig, as_parameters, llama_init
from distributed_lion_tpu_torch.models.loss import clm_loss_and_metrics
from distributed_lion_tpu_torch.parallel.mesh import make_grid
from distributed_lion_tpu_torch.parallel.ring_attention import ring_attention, ulysses_attention
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer, apply_remat_policy
from distributed_lion_tpu_torch.utils.serialization import (
    llama_params_from_jax,
    load_pytree,
    momentum_from_jax,
    params_from_jax,
    state_dict_from_tree,
)

WORLD = 4
LR, STEPS, T = 3e-3, 3, 32
COMMON = dict(lion=True, async_grad=True, learning_rate=LR, weight_decay=0.0,
              lr_scheduler_type="constant", max_steps=STEPS, per_device_train_batch_size=2,
              gradient_accumulation_steps=2, block_size=T, logging_steps=1, eval_steps=1000,
              seed=0, wire="sign_psum")
# name: (tp, sp, seq_impl, family) of the runs held to JAX
JAX_RUNS = {"ring": (1, 2, "ring", "gpt2"), "ulysses": (1, 2, "ulysses", "gpt2"),
            "tp_ring": (2, 2, "ring", "gpt2"), "llama_tp_ring": (2, 2, "ring", "llama")}
QKV = (2, 4, 32, 16)   # B, H, T, hd of the attention check
CLM_ARGV = ["--model_name", "tiny", "--dataset", "synthetic", "--synthetic_blocks", "64",
            "--block_size", "32", "--per_device_train_batch_size", "2",
            "--gradient_accumulation_steps", "1", "--logging_steps", "1", "--dropout", "0",
            "--lr_scheduler_type", "constant", "--learning_rate", "3e-3", "--max_steps", "3",
            "--eval_iters", "1", "--per_device_eval_batch_size", "1", "--compute_dtype",
            "float32", "--wire", "sign_psum"]
LLAMA_ARGV = CLM_ARGV + ["--model_family", "llama", "--vocab_chunks", "4"]
SFT_ARGV = ["--model_name", "tiny", "--quant", "nf4", "--quant_block", "16", "--seq_length", "64",
            "--num_train_samples", "64", "--size_valid_set", "8", "--max_steps", "3",
            "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "1",
            "--logging_steps", "1", "--lora_dropout", "0", "--lr_scheduler_type", "constant",
            "--learning_rate", "1e-3", "--wire", "sign_psum", "--per_device_eval_batch_size",
            "1", "--eval_iters", "1"]
DPO_ARGV = ["--model_name", "tiny", "--max_length", "96", "--max_prompt_length", "48",
            "--num_train_samples", "32", "--size_valid_set", "8", "--max_steps", "3",
            "--per_device_train_batch_size", "1", "--gradient_accumulation_steps", "1",
            "--logging_steps", "1", "--quant_ref", "nf4", "--quant_block", "16",
            "--lora_dropout", "0", "--lr_scheduler_type", "constant", "--learning_rate", "1e-3",
            "--wire", "sign_psum", "--eval_iters", "1", "--per_device_eval_batch_size", "1"]
# name: (entry point, its flags): each run with --seq_parallel 2 at four ranks
# and without it on each pair of ranks (dp 2 x sp 2 against dp 2; with
# --tensor_parallel 2, dp 1 x tp 2 x sp 2 against dp 1 x tp 2)
PINNED = {
    "gpt2": (run_clm, CLM_ARGV),
    "gpt2_chunks": (run_clm, CLM_ARGV + ["--vocab_chunks", "4"]),
    "dots": (run_clm, CLM_ARGV + ["--remat_policy", "dots"]),
    "stochastic": (run_clm, CLM_ARGV + ["--max_grad_norm", "1.0"]),
    "packed_a2a": (run_clm, CLM_ARGV + ["--wire", "packed_a2a"]),
    "llama_chunks": (run_clm, LLAMA_ARGV),
    "adamw": (run_clm, CLM_ARGV + ["--lion", "false", "--async_grad", "false"]),
    "guard": (run_clm, CLM_ARGV + ["--telemetry", "--vote_guard", "enforce"]),
    "vote_every": (run_clm, CLM_ARGV + ["--vote_every", "4", "--max_steps", "5"]),
    "control_plane": (run_clm, CLM_ARGV + ["--control_plane", "--min_quorum", "1",
                                           "--rejoin_probe_steps", "1", "--max_steps", "5",
                                           "--inject_membership",
                                           "worker_drop:1:2,worker_rejoin:1:4"]),
    "dcn": (run_clm, CLM_ARGV + ["--wire", "hier:1", "--dcn_pipeline_depth", "1"]),
    "sft": (run_sft, SFT_ARGV),
    "sft_tp": (run_sft, SFT_ARGV + ["--tensor_parallel", "2"]),
    "dpo": (run_dpo, DPO_ARGV),
}
SP2 = ["--seq_parallel", "2"]
# name: (what it runs, the exception, the message)
REFUSALS = {
    "zero1": ("clm", ["--lion", "false", "--async_grad", "false", "--zero1"], ValueError,
              r"--zero1 is incompatible with a 'seq' mesh axis of size 2"),
    "tp_vocab": ("clm_tp", ["--tp_vocab"], NotImplementedError,
                 r"--tp_vocab under --seq_parallel is not wired; pick one"),
    "block_divisible": ("clm", ["--block_size", "33", "--synthetic_blocks", "8"], ValueError,
                        r"block_size 33 not divisible by seq axis 2"),
    "block_n_ctx": ("gpt2_lib", dict(block_size=256), ValueError,
                    r"seq-parallel block_size 256 \(total tokens across the 2-way seq axis\) "
                    r"exceeds n_ctx 128"),
    "grid_3": ("grid_3", None, ValueError,
               r"--seq_parallel 3 does not divide the world of 4 ranks"),
    "sft_packing": ("sft", ["--packing", "false"], NotImplementedError,
                    r"--seq_parallel needs --packing: padded/masked per-example rows"),
    "sft_length": ("sft", ["--seq_length", "63"], ValueError,
                   r"--seq_length 63 \(after the n_ctx clamp\) must divide evenly over the "
                   r"2-way seq axis"),
    "dpo_tp": ("dpo", ["--tensor_parallel", "2"], NotImplementedError,
               r"--tensor_parallel x --seq_parallel on the DPO path is not wired; pick one"),
    "dpo_length": ("dpo", ["--max_length", "95"], ValueError,
                   r"--max_length 95 \(after the n_ctx clamp\) must divide evenly over the "
                   r"2-way seq axis"),
}


def _f32_llama():
    """``LlamaConfig.named`` at float32 compute while the block runs (the
    CLIs' Llama has no compute-dtype flag)."""
    named = LlamaConfig.__dict__["named"]
    LlamaConfig.named = classmethod(lambda cls, name, **kw: dataclasses.replace(
        named.__func__(cls, name, **kw), compute_dtype=torch.float32))
    return named


# ------------------------------------------------------------ the ranks
def _seq_equal(trainer, tensors) -> bool:
    """``tensors`` equal the seq peers', bit for bit."""
    seq = trainer.seq
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    every = [torch.empty_like(flat) for _ in range(seq.size)]
    dist.all_gather(every, flat, group=seq.group)
    return all(torch.equal(every[0], e) for e in every[1:])


class SeqWatch:
    """Around ``Trainer._train_step``: after every step, whether the params
    and momentum (AdamW's moments) equal the seq peers'; and what
    ``Trainer.evaluate`` returned last."""

    def __init__(self):
        self.equal, self.eval = [], None
        self._orig, self._evaluate = Trainer._train_step, Trainer.evaluate
        watch = self

        def evaluate(trainer, blocks):
            watch.eval = watch._evaluate(trainer, blocks)
            return watch.eval

        def step(trainer, local):
            out = watch._orig(trainer, local)
            if trainer.seq.size > 1:
                st = trainer.state
                mom = [st.exp_avg] if hasattr(st, "exp_avg") else [st.mu, st.nu]
                watch.equal.append(_seq_equal(trainer, [trainer.flat.params, *mom]))
            return out

        Trainer._train_step, Trainer.evaluate = step, evaluate

    def close(self):
        Trainer._train_step, Trainer.evaluate = self._orig, self._evaluate


def _attention_case(grid, out: str) -> dict:
    """Ring and Ulysses on this rank's chunk of JAX's q, k, v: outputs and
    the gradients of ``Σ out²``; Ulysses at 2 heads over 4 ranks."""
    q, k, v = (torch.from_numpy(np.load(f"{out}/{n}.npy")) for n in "qkv")
    s, t = grid.seq.rank, QKV[2] // grid.sp
    rec = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        ql, kl, vl = (x[:, :, s * t:(s + 1) * t].clone().requires_grad_() for x in (q, k, v))
        o = fn(ql, kl, vl, grid.seq)
        (o.to(torch.float32) ** 2).sum().backward()
        for key, val in (("out", o), ("dq", ql.grad), ("dk", kl.grad), ("dv", vl.grad)):
            np.save(f"{out}/attn_{name}_{key}_{s}.npy", val.detach().numpy())
    try:
        ulysses_attention(*(x[:, :2, s * t:(s + 1) * t] for x in (q, k, v)), grid.seq)
        rec["bad_heads"] = None
    except ValueError as e:
        rec["bad_heads"] = str(e)
    return rec


def _train_steps(trainer, blocks, out: str, name: str, rank: int) -> dict:
    """Train one step at a time: the momentum after step 1, the seq ranks'
    equality after every step, the final params."""
    steps = trainer.cfg.max_steps
    it = batch_iterator(blocks, trainer.global_train_batch(), seed=0)
    equal = []
    for k in range(1, steps + 1):
        trainer.cfg.max_steps = k
        trainer.train(it)
        if k == 1:
            np.save(f"{out}/{name}_mom_{rank}.npy", trainer.state.exp_avg.numpy())
        equal.append(_seq_equal(trainer, [trainer.flat.params, trainer.state.exp_avg]))
    np.save(f"{out}/{name}_params_{rank}.npy", trainer.flat.params.detach().numpy())
    rec = {"losses": [h["loss"] for h in trainer.history if "loss" in h], "seq_equal": equal,
           "names": trainer.flat.names}
    trainer.close()
    return rec


def _jax_case(out: str, name: str, rank: int) -> dict:
    tp, sp, impl, family = JAX_RUNS[name]
    grid = make_grid(tp, sp=sp)
    cfg = TrainConfig(**COMMON, tensor_parallel=tp, seq_parallel=sp)
    init = load_pytree(f"{out}/{family}_init.npz")
    if family == "gpt2":
        mcfg = GPT2Config.tiny(dropout=0.0, seq_impl=impl, compute_dtype=torch.float32)
        trainer = Trainer.for_gpt2(cfg, mcfg, device="cpu", grid=grid,
                                   initial_params=params_from_jax(init))
    else:
        mcfg = LlamaConfig.tiny(seq_impl=impl, compute_dtype=torch.float32)
        trainer = Trainer.for_llama(cfg, mcfg, device="cpu", grid=grid,
                                    initial_params=llama_params_from_jax(init))
    rec = _train_steps(trainer, np.load(f"{out}/blocks.npy"), out, name, rank)
    rec["grid"] = [grid.data_rank, grid.tensor.rank, grid.seq.rank]
    return rec


def _run_cli(module, argv: list, group=None):
    """``module.main(argv)`` under a :class:`SeqWatch`; with ``group`` the
    run's world is that group (a data group of two) in place of every rank."""
    watch = SeqWatch()
    orig = module.init_distributed
    if group is not None:
        module.init_distributed = lambda device: group
    try:
        out = module.main(argv)
    finally:
        module.init_distributed = orig
        watch.close()
    trainer = out[0] if isinstance(out, tuple) else out
    rows = [h for h in trainer.history if "loss" in h]
    ev = watch.eval
    return trainer, {"losses": [r["loss"] for r in rows], "seq_equal": watch.equal,
                     "world": trainer.world, "sp": trainer.seq.size,
                     "eval": None if ev is None else [ev["eval/loss"], ev.get("eval/accuracy")],
                     "vote": [{k: r[k] for k in r if k.startswith("vote/")} for r in rows],
                     "mask": [r.get("guard_healthy_mask") for r in rows]}


def _pinned_cases(pair, out: str, rank: int) -> dict:
    """Each PINNED command at dp 2 x sp 2, then at dp 2 on each pair."""
    recs = {}
    for name, (module, argv) in PINNED.items():
        trainer, sp = _run_cli(module, argv + SP2)
        np.save(f"{out}/pin_{name}_sp_{rank}.npy", trainer.flat.params.detach().numpy())
        trainer, dp = _run_cli(module, argv, group=pair)
        if rank < 2:   # pair {0, 1}: data ranks 0 and 1
            np.save(f"{out}/pin_{name}_dp_{rank}.npy", trainer.flat.params.detach().numpy())
        recs[name] = {"sp": sp, "dp": dp}
    return recs


def _resume_case(out: str) -> dict:
    """A save at step 2 and its resume to 4 against an uninterrupted run."""
    argv = CLM_ARGV + SP2
    a, b = f"{out}/resume_a", f"{out}/resume_b"
    run_clm.main(argv + ["--output_dir", a, "--save_steps", "2", "--max_steps", "2"])
    resumed = run_clm.main(argv + ["--output_dir", a, "--save_steps", "2", "--max_steps", "4"])
    straight = run_clm.main(argv + ["--output_dir", b, "--save_steps", "1000",
                                    "--max_steps", "4"])
    return {"resumed_from": [h["step"] for h in resumed.history if "loss" in h],
            "params_equal": torch.equal(resumed.flat.params, straight.flat.params),
            "momentum_equal": torch.equal(resumed.state.exp_avg, straight.state.exp_avg)}


def _refusals(out: str) -> dict:
    got = {}
    for name, (kind, flags, _, _) in REFUSALS.items():
        try:
            if kind == "grid_3":
                make_grid(1, sp=3)
            elif kind == "gpt2_lib":
                cfg = TrainConfig(**(COMMON | dict(seq_parallel=2) | flags))
                Trainer.for_gpt2(cfg, GPT2Config.tiny(), device="cpu",
                                 grid=make_grid(1, sp=2)).close()
            elif kind == "clm_tp":
                run_clm.main(CLM_ARGV + ["--vocab_pad_multiple", "64", "--tensor_parallel", "2",
                                         *SP2, *flags])
            elif kind == "clm":
                run_clm.main(CLM_ARGV + SP2 + flags)
            elif kind == "sft":
                run_sft.main(SFT_ARGV + SP2 + flags)
            else:
                run_dpo.main(DPO_ARGV + SP2 + flags)
            got[name] = None
        except Exception as e:  # noqa: BLE001 - the message is what is held
            got[name] = [type(e).__name__, str(e)]
    return got


def _rank(rank: int, out: str) -> None:
    os.environ["DLION_PLATFORM"] = "cpu"
    dist.init_process_group("gloo", init_method=f"file://{out}/pg", rank=rank,
                            world_size=WORLD)
    torch.set_num_threads(1)
    named = _f32_llama()
    try:
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        rec = {"attention": _attention_case(make_grid(1, sp=4), out)}
        for name in JAX_RUNS:
            rec[name] = _jax_case(out, name, rank)
        rec["pinned"] = _pinned_cases(pairs[rank // 2], out, rank)
        rec["resume"] = _resume_case(out)
        rec["refusals"] = _refusals(out)
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(rec, f)
    finally:
        LlamaConfig.named = named
        dist.destroy_process_group()


# ------------------------------------------------------- the JAX side
def _jax_inputs(out: str) -> None:
    """Weights, batches and q, k, v, numpy-seeded through the JAX package."""
    import jax

    from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2
    from distributed_lion_tpu.models.gpt2 import gpt2_init
    from distributed_lion_tpu.models.llama import LlamaConfig as JLlama
    from distributed_lion_tpu.models.llama import llama_init as j_llama_init
    from distributed_lion_tpu.utils.serialization import save_pytree as j_save

    j_save(f"{out}/gpt2_init.npz", jax.tree.map(np.asarray, gpt2_init(jax.random.key(0),
                                                                      JGPT2.tiny())))
    j_save(f"{out}/llama_init.npz", jax.tree.map(np.asarray, j_llama_init(jax.random.key(0),
                                                                         JLlama.tiny())))
    np.save(f"{out}/blocks.npy", j_synthetic(256, T, 256))
    rng = np.random.default_rng(0)
    for n in "qkv":
        np.save(f"{out}/{n}.npy", rng.normal(size=QKV).astype(np.float32))


def _jax_references(out: str) -> dict:
    """JAX's ring and Ulysses at seq 4 (outputs and gradients of Σ out²),
    and the GPT-2 trainers at each JAX_RUNS mesh: losses, the stacked
    momentum after step 1, the final params."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.data.sources import batch_iterator as j_batches
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2
    from distributed_lion_tpu.models.llama import LlamaConfig as JLlama
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.parallel.mesh import SEQ_AXIS
    from distributed_lion_tpu.parallel.ring_attention import (
        ring_attention as j_ring,
        ulysses_attention as j_ulysses,
    )
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer
    from distributed_lion_tpu.utils.serialization import load_pytree as j_load

    refs: dict = {"attention": {}}
    mesh = make_mesh(data=1, seq=4, devices=jax.devices()[:4])
    q, k, v = (jnp.asarray(np.load(f"{out}/{n}.npy")) for n in "qkv")
    spec = P(None, None, SEQ_AXIS)
    for name, fn in (("ring", j_ring), ("ulysses", j_ulysses)):
        def apply(q, k, v, fn=fn):
            return jax.shard_map(lambda a, b, c: fn(a, b, c, SEQ_AXIS), mesh=mesh,
                                 in_specs=(spec,) * 3, out_specs=spec, check_vma=False)(q, k, v)

        o = jax.jit(apply)(q, k, v)
        grads = jax.jit(jax.grad(lambda q, k, v: (apply(q, k, v) ** 2).sum(),
                                 argnums=(0, 1, 2)))(q, k, v)
        refs["attention"][name] = dict(zip(("out", "dq", "dk", "dv"),
                                           (np.asarray(x) for x in (o, *grads))))
    blocks = np.load(f"{out}/blocks.npy")
    for name, (tp, sp, impl, family) in JAX_RUNS.items():
        mesh = make_mesh(data=WORLD // (tp * sp), tensor=tp, seq=sp, devices=jax.devices()[:4])
        cfg = JTrainConfig(**COMMON, tensor_parallel=tp)
        init = j_load(f"{out}/{family}_init.npz")
        if family == "gpt2":
            jtr = JTrainer.for_gpt2(cfg, mesh, JGPT2.tiny(compute_dtype=jnp.float32,
                                                          dropout=0.0, seq_impl=impl),
                                    initial_params=init)
        else:
            jtr = JTrainer.for_llama(cfg, mesh, JLlama.tiny(compute_dtype=jnp.float32,
                                                            seq_impl=impl),
                                     initial_params=init)
        it = j_batches(blocks, jtr.global_train_batch(), seed=0)
        hist = jtr.train(it, max_steps=1)
        mom = jax.tree.map(np.asarray, jtr.state.exp_avg)
        hist += jtr.train(it, max_steps=STEPS - 1)
        refs[name] = {"losses": [h["loss"] for h in hist if "loss" in h], "mom": mom,
                      "params": jax.tree.map(np.asarray, jtr.params)}
        jtr.close()
    return refs


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    """Start the four ranks, compute the JAX references meanwhile, then wait
    for the ranks: ``(their records, the JAX references, the directory)``."""
    out = tmp_path_factory.mktemp("sp")
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


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_attention_matches_jax_at_sp4(sp_run, impl):
    _, refs, out = sp_run
    ref = refs["attention"][impl]
    t = QKV[2] // WORLD
    for key, (rtol, atol) in (("out", (2e-4, 2e-5)), ("dq", (5e-3, 1e-4)),
                              ("dk", (5e-3, 1e-4)), ("dv", (5e-3, 1e-4))):
        got = np.concatenate([np.load(out / f"attn_{impl}_{key}_{s}.npy") for s in range(WORLD)],
                             axis=2)
        np.testing.assert_allclose(got, ref[key], rtol=rtol, atol=atol, err_msg=key)
        assert got.shape[2] == WORLD * t


def test_ulysses_refuses_a_head_count_off_the_axis(sp_run):
    recs, _, _ = sp_run
    for rec in recs:
        assert rec["attention"]["bad_heads"] == "n_heads 2 not divisible by seq axis size 4"


def test_grid_layout(sp_run):
    """Rank r = (d·tp + t)·sp + s."""
    recs, _, _ = sp_run
    assert [r["ring"]["grid"] for r in recs] == [[r // 2, 0, r % 2] for r in range(WORLD)]
    assert [r["tp_ring"]["grid"] for r in recs] == [[0, r // 2, r % 2] for r in range(WORLD)]
    assert [r["llama_tp_ring"]["grid"] for r in recs] == [r["tp_ring"]["grid"] for r in recs]


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_losses_match_jax(sp_run, name):
    recs, refs, _ = sp_run
    for rec in recs:
        assert len(rec[name]["losses"]) == STEPS
        np.testing.assert_allclose(rec[name]["losses"], refs[name]["losses"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_momentum_matches_jax_exp_avg(sp_run, name):
    """After step 1 each rank's momentum is JAX's ``exp_avg[data rank]``
    sliced to its tensor rank; the converters take the rank's ``(tp, t)``
    whatever its seq index."""
    recs, refs, out = sp_run
    tp, sp, _, family = JAX_RUNS[name]
    for r in range(WORLD):
        d, t, s = recs[r][name]["grid"]
        want = _flat(momentum_from_jax(refs[name]["mom"], d, tp, t, family=family),
                     recs[r][name]["names"])
        got = np.load(out / f"{name}_mom_{r}.npy")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_elections_match_jax(sp_run, name):
    """The final params ≥ 99.9% bit-equal to JAX's slices, within 2·lr·steps."""
    recs, refs, out = sp_run
    tp, _, _, family = JAX_RUNS[name]
    for r in range(WORLD):
        _, t, _ = recs[r][name]["grid"]
        got = np.load(out / f"{name}_params_{r}.npy")
        tree = refs[name]["params"]
        want = _flat(params_from_jax(tree, tp, t) if family == "gpt2" else
                     state_dict_from_tree(llama_params_from_jax(tree, tp=tp, t=t)),
                     recs[r][name]["names"])
        assert np.mean(got == want) >= 0.999, (name, r)
        assert np.max(np.abs(got - want)) <= 2 * LR * STEPS * (1 + 1e-6), (name, r)


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_seq_ranks_hold_the_same_bits(sp_run, name):
    recs, _, _ = sp_run
    for r, rec in enumerate(recs):
        assert rec[name]["seq_equal"] == [True] * STEPS, (name, r)
        assert rec[name]["losses"] == recs[r - r % 2][name]["losses"], (name, r)


@pytest.mark.parametrize("name", list(PINNED))
def test_pinned_to_the_dp_run(sp_run, name):
    """The command with --seq_parallel 2 against itself without it on a pair
    of ranks: the same data world, losses within 1e-5, params within
    2·lr·steps and ≥ 99% bit-equal (a flipped election moves a coordinate by
    2·lr); AdamW's within 1e-4, its step lr·m̂/(√v̂ + ε) moving by rounding
    except where g ≈ 0; the seq ranks' params and momentum equal after
    every step. Rank r holds data rank r // 2 (or, at tp 2, tensor rank
    r // 2): the pair's rank r // 2."""
    recs, _, out = sp_run
    lr = 1e-3 if name in ("sft", "dpo") else LR
    for r, rec in enumerate(recs):
        sp, dp = rec["pinned"][name]["sp"], rec["pinned"][name]["dp"]
        steps = len(dp["losses"])
        assert (sp["world"], sp["sp"], dp["sp"]) == (dp["world"], 2, 1), name
        assert len(sp["losses"]) == steps > 0 and sp["seq_equal"] == [True] * steps, (name, r)
        np.testing.assert_allclose(sp["losses"], dp["losses"], atol=1e-5, rtol=0)
        got = np.load(out / f"pin_{name}_sp_{r}.npy")
        want = np.load(out / f"pin_{name}_dp_{r // 2}.npy")
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= 2 * lr * steps * (1 + 1e-6), (name, r)
        if name == "adamw":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        else:
            assert np.mean(got == want) >= 0.99, (name, r)


def test_eval_at_sp_equals_eval_at_dp(sp_run):
    recs, _, _ = sp_run
    for rec in recs:
        sp, dp = rec["pinned"]["gpt2"]["sp"]["eval"], rec["pinned"]["gpt2"]["dp"]["eval"]
        assert sp is not None and dp is not None
        np.testing.assert_allclose(sp[0], dp[0], atol=1e-5, rtol=0)
        assert sp[1] == dp[1]


def test_guard_and_telemetry_under_sp(sp_run):
    """Telemetry's vote health and the guard's masks of the sp run are the
    dp run's, and the same on both seq ranks."""
    recs, _, _ = sp_run
    for r, rec in enumerate(recs):
        sp, dp = rec["pinned"]["guard"]["sp"], rec["pinned"]["guard"]["dp"]
        assert sp["vote"] and sp["vote"] == recs[r - r % 2]["pinned"]["guard"]["sp"]["vote"]
        assert [v["vote/hist_mass"] for v in sp["vote"]] == [1.0] * STEPS
        for a, b in zip(sp["vote"], dp["vote"]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_allclose(a[k], b[k], atol=1e-3, err_msg=k)
        assert sp["mask"] == dp["mask"] == [[True, True]] * STEPS


def test_control_plane_moves_a_data_rank_with_its_seq_ranks(sp_run):
    """Data rank 1 (global ranks 2 and 3) leaves at step 2 and rejoins at 4
    on both seq ranks, as in the dp run."""
    recs, _, _ = sp_run
    for rec in recs:
        sp, dp = rec["pinned"]["control_plane"]["sp"], rec["pinned"]["control_plane"]["dp"]
        assert sp["mask"] == dp["mask"]
        assert [False] in [m[1:] for m in sp["mask"]] and sp["mask"][-1] == [True, True]


def test_save_and_resume_at_dp2_sp2(sp_run):
    """A resume from step 2 reproduces the uninterrupted run bit for bit on
    every rank; the step's files are a dp run's, written by seq rank 0."""
    recs, _, out = sp_run
    for rec in recs:
        assert rec["resume"]["resumed_from"] == [3, 4]
        assert rec["resume"]["params_equal"] and rec["resume"]["momentum_equal"]
    step = out / "resume_a" / "checkpoints" / "2"
    assert sorted(p.relative_to(step).as_posix() for p in step.rglob("*.pt")) == [
        "exp_avg/rank00000.pt", "exp_avg/rank00001.pt", "params.pt", "state.pt"]
    whole = GPT2(GPT2Config.tiny(), device="cpu").jax_named_parameters()
    n = sum(p.numel() for _, p in whole)
    params = torch.load(step / "params.pt")
    assert params["names"] == [name for name, _ in whole] and params["flat"].shape == (n,)
    assert torch.load(step / "state.pt")["world"] == 2


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_under_sequence_parallelism(sp_run, name):
    recs, _, _ = sp_run
    _, _, error, match = REFUSALS[name]
    for rec in recs:
        got = rec["refusals"][name]
        assert got is not None, name
        assert got[0] == error.__name__ and re.search(match, got[1]), got


# ------------------------------------------------------- one process
def test_a_seq_axis_needs_its_ranks():
    with pytest.raises(ValueError, match="--seq_parallel 2 needs 2 ranks"):
        make_grid(1, sp=2)
    with pytest.raises(ValueError, match=r"--seq_parallel 2 but the grid's seq axis is 1"):
        Trainer.for_gpt2(TrainConfig(seq_parallel=2), GPT2Config.tiny(), device="cpu")


@pytest.mark.parametrize("case", ["unknown", "remat_off", "config"])
def test_remat_policy_refusals(case):
    if case == "unknown":
        with pytest.raises(ValueError, match=r"unknown remat_policy 'some' \(full \| dots\)"):
            apply_remat_policy(TrainConfig(remat_policy="some"), GPT2Config.tiny())
    elif case == "remat_off":
        with pytest.raises(ValueError, match="TrainConfig.remat_policy set but the model config "
                                             "has remat=False"):
            apply_remat_policy(TrainConfig(remat_policy="dots"), GPT2Config.tiny(remat=False))
    else:
        with pytest.raises(ValueError, match=r"unknown remat_policy 'some'"):
            LlamaConfig.tiny(remat_policy="some")
    assert apply_remat_policy(TrainConfig(), GPT2Config.tiny()).remat_policy == "full"
    assert apply_remat_policy(TrainConfig(remat_policy="dots"),
                              GPT2Config.tiny()).remat_policy == "dots"


def _grads(family: str, dtype, policy: str, saved: list):
    """The gradients of one GPT-2 (dropout 0.1) or Llama loss under
    ``policy`` (``none``: no remat); ``saved`` collects what dots keeps."""
    remat = policy != "none"
    pol = "full" if policy == "none" else policy
    tokens = torch.randint(0, 256, (2, 32), generator=torch.Generator().manual_seed(1))
    if family == "gpt2":
        cfg = GPT2Config.tiny(compute_dtype=dtype, remat=remat, remat_policy=pol, dropout=0.1)
        model = GPT2(cfg, device="cpu", seed=0)
        logits, params = model(tokens, 7), list(model.parameters())
    else:
        cfg = LlamaConfig.tiny(compute_dtype=dtype, remat=remat, remat_policy=pol)
        tree = as_parameters(llama_init(cfg, seed=0, device="cpu"))
        model = Llama(cfg, tree)
        logits, params = model(tokens), [p for _, p in model.jax_named_parameters()]
    loss, _ = clm_loss_and_metrics(logits, tokens)
    loss.backward()
    return [p.grad for p in params]


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_policies_give_the_same_bits(family, dtype, monkeypatch):
    """full ≡ dots ≡ no remat, ``torch.equal`` (no fusion barrier moves a
    rounding here), and dots keeps exactly the projections' products: 4 a
    GPT-2 block (qkv, proj, fc, proj), 7 a Llama block (wq, wk, wv, wo,
    w_gate, w_up, w_down), each ``aten.mm``; the attention's batched
    products are recomputed."""
    saved: list = []
    orig = gpt2_mod._dots_policy

    def counting(ctx, op, *args, **kwargs):
        decision = orig(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            saved.append((str(op), decision == gpt2_mod.CheckpointPolicy.MUST_SAVE))
        return decision

    monkeypatch.setattr(gpt2_mod, "_dots_policy", counting)
    runs = {p: _grads(family, dtype, p, saved) for p in ("none", "full", "dots")}
    for a, b, c in zip(runs["none"], runs["full"], runs["dots"]):
        assert torch.equal(a, b) and torch.equal(b, c)
    kept = [op for op, must in saved if must]
    per_block = 4 if family == "gpt2" else 7
    assert kept == ["aten.mm.default"] * (per_block * 2)
    assert any(op.startswith("aten.bmm") for op, must in saved if not must)
