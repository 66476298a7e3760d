"""Pipeline parallelism (dp × tp × sp × pp) and the standalone optimizer step against the JAX package on its CPU mesh.

Four gloo ranks on the CPU form the grids (``parallel.mesh.make_grid``:
global rank ``r = (((d·tp + t)·sp + s)·pp + p)·ep + e``); one spawn runs
every multi-rank case (the ``pipe_run`` fixture), its process group under a
120 s timeout so that a hop made out of order fails the run instead of
hanging it, while the fixture computes the JAX references from the same
numpy-seeded inputs. The tests compare what both wrote.

- ``pipeline_apply`` at pipe 4 (stages 1 and 2 in the middle): 8 layers of
  ``x + tanh(x·w + b)``, 8 microbatches; the last stage's outputs against
  JAX's ``pipeline_apply`` under ``shard_map`` (every other stage's zeros),
  and the gradients of a squared error through ``GPipe``'s backward (each
  stage's layers' and the input's) against ``jax.grad`` through JAX's
  (``tests/test_pipeline.py:76, 105``), within 1e-5.
- One step of the sp × pp loss (``models.loss.pipelined_seq_parallel_loss``)
  of GPT-2 tiny (4 layers, float32) at seq 2 × pipe 2: the loss and the
  gradient (summed over seq, the replicated leaves over pipe, as the
  trainers do) against ``jax.value_and_grad`` of JAX's ``make_pipeline_loss(
  seq_axis=...)`` under ``shard_map`` with the JAX train loop's reductions,
  within 1e-5 of the largest, once JAX's factor pp is taken out. The JAX
  pipeline's gradient is pp times its loss's: each stage's loss is the
  ``psum`` over the pipe axis of the last stage's, and under
  ``check_vma=False`` (its train step's setting) the ``psum``'s transpose
  sums every stage's unit cotangent. The port's gradient is the loss's
  (``chip_smoke.py`` holds it to the unsplit model's). Lion's elections are
  signs and see no uniform factor; at pp 2 the scaling is exact in floating
  point, so the elections stay bit-equal and the momenta differ by exactly
  the factor (ROADMAP Queue 3).
- ``optim.sharded.make_sharded_step`` on each rank pair's data group of two
  against JAX's ``make_sharded_step`` on ``make_mesh(data=2)`` (its XLA
  path: ``kernel='auto'`` on the CPU), 3 steps at weight decay 0: params
  bit-equal after every step (every election the same), the momentum within
  one float32 ulp of its largest (XLA contracts the update into an FMA).
- The trainers at float32 compute, weight decay 0, constant LR, on
  ``sign_psum``, 3 steps at T 32 (JAX without remat, the port with it):
  GPT-2 tiny (4 layers) at dp 2 × pp 2, B 4 × accumulation 2, 4 microbatches,
  against ``Trainer.for_gpt2`` on ``make_mesh(data=2, pipe=2)``; Llama tiny (4
  layers) at dp 1 × tp 2 × pp 2 with ``vocab_chunks`` 4, B 2 × 2, against
  ``Trainer.for_llama`` on ``make_mesh(data=1, tensor=2, pipe=2)``. Losses
  within 1e-5; each rank's momentum after step 1, times pp (JAX's factor,
  above), within 1e-6 of the largest of JAX's ``exp_avg[data rank]`` in its
  pipeline layout, cut to the rank's stage and tensor slice
  (``utils.serialization.pipeline_momentum_from_jax``), and its signs (step
  1's ballots, the elections' inputs) equal wherever JAX's exceeds 1e-9 of
  its largest; the final params equal JAX's on at least 99.99% of the
  coordinates outside GPT-2's key bias and every one within 2·lr·steps. The
  key bias's gradient is zero in exact arithmetic (softmax ignores a shift
  of a query's scores), so its step-1 ballots are the signs of float noise
  (|m| ~ 1e-13 against a largest ~ 4e-3) in both frameworks; the shifted
  key bias then moves the next steps' products by rounding, and a handful of
  later ballots whose input is that small flip with it (7 of 124,544 GPT-2
  coordinates at 3 steps in the run this was measured on). The replicated
  leaves are ``torch.equal`` across the pipe ranks after every step.
- ``run_clm --pipeline_parallel 2``, each composition held to the same CLI
  without the pipe axis at the same data world (dp × pp ≡ dp, pp × tp ≡ one
  rank, pp × sp ≡ one rank), GPT-2 and Llama: losses and eval loss within
  1e-5, at least 99.9% of the whole model's coordinates bit-equal and every
  one within 2·lr·steps (the tensor and seq splits round in another order).
- A checkpoint at dp 2 × pp 2, and one at dp 1 × tp 2 × pp 2 (JAX's pin),
  resumed to step 4 ``torch.equal`` to the uninterrupted run; its files each
  stage's, whole over the tensor axis; ``model.npz`` the whole model.
- Every refusal on this path, in the JAX package's words.

This file imports jax only inside the fixture and the tests, so the spawned
ranks import torch alone.
"""

import json
import os
import re
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.cli import run_clm
from distributed_lion_tpu_torch.data.sources import batch_iterator
from distributed_lion_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_lion_tpu_torch.models.gpt2_pipe import GPT2Stage, make_pipeline_loss
from distributed_lion_tpu_torch.models.llama import LlamaConfig
from distributed_lion_tpu_torch.optim.distributed_lion import distributed_lion
from distributed_lion_tpu_torch.optim.lion import FlatParams
from distributed_lion_tpu_torch.optim.sharded import make_sharded_step, shard_state, state_specs
from distributed_lion_tpu_torch.parallel.mesh import DATA_AXIS, make_grid
from distributed_lion_tpu_torch.parallel.pipeline import (
    GPipe,
    bubble_fraction,
    from_microbatches,
    pipeline_apply,
    stack_stage_params,
    stage_layers,
    to_microbatches,
    unstack_stage_params,
)
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.utils.serialization import (
    llama_params_from_jax,
    load_pytree,
    params_from_jax,
    pipeline_momentum_from_jax,
    pipeline_params_from_jax,
    pipeline_params_to_jax,
    state_dict_from_tree,
)

WORLD = 4
LR, STEPS, T, LAYERS = 3e-3, 3, 32, 4
PP = 2   # the pipe axis of the trainers and of the sp x pp step: JAX's gradient factor
COMMON = dict(lion=True, async_grad=True, learning_rate=LR, weight_decay=0.0,
              lr_scheduler_type="constant", max_steps=STEPS, gradient_accumulation_steps=2,
              block_size=T, logging_steps=1, eval_steps=1000, seed=0, wire="sign_psum",
              per_device_eval_batch_size=4)
# name: (family, tp, TrainConfig fields) of the trainers held to JAX
JAX_RUNS = {"gpt2": ("gpt2", 1, dict(per_device_train_batch_size=4, pipeline_microbatches=4)),
            "llama": ("llama", 2, dict(per_device_train_batch_size=2, vocab_chunks=4))}
APPLY = dict(layers=8, d=6, micro=8, mb=2)   # pipeline_apply's case at pipe 4
CLM_ARGV = ["--model_name", "tiny", "--dataset", "synthetic", "--synthetic_blocks", "96",
            "--block_size", "32", "--per_device_train_batch_size", "2",
            "--gradient_accumulation_steps", "1", "--logging_steps", "1", "--dropout", "0",
            "--lr_scheduler_type", "constant", "--learning_rate", "1e-3", "--eval_iters", "1",
            "--per_device_eval_batch_size", "2", "--compute_dtype", "float32", "--wire",
            "sign_psum", "--max_steps", "3", "--eval_steps", "3"]
PP2 = ["--pipeline_parallel", "2"]
LLAMA = ["--model_family", "llama"]
# name: (the run at 4 ranks, the flags of its reference, its reference's world: pair | one)
PINS = {"gpt2_dp_pp": (PP2, [], "pair"),
        "gpt2_tp_pp": (PP2 + ["--tensor_parallel", "2"], [], "one"),
        "gpt2_sp_pp": (PP2 + ["--seq_parallel", "2"], [], "one"),
        "llama_dp_pp": (LLAMA + PP2, LLAMA, "pair"),
        "llama_sp_pp": (LLAMA + PP2 + ["--seq_parallel", "2", "--vocab_chunks", "4"],
                        LLAMA + ["--vocab_chunks", "4"], "one")}
# name: the flags of a run saved at step 2 and resumed to 4 (JAX pins tp x pp's:
# tests/test_pipeline_train.py:293)
RESUMES = {"dp_pp": PP2 + ["--save_steps", "2"],
           "tp_pp": PP2 + ["--tensor_parallel", "2", "--save_steps", "2"]}
# name: (what it runs, its flags, the exception, the message)
REFUSALS = {
    "expert_axis": ("clm", PP2 + ["--expert_parallel", "2", "--moe_experts", "4"],
                    NotImplementedError,
                    r"pipeline parallelism composes with data, tensor and sequence parallelism "
                    r"\(dp x tp x sp x pp\); an expert axis alongside pipe is not wired"),
    "moe": ("clm", PP2 + ["--moe_experts", "4"], NotImplementedError,
            r"MoE blocks under pipeline parallelism are not wired \(mixed dense/MoE stage "
            r"structures\); drop one of the two"),
    "tp_vocab": ("clm", PP2 + ["--tensor_parallel", "2", "--tp_vocab", "--vocab_pad_multiple",
                               "64"], NotImplementedError,
                 r"--tp_vocab under --pipeline_parallel is not wired \(the pipeline loss "
                 r"carries its own replicated head\); drop one"),
    "llama_tp_vocab": ("clm", LLAMA + PP2 + ["--tensor_parallel", "2", "--tp_vocab"],
                       NotImplementedError, r"--tp_vocab under --pipeline_parallel is not wired"),
    "vote_every": ("clm", PP2 + ["--vote_every", "4"], ValueError,
                   r"--vote_every > 1 is incompatible with params sharded over \['pipe'\]"),
    "telemetry": ("clm", PP2 + ["--telemetry"], ValueError,
                  r"--telemetry is incompatible with params sharded over \['pipe'\]"),
    "vote_guard": ("clm", PP2 + ["--tensor_parallel", "2", "--vote_guard", "enforce"],
                   ValueError,
                   r"--vote_guard is incompatible with params sharded over \['pipe', 'tensor'\]"),
    "adamw": ("clm", PP2 + ["--lion", "false", "--async_grad", "false"], NotImplementedError,
              r"tensor-parallel param_specs require the Lion path"),
    "zero1": ("clm", PP2 + ["--lion", "false", "--async_grad", "false", "--zero1"],
              NotImplementedError, r"tensor-parallel param_specs require the Lion path"),
    "zero1_seq": ("clm", PP2 + ["--seq_parallel", "2", "--lion", "false", "--async_grad",
                                "false", "--zero1"], ValueError,
                  r"--zero1 is incompatible with a 'seq' mesh axis of size 2"),
    "dropout": ("clm", PP2 + ["--dropout", "0.1"], ValueError,
                r"dropout is unsupported under pipeline parallelism \(per-microbatch keys would "
                r"need schedule-aware plumbing\); set --dropout 0"),
    "layers": ("clm", ["--pipeline_parallel", "4"], ValueError,
               r"n_layer 2 not divisible by pipeline stages 4"),
    "llama_layers": ("clm", LLAMA + ["--pipeline_parallel", "4"], ValueError,
                     r"n_layer 2 not divisible by pipeline stages 4"),
    "train_batch": ("clm", PP2 + ["--per_device_train_batch_size", "3"], ValueError,
                    r"per_device_train_batch_size 3 not divisible by pipeline_microbatches 2"),
    "eval_batch": ("clm", PP2 + ["--pipeline_microbatches", "4", "--per_device_train_batch_size",
                                 "4", "--per_device_eval_batch_size", "2"], ValueError,
                   r"per_device_eval_batch_size 2 not divisible by pipeline_microbatches 4"),
    "other_pp": ("resumed", [], ValueError,
                 r"checkpoint step 4 was written at --pipeline_parallel 2, and this run has "
                 r"--pipeline_parallel 1"),
    "grid_3": ("grid_3", None, ValueError,
               r"--pipeline_parallel 3 does not divide the world of 4 ranks"),
}


def _layer(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def _apply_with_grads(layers: list, x: torch.Tensor, pipe, loss_fn):
    """:func:`pipeline_apply`'s forward through :class:`GPipe` and its
    backward from ``loss_fn`` of the last stage's stacked outputs, into
    ``layers``' and ``x``'s ``.grad``; the loss on the last stage, None
    elsewhere."""
    def stage_fn(h):
        for p in layers:
            h = _layer(p, h)
        return h

    run = GPipe(stage_fn, pipe, x.shape[0])
    outs = run.forward(lambda i: x[i], (tuple(x.shape[1:]), x.dtype, x.device))
    loss = grads = None
    if outs is not None:
        loss = loss_fn(torch.stack(outs))
        grads = torch.autograd.grad(loss, outs)
    run.backward(grads)
    return None if loss is None else loss.detach()


# ------------------------------------------------------------ the ranks
def _apply_case(out: str) -> None:
    """``pipeline_apply`` and its backward at pipe 4 (dp 1): each rank
    writes its stage's outputs and gradients."""
    grid = make_grid(1, pp=4)
    w, b = np.load(f"{out}/apply_w.npy"), np.load(f"{out}/apply_b.npy")
    mine = [{"w": torch.from_numpy(w[i]).requires_grad_(),
             "b": torch.from_numpy(b[i]).requires_grad_()}
            for i in stage_layers(APPLY["layers"], grid.pipe)]
    xm = to_microbatches(torch.from_numpy(np.load(f"{out}/apply_x.npy")), APPLY["micro"])
    target = torch.from_numpy(np.load(f"{out}/apply_target.npy"))
    acc = pipeline_apply(_layer, mine, xm, grid.pipe)
    x = xm.clone().requires_grad_()
    loss = _apply_with_grads(mine, x, grid.pipe,
                             lambda y: ((from_microbatches(y) - target) ** 2).mean())
    p = grid.pipe.rank
    np.savez(f"{out}/apply_{p}.npz", acc=acc.numpy(),
             dw=np.stack([q["w"].grad.numpy() for q in mine]),
             db=np.stack([q["b"].grad.numpy() for q in mine]),
             dx=x.grad.numpy() if p == 0 else np.zeros(0),
             loss=np.asarray(float(loss)) if loss is not None else np.zeros(0))


def _seq_step_case(out: str) -> None:
    """One step of GPT-2's sp × pp loss (dp 1): the gradient summed over
    the seq group and the replicated leaves over the pipe group."""
    grid = make_grid(1, sp=2, pp=2)
    cfg = GPT2Config.tiny(n_layer=LAYERS, compute_dtype=torch.float32)
    stage = GPT2Stage(cfg, grid.pipe, device="cpu", tp=grid.tensor, seq=grid.seq)
    init = params_from_jax(load_pytree(f"{out}/gpt2_init.npz"))
    with torch.no_grad():
        for name, p in stage.jax_named_parameters():
            p.copy_(init[name])
    tokens = torch.from_numpy(np.load(f"{out}/seq_tokens.npy")).long()
    half = T // 2
    loss, metrics = make_pipeline_loss(stage, 2)(
        tokens[:, grid.seq.rank * half:(grid.seq.rank + 1) * half], None)
    grads = {}
    for name, p in stage.jax_named_parameters():
        # a leaf this stage's loss does not use (the head on stage 0, the
        # embedding on the last) has no gradient here
        g = torch.zeros_like(p) if p.grad is None else p.grad.clone()
        dist.all_reduce(g, group=grid.seq.group)
        if not name.startswith("blocks."):
            dist.all_reduce(g, group=grid.pipe.group)
        grads[name] = g.numpy()
    if grid.seq.rank == 0:
        np.savez(f"{out}/seq_step_{grid.pipe.rank}.npz", **grads,
                 loss=np.asarray(float(metrics["loss"])),
                 accuracy=np.asarray(float(metrics["accuracy"])))


def _sharded_case(out: str, pair) -> dict:
    """``make_sharded_step`` on this rank's pair (a data group of two), its
    stacked init state cut by ``shard_state``: the params after each step
    and the final momentum."""
    r = dist.get_rank(pair)
    init = np.load(f"{out}/sharded_init.npz")
    named = [(k, torch.nn.Parameter(torch.from_numpy(init[k]))) for k in sorted(init.files)]
    flat = FlatParams(named)
    opt = distributed_lion(0.02, weight_decay=0.0, group=pair, wire="sign_psum")
    state = opt.init(flat)
    stacked = state._replace(exp_avg=torch.zeros((2, flat.numel), dtype=torch.float32))
    state = shard_state(stacked, r)
    step = make_sharded_step(opt, pair)
    grads = np.load(f"{out}/sharded_grads.npz")
    params = []
    for k in range(STEPS):
        g = torch.cat([torch.from_numpy(grads[f"{name}_{k}"][r]).reshape(-1)
                       for name, _ in named])
        flat, state = step(flat, g, state)
        params.append(flat.params.clone().numpy())
    np.savez(f"{out}/sharded_{dist.get_rank()}.npz", params=np.stack(params),
             mom=state.exp_avg.numpy())
    return {"specs": list(state_specs()), "count": int(state.count)}


def _rep_equal(trainer) -> bool:
    """The leaves replicated over the pipe axis equal every stage's, bit
    for bit."""
    views = trainer.flat.views(trainer.flat.params)
    rep = torch.cat([views[n].reshape(-1) for n, p in zip(trainer.flat.names, trainer._pdims)
                     if not p])
    every = [torch.empty_like(rep) for _ in range(trainer.pipe.size)]
    dist.all_gather(every, rep, group=trainer.pipe.group)
    return all(torch.equal(every[0], t) for t in every[1:])


def _jax_case(out: str, name: str, rank: int) -> dict:
    family, tp, extra = JAX_RUNS[name]
    grid = make_grid(tp, pp=PP)
    cfg = TrainConfig(**COMMON, **extra, tensor_parallel=tp, pipeline_parallel=PP)
    init = load_pytree(f"{out}/{family}_init.npz")
    if family == "gpt2":
        trainer = Trainer.for_gpt2(cfg, GPT2Config.tiny(n_layer=LAYERS, compute_dtype=torch.float32),
                                   device="cpu", grid=grid, initial_params=params_from_jax(init))
    else:
        trainer = Trainer.for_llama(cfg, LlamaConfig.tiny(n_layer=LAYERS,
                                                          compute_dtype=torch.float32),
                                    device="cpu", grid=grid,
                                    initial_params=llama_params_from_jax(init))
    it = batch_iterator(np.load(f"{out}/blocks.npy"), trainer.global_train_batch(), seed=0)
    equal = []
    for k in range(1, STEPS + 1):
        trainer.cfg.max_steps = k
        trainer.train(it)
        if k == 1:
            np.save(f"{out}/{name}_mom_{rank}.npy", trainer.state.exp_avg.numpy())
        equal.append(_rep_equal(trainer))
    np.save(f"{out}/{name}_params_{rank}.npy", trainer.flat.params.detach().numpy())
    rows = [h for h in trainer.history if "loss" in h]
    rec = {"losses": [h["loss"] for h in rows], "rep_equal": equal, "names": trainer.flat.names,
           "grid": [grid.data_rank, grid.tensor.rank, grid.pipe.rank],
           "n_params": trainer.n_params, "n_global": trainer.n_global}
    trainer.close()
    return rec


def _clm(argv: list, group=None, one: bool = False):
    """``run_clm.main(argv)`` over ``group`` (a world of one with ``one``),
    the default group otherwise."""
    orig = run_clm.init_distributed
    if group is not None or one:
        run_clm.init_distributed = lambda device: group
    try:
        return run_clm.main(CLM_ARGV + argv)
    finally:
        run_clm.init_distributed = orig


def _clm_record(trainer) -> dict:
    """Losses, the eval loss and the whole model's params by name (a
    collective over the data rank's ranks)."""
    whole = trainer.full_named() if trainer.rank == 0 else None
    rec = {"losses": [h["loss"] for h in trainer.history if "loss" in h],
           "eval": [h["eval/loss"] for h in trainer.history if "eval/loss" in h]}
    return rec, whole


def _pins(out: str, rank: int, pair) -> dict:
    recs = {}
    for name, (flags, ref_flags, ref_world) in PINS.items():
        rec, whole = _clm_record(_clm(flags))
        if rank == 0:
            torch.save(whole, f"{out}/pin_{name}.pt")
        ref = _clm(ref_flags, group=pair if ref_world == "pair" else None,
                   one=ref_world == "one")
        ref_rec, ref_whole = _clm_record(ref)
        if rank == 0:
            torch.save(ref_whole, f"{out}/pin_{name}_ref.pt")
        recs[name] = {"run": rec, "ref": ref_rec}
        dist.barrier()
    return recs


def _resume_case(out: str, name: str) -> dict:
    """A save at step 2 resumed to 4 against an uninterrupted run."""
    flags = RESUMES[name]
    a, b = f"{out}/resume_{name}", f"{out}/straight_{name}"
    _clm(flags + ["--output_dir", a, "--max_steps", "2"])
    resumed = _clm(flags + ["--output_dir", a, "--max_steps", "4"])
    straight = _clm(flags + ["--output_dir", b, "--save_steps", "1000", "--max_steps", "4"])
    losses = [[h["loss"] for h in t.history if "loss" in h] for t in (resumed, straight)]
    return {"resumed_from": [h["step"] for h in resumed.history if "loss" in h],
            "losses_equal": losses[0] == losses[1][2:],
            "params_equal": torch.equal(resumed.flat.params, straight.flat.params),
            "momentum_equal": torch.equal(resumed.state.exp_avg, straight.state.exp_avg)}


def _refusals(out: str) -> dict:
    got = {}
    for name, (kind, flags, _, _) in REFUSALS.items():
        try:
            if kind == "grid_3":
                make_grid(1, pp=3)
            elif kind == "resumed":
                _clm(["--output_dir", f"{out}/resume_dp_pp", "--max_steps", "6"])
            else:
                _clm(flags)
            got[name] = None
        except Exception as e:  # noqa: BLE001 - the message is what is held
            got[name] = [type(e).__name__, str(e)]
    return got


def _rank(rank: int, out: str) -> None:
    os.environ["DLION_PLATFORM"] = "cpu"
    # a collective made out of order fails within the timeout, never hangs
    dist.init_process_group("gloo", init_method=f"file://{out}/pg", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    torch.set_num_threads(1)
    while not os.path.exists(f"{out}/inputs_ready"):   # the fixture writes them meanwhile
        time.sleep(0.05)
    try:
        pair = dist.new_group([0, 1]), dist.new_group([2, 3])
        _apply_case(out)
        _seq_step_case(out)
        rec = {"sharded": _sharded_case(out, pair[rank // 2])}
        rec.update({name: _jax_case(out, name, rank) for name in JAX_RUNS})
        rec["pins"] = _pins(out, rank, pair[rank // 2])
        rec["resume"] = {name: _resume_case(out, name) for name in RESUMES}
        rec["refusals"] = _refusals(out)
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the JAX side
def _jax_inputs(out: str) -> None:
    """Weights, tokens, batches and the optimizer's grads, numpy-seeded
    through the JAX package."""
    import jax

    from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2
    from distributed_lion_tpu.models.gpt2 import gpt2_init
    from distributed_lion_tpu.models.llama import LlamaConfig as JLlama
    from distributed_lion_tpu.models.llama import llama_init as j_llama_init
    from distributed_lion_tpu.utils.serialization import save_pytree as j_save

    j_save(f"{out}/gpt2_init.npz", jax.tree.map(
        np.asarray, gpt2_init(jax.random.key(0), JGPT2.tiny(n_layer=LAYERS))))
    j_save(f"{out}/llama_init.npz", jax.tree.map(
        np.asarray, j_llama_init(jax.random.key(0), JLlama.tiny(n_layer=LAYERS))))
    np.save(f"{out}/blocks.npy", j_synthetic(256, T, 256))
    rng = np.random.default_rng(5)
    n, d = APPLY["layers"], APPLY["d"]
    np.save(f"{out}/apply_w.npy", (rng.normal(size=(n, d, d)) * 0.3).astype(np.float32))
    np.save(f"{out}/apply_b.npy", (rng.normal(size=(n, d)) * 0.1).astype(np.float32))
    for key in ("x", "target"):
        np.save(f"{out}/apply_{key}.npy",
                rng.normal(size=(APPLY["micro"] * APPLY["mb"], d)).astype(np.float32))
    np.save(f"{out}/seq_tokens.npy", rng.integers(0, 256, size=(4, T)).astype(np.int32))
    np.savez(f"{out}/sharded_init.npz", a=rng.normal(size=(16, 8)).astype(np.float32),
             b=rng.normal(size=(37,)).astype(np.float32))
    np.savez(f"{out}/sharded_grads.npz", **{
        f"{k}_{s}": rng.normal(size=(2,) + shape).astype(np.float32)
        for k, shape in (("a", (16, 8)), ("b", (37,))) for s in range(STEPS)})
    open(f"{out}/inputs_ready", "w").close()


def _jax_apply(out: str) -> dict:
    """JAX's ``pipeline_apply`` under ``shard_map`` at pipe 4: the stacked
    outputs and ``jax.grad`` of the squared error (tests/test_pipeline.py)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.parallel.pipeline import from_last_stage as j_last
    from distributed_lion_tpu.parallel.pipeline import pipeline_apply as j_apply
    from distributed_lion_tpu.parallel.pipeline import stack_stage_params as j_stack
    from distributed_lion_tpu.parallel.pipeline import to_microbatches as j_micro

    mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    w, b = np.load(f"{out}/apply_w.npy"), np.load(f"{out}/apply_b.npy")
    stacked = j_stack([{"w": jnp.asarray(w[i]), "b": jnp.asarray(b[i])}
                       for i in range(APPLY["layers"])], 4)
    xm = j_micro(jnp.asarray(np.load(f"{out}/apply_x.npy")), APPLY["micro"])
    target = jnp.asarray(np.load(f"{out}/apply_target.npy"))

    def layer(p, x):
        return x + jnp.tanh(x @ p["w"] + p["b"])

    def acc_of(stacked, xm):
        def body(sp, xm):
            return j_apply(layer, jax.tree.map(lambda a: a[0], sp), xm, axis_name="pipe")
        return jax.shard_map(body, mesh=mesh, in_specs=(P("pipe"), P()),
                             out_specs=P("pipe"))(stacked, xm)

    def loss(stacked, xm):
        def body(sp, xm):
            acc = j_apply(layer, jax.tree.map(lambda a: a[0], sp), xm, axis_name="pipe")
            y = j_last(acc, "pipe")
            return jnp.mean((y.reshape(target.shape) - target) ** 2)[None]
        return jax.shard_map(body, mesh=mesh, in_specs=(P("pipe"), P()),
                             out_specs=P("pipe"))(stacked, xm).mean()

    acc = np.asarray(jax.jit(acc_of)(stacked, xm)).reshape((4,) + xm.shape)
    value, (gs, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(stacked, xm)
    return {"acc": acc, "loss": float(value), "dw": np.asarray(gs["w"]),
            "db": np.asarray(gs["b"]), "dx": np.asarray(gx)}


def _jax_seq_step(out: str) -> dict:
    """``jax.value_and_grad`` of JAX's sp × pp GPT-2 loss under
    ``shard_map`` at seq 2 × pipe 2, the gradient reduced as the JAX train
    loop reduces it (psum over seq; the replicated leaves over pipe)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2
    from distributed_lion_tpu.models.gpt2_pipe import make_pipeline_loss as j_loss
    from distributed_lion_tpu.models.gpt2_pipe import pipeline_param_specs, pipeline_params
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.utils.serialization import load_pytree as j_load

    mesh = make_mesh(data=1, seq=2, pipe=2, devices=jax.devices()[:4])
    cfg = JGPT2.tiny(n_layer=LAYERS, compute_dtype=jnp.float32, remat=False)
    params = pipeline_params(j_load(f"{out}/gpt2_init.npz"), 2)
    specs = pipeline_param_specs()
    loss_fn = j_loss(cfg, 2, seq_axis="seq")

    def body(p, t):
        (loss, metrics), g = jax.value_and_grad(
            lambda q: loss_fn(q, t, None), has_aux=True)(p)
        g = jax.tree.map(lambda x: lax.psum(x, "seq"), g)
        g = {k: (v if k == "stages" else jax.tree.map(lambda x: lax.psum(x, "pipe"), v))
             for k, v in g.items()}
        return metrics["loss"], metrics["accuracy"], g

    loss, acc, g = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(specs, P(None, "seq")), out_specs=(P(), P(), specs),
        check_vma=False))(params, jnp.asarray(np.load(f"{out}/seq_tokens.npy")))
    return {"loss": float(loss), "accuracy": float(acc), "grads": jax.tree.map(np.asarray, g)}


def _jax_sharded(out: str) -> dict:
    """JAX's ``make_sharded_step`` on ``make_mesh(data=2)``, 3 steps."""
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.optim import distributed_lion as j_lion
    from distributed_lion_tpu.optim import init_global_state
    from distributed_lion_tpu.optim.sharded import make_sharded_step as j_step
    from distributed_lion_tpu.optim.sharded import shard_state as j_shard
    from distributed_lion_tpu.parallel import make_mesh

    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    init = np.load(f"{out}/sharded_init.npz")
    grads = np.load(f"{out}/sharded_grads.npz")
    params = {k: jnp.asarray(init[k]) for k in init.files}
    opt = j_lion(learning_rate=0.02, weight_decay=0.0, wire="sign_psum")
    state = j_shard(init_global_state(opt, params, world=2), mesh)
    step = j_step(opt, mesh)
    flat = []
    for k in range(STEPS):
        params, state = step(params, {n: jnp.asarray(grads[f"{n}_{k}"]) for n in init.files},
                             state)
        flat.append(np.concatenate([np.asarray(params[n]).reshape(-1) for n in sorted(params)]))
    mom = np.stack([np.concatenate([np.asarray(state.exp_avg[n][r]).reshape(-1)
                                    for n in sorted(params)]) for r in range(2)])
    return {"params": np.stack(flat), "mom": mom}


def _jax_references(out: str) -> dict:
    """The function-level references, then the two trainers: losses, the
    stacked momentum after step 1 and the final params."""
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.data.sources import batch_iterator as j_batches
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2
    from distributed_lion_tpu.models.llama import LlamaConfig as JLlama
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer
    from distributed_lion_tpu.utils.serialization import load_pytree as j_load

    refs = {"apply": _jax_apply(out), "seq_step": _jax_seq_step(out),
            "sharded": _jax_sharded(out)}
    blocks = np.load(f"{out}/blocks.npy")
    for name, (family, tp, extra) in JAX_RUNS.items():
        mesh = make_mesh(data=WORLD // (2 * tp), tensor=tp, pipe=2,
                         devices=jax.devices()[:WORLD])
        cfg = JTrainConfig(**COMMON, **extra, tensor_parallel=tp, pipeline_parallel=2)
        init = j_load(f"{out}/{family}_init.npz")
        # remat off on the JAX side only: the same values at float32, half
        # the compile
        if family == "gpt2":
            jtr = JTrainer.for_gpt2(cfg, mesh, JGPT2.tiny(n_layer=LAYERS, compute_dtype=jnp.float32,
                                                          dropout=0.0, remat=False),
                                    initial_params=init)
        else:
            jtr = JTrainer.for_llama(cfg, mesh, JLlama.tiny(n_layer=LAYERS,
                                                            compute_dtype=jnp.float32,
                                                            remat=False), initial_params=init)
        it = j_batches(blocks, jtr.global_train_batch(), seed=0)
        hist = jtr.train(it, max_steps=1)
        mom = jax.tree.map(np.asarray, jtr.state.exp_avg)
        hist += jtr.train(it, max_steps=STEPS - 1)
        refs[name] = {"losses": [h["loss"] for h in hist if "loss" in h], "mom": mom,
                      "params": jax.tree.map(np.asarray, jtr.params)}
        jtr.close()
    return refs


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    """Start the four ranks, compute the JAX references meanwhile, then wait
    for the ranks: ``(their records, the JAX references, the directory)``."""
    out = tmp_path_factory.mktemp("pipe")
    ctx = mp.start_processes(_rank, args=(str(out),), nprocs=WORLD, join=False,
                             start_method="spawn")
    _jax_inputs(str(out))
    refs = _jax_references(str(out))
    while not ctx.join():
        pass
    recs = [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return recs, refs, out


# ----------------------------------------------------------- the tests
def _close(got: np.ndarray, want: np.ndarray, rel: float, key: str) -> None:
    assert got.shape == want.shape, key
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=key)


def test_pipeline_apply_matches_jax(pipe_run):
    """Pipe 4 against JAX's ``pipeline_apply`` under ``shard_map``: the last
    stage's outputs within 1e-5 (every other stage's zeros, as JAX's); the
    loss, each stage's layer gradients and the input's within 1e-5 of the
    largest."""
    _, refs, out = pipe_run
    ref = refs["apply"]
    runs = [dict(np.load(out / f"apply_{p}.npz")) for p in range(4)]
    _close(runs[3]["acc"], ref["acc"][3], 1e-5, "acc")
    for p in range(3):
        assert not runs[p]["acc"].any() and not ref["acc"][p].any()
    np.testing.assert_allclose(float(runs[3]["loss"]), ref["loss"], rtol=1e-6)
    _close(np.concatenate([r["dw"] for r in runs]),
           ref["dw"].reshape((-1,) + ref["dw"].shape[2:]), 1e-5, "dw")
    _close(np.concatenate([r["db"] for r in runs]),
           ref["db"].reshape((-1,) + ref["db"].shape[2:]), 1e-5, "db")
    _close(runs[0]["dx"], ref["dx"], 1e-5, "dx")


def test_seq_parallel_pipelined_step_matches_jax(pipe_run):
    """GPT-2 at seq 2 × pipe 2 against JAX's ``make_pipeline_loss(seq_axis)``
    in ``shard_map``: loss and accuracy within 1e-6, every leaf's reduced
    gradient times pp within 1e-5 of the largest of JAX's (its factor pp:
    module doc); the two stages' replicated gradients equal."""
    _, refs, out = pipe_run
    ref = refs["seq_step"]
    want = pipeline_params_from_jax(ref["grads"], LAYERS, 1, 0)
    stages = [dict(np.load(out / f"seq_step_{p}.npz")) for p in range(2)]
    seen = set()
    for st in stages:
        np.testing.assert_allclose(float(st["loss"]), ref["loss"], rtol=1e-6)
        np.testing.assert_allclose(float(st["accuracy"]), ref["accuracy"], rtol=1e-6)
        for k, g in st.items():
            if k in ("loss", "accuracy"):
                continue
            _close(PP * g, want[k].numpy(), 1e-5, k)
            seen.add(k)
    assert seen == set(want)
    for k in ("wte", "wpe", "ln_f.scale"):
        np.testing.assert_array_equal(stages[0][k], stages[1][k])


def test_sharded_step_matches_jax(pipe_run):
    """``optim.sharded.make_sharded_step`` against JAX's on
    ``make_mesh(data=2)`` (XLA path): params bit-equal after every step,
    momentum within one ulp of its largest; both pairs alike."""
    recs, refs, out = pipe_run
    ref = refs["sharded"]
    for rank in range(WORLD):
        got = np.load(out / f"sharded_{rank}.npz")
        np.testing.assert_array_equal(got["params"], ref["params"])
        _close(got["mom"], ref["mom"][rank % 2], 2 ** -23, "mom")
        assert recs[rank]["sharded"]["count"] == STEPS
    assert recs[0]["sharded"]["specs"][:2] == ["replicated", DATA_AXIS]


def test_sharded_step_refuses_a_mismatched_layout():
    opt = distributed_lion(0.02, wire="sign_psum")
    with pytest.raises(ValueError, match="another process group"):
        make_sharded_step(opt, group=object())
    with pytest.raises(ValueError, match="has_guard=True"):
        make_sharded_step(opt, has_guard=True)
    flat = FlatParams([("w", torch.nn.Parameter(torch.zeros(4)))])
    state = opt.init(flat)
    step = make_sharded_step(opt)
    _, state = step(flat, torch.ones(4), state)
    assert torch.equal(flat.params, torch.full((4,), -0.02))
    with pytest.raises(ValueError, match="has_elected"):
        step(flat, torch.ones(4), state._replace(elected=torch.zeros(1, dtype=torch.uint8)))
    stacked = state._replace(exp_avg=torch.arange(8.0).view(2, 4))
    assert torch.equal(shard_state(stacked, 1).exp_avg, torch.arange(4.0, 8.0))
    assert state_specs(has_guard=True).prev_ballot == DATA_AXIS


def test_grid_layout(pipe_run):
    """Rank r = (((d·tp + t)·sp + s)·pp + p)·ep + e."""
    recs, _, _ = pipe_run
    assert [r["gpt2"]["grid"] for r in recs] == [[r // 2, 0, r % 2] for r in range(WORLD)]
    assert [r["llama"]["grid"] for r in recs] == [[0, r // 2, r % 2] for r in range(WORLD)]


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_losses_match_jax(pipe_run, name):
    recs, refs, _ = pipe_run
    for rec in recs:
        assert len(rec[name]["losses"]) == STEPS
        np.testing.assert_allclose(rec[name]["losses"], refs[name]["losses"], atol=1e-5, rtol=0)


def _family(name: str) -> tuple:
    family, tp, _ = JAX_RUNS[name]
    return family, tp


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_momentum_matches_jax_exp_avg(pipe_run, name):
    """After step 1 each rank's momentum times pp is JAX's ``exp_avg[data
    rank]`` in its pipeline layout, cut to the rank's stage and tensor slice
    (JAX's gradient factor pp: module doc)."""
    recs, refs, out = pipe_run
    family, tp = _family(name)
    for r in range(WORLD):
        d, t, p = recs[r][name]["grid"]
        mom = pipeline_momentum_from_jax(refs[name]["mom"], d, LAYERS, 2, p, tp, t, family)
        want = np.concatenate([mom[k].reshape(-1).numpy() for k in recs[r][name]["names"]])
        got = PP * np.load(out / f"{name}_mom_{r}.npy")
        assert got.shape == want.shape == (recs[r][name]["n_params"],)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
        real = np.abs(want) > 1e-9 * np.abs(want).max()
        np.testing.assert_array_equal(np.sign(got[real]), np.sign(want[real]))


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_elections_match_jax(pipe_run, name):
    """The final params equal JAX's (pipeline layout, the rank's stage and
    tensor slice) bit for bit on at least 99.99% of the coordinates outside
    GPT-2's key bias (``qkv_b[1]``), and every coordinate within 2·lr·steps
    (module doc: the key bias's noise ballots)."""
    recs, refs, out = pipe_run
    family, tp = _family(name)
    for r in range(WORLD):
        _, t, p = recs[r][name]["grid"]
        state = pipeline_params_from_jax(refs[name]["params"], LAYERS, 2, p, tp, t, family)
        names = recs[r][name]["names"]
        assert set(names) == set(state)
        want = np.concatenate([state[k].reshape(-1).numpy() for k in names])
        noise = np.concatenate([
            (np.arange(state[k].numel()) // (state[k].numel() // 3) == 1)
            if k.endswith("attn.qkv_b") else np.zeros(state[k].numel(), bool) for k in names])
        got = np.load(out / f"{name}_params_{r}.npy")
        assert np.mean(got[~noise] != want[~noise]) <= 1e-4
        assert np.max(np.abs(got - want)) <= 2 * LR * STEPS * (1 + 1e-6)


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_replicated_leaves_equal_across_stages(pipe_run, name):
    """... and the trainer counts the whole model's coordinates, as JAX."""
    recs, _, _ = pipe_run
    family, _ = _family(name)
    if family == "gpt2":
        whole = sum(p.numel() for p in GPT2(GPT2Config.tiny(n_layer=LAYERS),
                                            device="cpu").parameters())
    else:
        c = LlamaConfig.tiny(n_layer=LAYERS)
        whole = 2 * c.vocab_size * c.d_model + c.d_model + LAYERS * (
            2 * c.d_model + 2 * c.d_model * c.n_head * c.head_dim
            + 2 * c.d_model * c.n_kv_head * c.head_dim + 3 * c.d_model * c.d_ff)
    for rec in recs:
        assert rec[name]["rep_equal"] == [True] * STEPS
        assert rec[name]["n_global"] == whole > rec[name]["n_params"]


@pytest.mark.parametrize("name", list(PINS))
def test_compositions_match_the_unpiped_run(pipe_run, name):
    """Each ``run_clm --pipeline_parallel 2`` composition against the same
    CLI without the pipe axis at the same data world: losses and eval loss
    within 1e-5 on every rank; the whole model's params (``full_named``)
    bit-equal on at least 99.9% of the coordinates, every one within
    2·lr·steps."""
    recs, _, out = pipe_run
    for rec in recs:
        run, ref = rec["pins"][name]["run"], rec["pins"][name]["ref"]
        assert len(run["losses"]) == 3
        np.testing.assert_allclose(run["losses"], ref["losses"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(run["eval"], ref["eval"], atol=1e-5, rtol=0)
    got, want = torch.load(out / f"pin_{name}.pt"), torch.load(out / f"pin_{name}_ref.pt")
    assert sorted(got) == sorted(want)
    a = torch.cat([got[k].reshape(-1).float() for k in sorted(want)])
    b = torch.cat([want[k].reshape(-1).float() for k in sorted(want)])
    assert float((a == b).float().mean()) >= 0.999
    assert float((a - b).abs().max()) <= 2 * 1e-3 * 3 * (1 + 1e-6)


def _resumed(recs: list, name: str) -> None:
    for rec in recs:
        res = rec["resume"][name]
        assert res["resumed_from"] == [3, 4] and res["losses_equal"]
        assert res["params_equal"] and res["momentum_equal"]


def test_checkpoint_resumes_bit_identical(pipe_run):
    """dp 2 x pp 2: the resume from step 2 equals the uninterrupted run bit
    for bit on every rank; the step holds each stage's params and each data
    rank's momentum of its stage; ``model.npz`` the whole model in the JAX
    package's layout."""
    recs, _, out = pipe_run
    _resumed(recs, "dp_pp")
    step = out / "resume_dp_pp" / "checkpoints" / "2"
    assert sorted(p.relative_to(step).as_posix() for p in step.rglob("*.pt")) == [
        f"exp_avg/rank{d:05d}_stage{p:05d}.pt" for d in range(2) for p in range(2)] + [
        "params/stage00000.pt", "params/stage00001.pt", "state.pt"]
    stage1 = torch.load(step / "params/stage00001.pt")
    assert stage1["names"][0] == "blocks.1.attn.proj" and "wte" in stage1["names"]
    meta = json.loads((step / "manifest.json").read_text())["meta"]
    assert meta["pipeline_parallel"] == 2
    model = load_pytree(out / "resume_dp_pp" / "model.npz")
    assert len(model["blocks"]) == 2 and model["wte"].shape == (256, 64)
    tree = pipeline_params_to_jax({k: torch.from_numpy(np.asarray(v))
                                   for k, v in state_dict_from_tree(model).items()}, 2)
    assert tree["stages"]["attn"]["qkv"].shape == (2, 1, 64, 3, 64)


def test_checkpoint_resumes_bit_identical_under_tp_pp(pipe_run):
    """dp 1 x tp 2 x pp 2 (JAX's exact-resume pin): the resume equals the
    uninterrupted run bit for bit on every rank; each stage's params and
    momentum are written whole over the tensor axis."""
    recs, _, out = pipe_run
    _resumed(recs, "tp_pp")
    step = out / "resume_tp_pp" / "checkpoints" / "2"
    assert sorted(p.relative_to(step).as_posix() for p in step.rglob("*.pt")) == [
        "exp_avg/rank00000_stage00000.pt", "exp_avg/rank00000_stage00001.pt",
        "params/stage00000.pt", "params/stage00001.pt", "state.pt"]
    whole = dict(GPT2(GPT2Config.tiny(), device="cpu").named_parameters())
    for p in range(2):
        saved = torch.load(step / f"params/stage{p:05d}.pt")
        assert [tuple(s) for s in saved["shapes"]] == [tuple(whole[n].shape)
                                                       for n in saved["names"]]
        assert torch.load(step / f"exp_avg/rank00000_stage{p:05d}.pt").numel() == sum(
            whole[n].numel() for n in saved["names"])


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_in_jax_words(pipe_run, name):
    recs, _, _ = pipe_run
    _, _, error, match = REFUSALS[name]
    for rec in recs:
        got = rec["refusals"][name]
        assert got is not None, name
        assert got[0] == error.__name__ and re.search(match, got[1]), got


def test_pipeline_axis_needs_its_ranks():
    with pytest.raises(ValueError, match="--pipeline_parallel 2 needs 2 ranks"):
        make_grid(1, pp=2)
    with pytest.raises(ValueError, match="--pipeline_parallel must be >= 1, got 0"):
        make_grid(1, pp=0)


def test_microbatches_and_stacking():
    """``to_microbatches``/``from_microbatches`` and the stacked stage
    layout round-trip, with JAX's refusals; the bubble fraction
    (S − 1)/(M + S − 1)."""
    x = torch.arange(24.0).reshape(12, 2)
    assert torch.equal(from_microbatches(to_microbatches(x, 4)), x)
    with pytest.raises(ValueError, match="batch 12 not divisible by n_micro 5"):
        to_microbatches(x, 5)
    layers = [{"w": torch.full((3,), float(i))} for i in range(8)]
    stacked = stack_stage_params(layers, 4)
    assert stacked["w"].shape == (4, 2, 3)
    assert all(torch.equal(a["w"], b["w"])
               for a, b in zip(layers, unstack_stage_params(stacked, 8)))
    with pytest.raises(ValueError, match="6 layers not divisible by 4 stages"):
        stack_stage_params(layers[:6], 4)
    assert bubble_fraction(2, 4) == 1 / 5 and bubble_fraction(4, 8) == 3 / 11


def test_run_clm_dropout_defaults_to_zero_under_the_pipe_axis():
    """JAX run_clm.py:82-96: GPT-2's 0.1 default becomes 0 under pp (and
    sp); an explicit value stays (and the pipeline refuses it)."""
    assert run_clm.resolve_dropout(None, "gpt2") == 0.1
    assert run_clm.resolve_dropout(None, "gpt2", pp=2) == 0.0
    assert run_clm.resolve_dropout(None, "gpt2", sp=2) == 0.0
    assert run_clm.resolve_dropout(0.1, "gpt2", pp=2) == 0.1
    assert run_clm.resolve_dropout(None, "llama") == 0.0
