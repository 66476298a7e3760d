"""GPT-2's Switch-MoE and the expert axis (dp × ep × tp) against the JAX package on its CPU mesh.

Four gloo ranks on the CPU form the grids (``parallel.mesh.make_grid``:
global rank ``r = ((d·tp + t)·sp + s)·ep + e``); one spawn runs every
multi-rank case (the ``moe_run`` fixture) while the fixture computes the JAX
references from the same numpy-seeded weights, tokens and batches. The tests
compare what both wrote.

- ``moe_ffn`` (E 4, d 8, d_ff 16, 64 tokens a rank) at ep 1 in this process
  and at ep 2 on the ranks against JAX's ``moe_ffn`` (ep 2 under
  ``shard_map`` over an ``expert`` axis of two devices), float32, capacity
  factor 1.25 (tokens drop) and 8, with ``balance_tokens`` (a fed tally and
  the all-zero fallback) and ``balance_axis``: outputs within 1e-6, aux
  within 1e-6, tallies equal, and the gradients of ``Σ y² + 0.01·aux`` (the
  input's and every leaf's, the gate's summed over the expert group) within
  1e-5 of ``max|g|``. bfloat16 routing of 1,024 tokens, most on expert 0 (JAX
  ``tests/test_expert.py``'s case): the port's bfloat16 gate probabilities
  and expert choices equal JAX's bfloat16 run's, no slot holds two tokens, the
  kept count per expert is ``min(count, C)``, and the output is within 0.1
  of the float32 one.
- GPT-2-MoE tiny (4 layers, E 4) logits and aux against ``gpt2_apply`` at
  float32, and its leaf order against ``jax.tree.leaves``.
- The trainers at float32 compute, weight decay 0, constant LR, on
  ``sign_psum``, 4 steps of B 2 × accumulation 2 at T 32: dp 2 × ep 2 with
  ``ep_dcn_pipeline`` 0 against ``Trainer.for_gpt2`` on ``make_mesh(data=2,
  expert=2)``, and dp 1 × tp 2 × ep 2 with ``ep_dcn_pipeline`` 2 against
  ``make_mesh(data=1, tensor=2, expert=2)`` (JAX without remat, the port
  with it: the hops run again in the recompute). Per-step losses and aux within
  1e-5; each rank's momentum after step 1 within 1e-6 of ``max|m|`` of JAX's
  ``exp_avg[data rank]`` sliced to its tensor and expert ranks; the final
  params bit-equal to JAX's slices (every election the same) except on the
  key bias, whose gradient is zero in exact arithmetic (softmax ignores a
  shift of a query's scores), so its ballots are the signs of float noise
  near 1e-15 in both frameworks; the MoE ring's
  slots equal to JAX's ``moe_ring[data rank]``; the replicated leaves
  ``torch.equal`` across the expert ranks after every step.
- ``run_clm --moe_experts 4 --expert_parallel 2 --ep_dcn_pipeline 2`` at dp
  2 × ep 2: a save at step 2 resumed to 4 is ``torch.equal`` to the
  uninterrupted run (params, momentum, ring, losses); the checkpoint holds
  whole expert leaves and each data rank's ring; ``model.npz`` holds whole
  leaves; a depth toggle and an elastic resume with a ring are refused. The
  DCN pipeline's ring (``hier:1``, depth 1) at dp 2 × ep 2 is a file per
  expert rank and resumes.
- Every refusal on this path, in the JAX package's words.

This file imports jax only inside the fixture and the tests, so the spawned
ranks import torch alone.
"""

import json
import os
import re
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu_torch.cli import run_clm
from distributed_lion_tpu_torch.data.sources import batch_iterator
from distributed_lion_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_lion_tpu_torch.models.llama import LlamaConfig
from distributed_lion_tpu_torch.parallel.expert import capacity, expert_shard_dim, moe_ffn, route
from distributed_lion_tpu_torch.parallel.mesh import make_grid
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.utils.serialization import (
    load_pytree,
    momentum_from_jax,
    params_from_jax,
)

WORLD = 4
LR, STEPS, T, E = 3e-3, 4, 32, 4
COMMON = dict(lion=True, async_grad=True, learning_rate=LR, weight_decay=0.0,
              lr_scheduler_type="constant", max_steps=STEPS, per_device_train_batch_size=2,
              gradient_accumulation_steps=2, block_size=T, logging_steps=1, eval_steps=1000,
              seed=0, wire="sign_psum")
MODEL = dict(n_layer=4, moe_experts=E)
# name: (tp, ep, ep_dcn_pipeline) of the trainers held to JAX
JAX_RUNS = {"dp_ep": (1, 2, 0), "tp_ep": (2, 2, 2)}
FFN = dict(n=64, d=8, f=16)   # a rank's tokens, the width, the expert FFN's width
# name: (capacity factor, the balance argument) of the moe_ffn cases
FFN_CASES = {"drop": (1.25, None), "no_drop": (8.0, None), "fed": (1.25, "fed"),
             "zero_slot": (1.25, "zero"), "axis": (1.25, "axis")}
CLM_ARGV = ["--model_name", "tiny", "--dataset", "synthetic", "--synthetic_blocks", "64",
            "--block_size", "32", "--per_device_train_batch_size", "1",
            "--gradient_accumulation_steps", "1", "--logging_steps", "1", "--dropout", "0",
            "--lr_scheduler_type", "constant", "--learning_rate", "1e-3", "--eval_iters", "1",
            "--per_device_eval_batch_size", "1", "--compute_dtype", "float32", "--wire",
            "sign_psum", "--moe_experts", "4"]
EP2 = ["--expert_parallel", "2"]
RING = EP2 + ["--ep_dcn_pipeline", "2", "--save_steps", "2"]
# name: (what it runs, its flags, the exception, the message)
REFUSALS = {
    "dense_expert_axis": ("clm", ["--moe_experts", "0", *EP2], ValueError,
                          r"an 'expert' mesh axis of size 2 needs MoE blocks \(--moe_experts\)"),
    "dense_ep_dcn": ("clm", ["--moe_experts", "0", "--ep_dcn_pipeline", "0"], ValueError,
                     r"--ep_dcn_pipeline schedules the MoE balance feedback; a dense model"),
    "vocab_chunks": ("clm", ["--vocab_chunks", "4"], NotImplementedError,
                     r"--vocab_chunks is wired for the dense dp/tp/sp/pp paths \(the MoE branch"),
    "seq_axis": ("clm", ["--seq_parallel", "2"], NotImplementedError,
                 r"MoE composes with data, expert and tensor parallelism \(dp x ep x tp\); a "
                 r"seq axis alongside MoE is not wired"),
    "tp_vocab": ("clm", ["--tensor_parallel", "2", "--tp_vocab", "--vocab_pad_multiple", "64"],
                 NotImplementedError, r"--tp_vocab on the MoE path is not wired"),
    "divisible": ("clm", ["--moe_experts", "2", "--expert_parallel", "4"], ValueError,
                  r"moe_experts 2 not divisible by expert axis 4"),
    "telemetry": ("clm", [*EP2, "--telemetry"], ValueError,
                  r"--telemetry is incompatible with params sharded over \['expert'\]"),
    "vote_every": ("clm", [*EP2, "--vote_every", "4"], ValueError,
                   r"--vote_every > 1 is incompatible with params sharded over \['expert'\]"),
    "vote_guard": ("clm", [*EP2, "--vote_guard", "enforce"], ValueError,
                   r"--vote_guard is incompatible with params sharded over \['expert'\]"),
    "tp_telemetry": ("clm", ["--tensor_parallel", "2", "--telemetry"], ValueError,
                     r"--telemetry is incompatible with params sharded over "
                     r"\['expert', 'tensor'\]"),
    "adamw_sharded": ("clm", [*EP2, "--lion", "false", "--async_grad", "false"],
                      NotImplementedError, r"tensor-parallel param_specs require the Lion path"),
    "negative_depth": ("clm", ["--ep_dcn_pipeline", "-1"], ValueError,
                       r"--ep_dcn_pipeline must be >= 0, got -1"),
    "adamw_ring": ("clm", ["--ep_dcn_pipeline", "2", "--lion", "false", "--async_grad",
                           "false"], ValueError,
                   r"--ep_dcn_pipeline 2 stores the in-flight MoE balance tallies on "
                   r"LionState.moe_ring"),
    "llama_moe": ("clm", ["--model_family", "llama"], NotImplementedError,
                  r"--model_family llama composes with dp x tp x sp x pp; MoE and the expert "
                  r"axis are wired for GPT-2 only"),
    "llama_ring": ("clm", ["--model_family", "llama", "--moe_experts", "0",
                           "--ep_dcn_pipeline", "2"], ValueError,
                   r"--ep_dcn_pipeline 2 > 0 needs the MoE trainer's loss"),
    "llama_expert_axis": ("llama_lib", None, NotImplementedError,
                          r"an 'expert' mesh axis is wired for GPT-2-MoE only"),
    "hf_export": ("clm", ["--hf_export", "hf"], ValueError,
                  r"--hf_export is incompatible with --moe_experts: MoE blocks have no HF "
                  r"GPT-2 equivalent"),
    "grid_3": ("grid_3", None, ValueError,
               r"--expert_parallel 3 does not divide the world of 4 ranks"),
    "depth_toggle": ("resumed", ["--ep_dcn_pipeline", "1"], ValueError,
                     r"checkpoint step 4 was written at --ep_dcn_pipeline 2 but this run uses "
                     r"1: the in-flight MoE balance ring does not survive a depth change"),
    "elastic_ring": ("elastic", ["--elastic_resume"], NotImplementedError,
                     r"--elastic_resume cannot remap the MoE balance ring"),
}


# ------------------------------------------------------------ the ranks
def _ffn_params(out: str, dtype=torch.float32) -> dict:
    return {k: torch.from_numpy(np.load(f"{out}/ffn_{k}.npy")).to(dtype)
            for k in ("gate", "w_in", "b_in", "w_out", "b_out")}


def _ffn_run(params: dict, x: torch.Tensor, cf: float, balance, expert=None) -> dict:
    """``moe_ffn`` of ``x`` under a case's balance argument: y, aux, tallies
    and the gradients of ``Σ y² + 0.01·aux``."""
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    x = x.clone().requires_grad_()
    kw = {}
    if balance == "fed":
        kw["balance_tokens"] = torch.tensor([40.0, 30.0, 20.0, 38.0, 128.0])
    elif balance == "zero":
        kw["balance_tokens"] = torch.zeros(E + 1)
    elif balance == "axis":
        kw["balance_axis"] = expert
    y, aux, tallies = moe_ffn(params, x, capacity_factor=cf, expert=expert,
                              return_tallies=True, **kw)
    ((y ** 2).sum() + 0.01 * aux).backward()
    return {"y": y.detach(), "aux": aux.detach(), "tallies": tallies, "dx": x.grad,
            **{f"d{k}": v.grad for k, v in params.items()}}


def _ffn_cases_ep2(out: str) -> None:
    """Every FFN case at ep 2 on this rank's expert group: its half of the
    tokens, its experts; the gate's gradient summed over the group."""
    grid = make_grid(1, ep=2)
    e, n = grid.expert.rank, FFN["n"]
    full = _ffn_params(out)
    mine = {k: v if k == "gate" else v[e * E // 2:(e + 1) * E // 2] for k, v in full.items()}
    x = torch.from_numpy(np.load(f"{out}/ffn_x.npy"))[e * n:(e + 1) * n]
    for name, (cf, balance) in FFN_CASES.items():
        got = _ffn_run(mine, x, cf, balance, grid.expert)
        dist.all_reduce(got["dgate"], group=grid.expert.group)
        if grid.data_rank == 0:
            np.savez(f"{out}/ffn_ep2_{name}_{e}.npz", **{k: v.numpy() for k, v in got.items()})


def _rep_equal(trainer) -> bool:
    """The leaves replicated over the expert axis equal the expert peer's,
    bit for bit."""
    views = trainer.flat.views(trainer.flat.params)
    rep = torch.cat([views[n].reshape(-1) for n, d in zip(trainer.flat.names, trainer._edims)
                     if d is None])
    every = [torch.empty_like(rep) for _ in range(trainer.expert.size)]
    dist.all_gather(every, rep, group=trainer.expert.group)
    return all(torch.equal(every[0], t) for t in every[1:])


def _jax_case(out: str, name: str, rank: int) -> dict:
    tp, ep, depth = JAX_RUNS[name]
    grid = make_grid(tp, ep=ep)
    cfg = TrainConfig(**COMMON, tensor_parallel=tp, expert_parallel=ep, ep_dcn_pipeline=depth)
    trainer = Trainer.for_gpt2(cfg, GPT2Config.tiny(**MODEL, dropout=0.0,
                                                    compute_dtype=torch.float32),
                               device="cpu", grid=grid,
                               initial_params=params_from_jax(load_pytree(f"{out}/init.npz")))
    it = batch_iterator(np.load(f"{out}/blocks.npy"), trainer.global_train_batch(), seed=0)
    equal = []
    for k in range(1, STEPS + 1):
        trainer.cfg.max_steps = k
        trainer.train(it)
        if k == 1:
            np.save(f"{out}/{name}_mom_{rank}.npy", trainer.state.exp_avg.numpy())
        equal.append(_rep_equal(trainer))
    np.save(f"{out}/{name}_params_{rank}.npy", trainer.flat.params.detach().numpy())
    if trainer.state.moe_ring is not None:
        np.save(f"{out}/{name}_ring_{rank}.npy", trainer.state.moe_ring.numpy())
    rows = [h for h in trainer.history if "loss" in h]
    rec = {"losses": [h["loss"] for h in rows], "aux": [h["aux_loss"] for h in rows],
           "rep_equal": equal, "names": trainer.flat.names,
           "grid": [grid.data_rank, grid.tensor.rank, grid.expert.rank],
           "n_params": trainer.n_params, "n_global": trainer.n_global}
    trainer.close()
    return rec


def _resume_case(out: str) -> dict:
    """A save at step 2 and its resume to 4 against an uninterrupted run, at
    dp 2 x ep 2 with the ring at depth 2."""
    a, b = f"{out}/resume_a", f"{out}/resume_b"
    run_clm.main(CLM_ARGV + RING + ["--output_dir", a, "--max_steps", "2"])
    resumed = run_clm.main(CLM_ARGV + RING + ["--output_dir", a, "--max_steps", "4"])
    straight = run_clm.main(CLM_ARGV + RING + ["--output_dir", b, "--save_steps", "1000",
                                               "--max_steps", "4"])
    losses = [[h["loss"] for h in t.history if "loss" in h] for t in (resumed, straight)]
    # the DCN pipeline's ring under the expert axis: each expert rank's own
    # ballot bytes, a file of its own, resumed
    c = f"{out}/resume_dcn"
    dcn = CLM_ARGV + EP2 + ["--wire", "hier:1", "--dcn_pipeline_depth", "1", "--output_dir", c,
                            "--save_steps", "2"]
    run_clm.main(dcn + ["--max_steps", "2"])
    dcn_resumed = run_clm.main(dcn + ["--max_steps", "3"])
    return {"resumed_from": [h["step"] for h in resumed.history if "loss" in h],
            "losses_equal": losses[0] == losses[1][2:],
            "params_equal": torch.equal(resumed.flat.params, straight.flat.params),
            "momentum_equal": torch.equal(resumed.state.exp_avg, straight.state.exp_avg),
            "ring_equal": torch.equal(resumed.state.moe_ring, straight.state.moe_ring),
            "ring_nonzero": bool(straight.state.moe_ring.abs().sum() > 0),
            "dcn_resumed_from": [h["step"] for h in dcn_resumed.history if "loss" in h]}


def _refusals(out: str, pair) -> dict:
    got = {}
    for name, (kind, flags, _, _) in REFUSALS.items():
        try:
            if kind == "grid_3":
                make_grid(1, ep=3)
            elif kind == "llama_lib":
                Trainer.for_llama(TrainConfig(expert_parallel=2), LlamaConfig.tiny(),
                                  device="cpu", grid=make_grid(1, ep=2)).close()
            elif kind == "resumed":
                run_clm.main(CLM_ARGV + RING + ["--output_dir", f"{out}/resume_a",
                                                "--max_steps", "6", *flags])
            elif kind == "elastic":
                # each pair of ranks, a world of two (dp 1 x ep 2), resumes
                # its own copy of the dp 2 x ep 2 checkpoint
                where = f"{out}/elastic_{dist.get_rank() // 2}"
                orig = run_clm.init_distributed
                run_clm.init_distributed = lambda device: pair
                try:
                    run_clm.main(CLM_ARGV + RING + ["--output_dir", where, "--max_steps", "6",
                                                    *flags])
                finally:
                    run_clm.init_distributed = orig
            else:
                run_clm.main(CLM_ARGV + flags)
            got[name] = None
        except Exception as e:  # noqa: BLE001 - the message is what is held
            got[name] = [type(e).__name__, str(e)]
    return got


def _rank(rank: int, out: str) -> None:
    os.environ["DLION_PLATFORM"] = "cpu"
    dist.init_process_group("gloo", init_method=f"file://{out}/pg", rank=rank,
                            world_size=WORLD)
    torch.set_num_threads(1)
    while not os.path.exists(f"{out}/inputs_ready"):   # the fixture writes them meanwhile
        time.sleep(0.05)
    try:
        pair = dist.new_group([0, 1]), dist.new_group([2, 3])
        _ffn_cases_ep2(out)
        rec = {name: _jax_case(out, name, rank) for name in JAX_RUNS}
        rec["resume"] = _resume_case(out)
        dist.barrier()
        if rank == 0:
            for p in range(2):
                shutil.copytree(f"{out}/resume_a", f"{out}/elastic_{p}")
        dist.barrier()
        rec["refusals"] = _refusals(out, pair[rank // 2])
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the JAX side
def _jax_inputs(out: str) -> None:
    """Weights, tokens and batches, numpy-seeded through the JAX package."""
    import jax

    from distributed_lion_tpu.data.sources import synthetic_lm_dataset as j_synthetic
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2
    from distributed_lion_tpu.models.gpt2 import gpt2_init
    from distributed_lion_tpu.parallel.expert import moe_init as j_moe_init
    from distributed_lion_tpu.utils.serialization import save_pytree as j_save

    j_save(f"{out}/init.npz", jax.tree.map(np.asarray,
                                           gpt2_init(jax.random.key(0), JGPT2.tiny(**MODEL))))
    np.save(f"{out}/blocks.npy", j_synthetic(256, T, 256))
    for k, v in j_moe_init(jax.random.key(1), E, FFN["d"], FFN["f"]).items():
        v = np.asarray(v)
        if k.startswith("b_"):   # nonzero biases, so their gradients are held too
            v = np.random.default_rng(3).normal(size=v.shape).astype(np.float32) * 0.1
        np.save(f"{out}/ffn_{k}.npy", v)
    np.save(f"{out}/ffn_x.npy",
            np.random.default_rng(2).normal(size=(2 * FFN["n"], FFN["d"])).astype(np.float32))
    open(f"{out}/inputs_ready", "w").close()


def _jax_ffn(out: str, ep: int, cf: float, balance) -> dict:
    """JAX's ``moe_ffn`` over all 2·n tokens: at ep 1 each half on its own (a
    rank's tokens), at ep 2 under ``shard_map``; y, aux and tallies of each
    half and the gradients of ``Σ y² + 0.01·Σ aux``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from distributed_lion_tpu.parallel.expert import moe_ffn as j_ffn
    from distributed_lion_tpu.parallel.expert import moe_param_specs

    params = {k: jnp.asarray(v.numpy()) for k, v in _ffn_params(out).items()}
    x = jnp.asarray(np.load(f"{out}/ffn_x.npy"))
    kw = {}
    if balance == "fed":
        kw["balance_tokens"] = jnp.asarray([40.0, 30.0, 20.0, 38.0, 128.0])
    elif balance == "zero":
        kw["balance_tokens"] = jnp.zeros(E + 1)
    elif balance == "axis":
        kw["balance_axis"] = "expert"
    n = FFN["n"]
    if ep == 1:
        def run(p, x):
            outs = [j_ffn(p, x[i * n:(i + 1) * n], capacity_factor=cf, axis_name=None,
                          return_tallies=True,
                          **({} if balance == "axis" else kw)) for i in range(2)]
            return (jnp.concatenate([o[0] for o in outs]), jnp.stack([o[1] for o in outs]),
                    jnp.stack([o[2] for o in outs]))
    else:
        mesh = Mesh(np.array(jax.devices()[:2]), ("expert",))

        def body(p, xs):
            y, aux, t = j_ffn(p, xs, capacity_factor=cf, axis_name="expert",
                              return_tallies=True, **kw)
            return y, aux[None], t[None]

        def run(p, x):
            return jax.shard_map(body, mesh=mesh, in_specs=(moe_param_specs(), P("expert")),
                                 out_specs=(P("expert"),) * 3, check_vma=False)(p, x)

    def loss(p, x):
        y, aux, tallies = run(p, x)
        return (y ** 2).sum() + 0.01 * aux.sum(), (y, aux, tallies)

    (_, (y, aux, tallies)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    return {"y": np.asarray(y), "aux": np.asarray(aux), "tallies": np.asarray(tallies),
            "dx": np.asarray(gx), **{f"d{k}": np.asarray(v) for k, v in gp.items()}}


def _jax_references(out: str) -> dict:
    """JAX's moe_ffn cases at ep 1 and 2, and the GPT-2-MoE trainers at each
    JAX_RUNS mesh: losses, aux, the stacked momentum after step 1, the final
    params and ring."""
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.data.sources import batch_iterator as j_batches
    from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.train.loop import TrainConfig as JTrainConfig
    from distributed_lion_tpu.train.loop import Trainer as JTrainer
    from distributed_lion_tpu.utils.serialization import load_pytree as j_load

    refs: dict = {"ffn": {(ep, name): _jax_ffn(out, ep, cf, balance)
                          for name, (cf, balance) in FFN_CASES.items() for ep in (1, 2)}}
    blocks = np.load(f"{out}/blocks.npy")
    for name, (tp, ep, depth) in JAX_RUNS.items():
        mesh = make_mesh(data=WORLD // (tp * ep), tensor=tp, expert=ep,
                         devices=jax.devices()[:WORLD])
        cfg = JTrainConfig(**COMMON, tensor_parallel=tp, expert_parallel=ep,
                           ep_dcn_pipeline=depth)
        # remat off on the JAX side only: the same values at float32, half the
        # compile; the port rematerializes, its hops recomputed in the backward
        jtr = JTrainer.for_gpt2(cfg, mesh, JGPT2.tiny(**MODEL, compute_dtype=jnp.float32,
                                                      dropout=0.0, remat=False),
                                initial_params=j_load(f"{out}/init.npz"))
        it = j_batches(blocks, jtr.global_train_batch(), seed=0)
        hist = jtr.train(it, max_steps=1)
        mom = jax.tree.map(np.asarray, jtr.state.exp_avg)
        hist += jtr.train(it, max_steps=STEPS - 1)
        refs[name] = {"losses": [h["loss"] for h in hist if "loss" in h],
                      "aux": [h["aux_loss"] for h in hist if "loss" in h], "mom": mom,
                      "params": jax.tree.map(np.asarray, jtr.params),
                      "ring": (None if jtr.state.moe_ring is None
                               else np.asarray(jtr.state.moe_ring))}
        jtr.close()
    return refs


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    """Start the four ranks, compute the JAX references meanwhile, then wait
    for the ranks: ``(their records, the JAX references, the directory)``."""
    out = tmp_path_factory.mktemp("moe")
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


@pytest.mark.parametrize("name", list(FFN_CASES))
@pytest.mark.parametrize("ep", [1, 2])
def test_moe_ffn_matches_jax(moe_run, name, ep):
    """Each half of the tokens on its rank (ep 2: its experts): y and aux
    within 1e-6, tallies equal, gradients within 1e-5 of the largest."""
    _, refs, out = moe_run
    ref = refs["ffn"][(ep, name)]
    n, half = FFN["n"], E // 2
    if ep == 1:
        cf, balance = FFN_CASES[name]
        x = torch.from_numpy(np.load(out / "ffn_x.npy"))
        runs = [_ffn_run(_ffn_params(str(out)), x[i * n:(i + 1) * n], cf,
                         None if balance == "axis" else balance) for i in range(2)]
        runs = [{k: v.numpy() for k, v in r.items()} for r in runs]
        got = {"y": np.concatenate([r["y"] for r in runs]), "aux": np.stack([r["aux"] for r in runs]),
               "tallies": np.stack([r["tallies"] for r in runs]),
               "dx": np.concatenate([r["dx"] for r in runs]),
               **{k: runs[0][k] + runs[1][k] for k in ("dgate", "dw_in", "db_in", "dw_out",
                                                       "db_out")}}
    else:
        runs = [dict(np.load(out / f"ffn_ep2_{name}_{e}.npz")) for e in range(2)]
        got = {"y": np.concatenate([r["y"] for r in runs]), "aux": np.stack([r["aux"] for r in runs]),
               "tallies": np.stack([r["tallies"] for r in runs]),
               "dx": np.concatenate([r["dx"] for r in runs]), "dgate": runs[0]["dgate"],
               **{k: np.concatenate([r[k] for r in runs]) for k in ("dw_in", "db_in", "dw_out",
                                                                    "db_out")}}
        np.testing.assert_array_equal(runs[0]["dgate"], runs[1]["dgate"])
        assert runs[0]["dw_in"].shape[0] == half
    np.testing.assert_array_equal(got["tallies"], ref["tallies"])
    _close(got["y"], ref["y"], 1e-6, "y")
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-6, atol=0)
    for k in ("dx", "dgate", "dw_in", "db_in", "dw_out", "db_out"):
        _close(got[k], ref[k], 1e-5, k)
    if name == "drop":   # the premise: capacity binds
        assert (ref["tallies"][:, :E] > capacity(n, E, 1.25)).any()


def test_moe_ffn_bf16_routing_counts_in_int32():
    """1,024 bfloat16 tokens, most on expert 0 (JAX tests/test_expert.py):
    the port's probabilities and choices equal JAX's bfloat16 routing's (its
    softmax op by op in bfloat16, as ``jax.nn.softmax``), no slot holds two tokens, each expert keeps min(count, C), and the
    output is within 0.1 of the float32 one."""
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.parallel.expert import moe_init as j_moe_init

    n, d, f, e = 1024, 6, 12, 8
    jp = j_moe_init(jax.random.key(11), e, d, f, dtype=jnp.bfloat16)
    jp["gate"] = jp["gate"].at[:, 0].add(5.0)
    jx = jax.random.normal(jax.random.key(12), (n, d), jnp.bfloat16)
    j_probs = jax.nn.softmax(jx @ jp["gate"], -1)
    j_idx = np.asarray(jnp.argmax(j_probs, -1))
    p32 = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in jp.items()}
    x32 = torch.from_numpy(np.asarray(jx, np.float32))
    p16 = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    x16 = x32.to(torch.bfloat16)
    cap = capacity(n, e, float(e))
    probs, idx, pos, keep = route(x16, p16["gate"], e, cap)
    counts = np.bincount(idx.numpy(), minlength=e)
    assert counts.max() > 256   # the premise: a bfloat16 count would collide
    np.testing.assert_array_equal(probs.float().numpy(), np.asarray(j_probs, np.float32))
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    slots = (idx * cap + pos)[keep].numpy()
    assert len(np.unique(slots)) == len(slots)
    for k in range(e):
        assert int(keep[idx == k].sum()) == min(counts[k], cap)
    tight = capacity(n, e, 1.0)
    _, idx_t, pos_t, keep_t = route(x16, p16["gate"], e, tight)
    assert [int(keep_t[idx_t == k].sum()) for k in range(e)] == [min(c, tight) for c in counts]
    assert len(np.unique((idx_t * tight + pos_t)[keep_t].numpy())) == int(keep_t.sum())
    y16, _ = moe_ffn(p16, x16, capacity_factor=float(e))
    y32, _ = moe_ffn(p32, x32, capacity_factor=float(e))
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), rtol=0.1, atol=0.1)


def test_gpt2_moe_logits_and_aux_match_jax(moe_run):
    """GPT-2-MoE tiny at float32 (the fixture's JAX init): logits within 1e-5
    and aux within 1e-6 of ``gpt2_apply``; the leaves in ``jax.tree.leaves``
    order, each MoE FFN's ``b_in, b_out, gate, w_in, w_out``; four expert
    leaves in each of the two MoE blocks."""
    import jax
    import jax.numpy as jnp

    from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2
    from distributed_lion_tpu.models.gpt2 import gpt2_apply
    from distributed_lion_tpu.utils.serialization import load_pytree as j_load

    _, _, out = moe_run
    jcfg = JGPT2.tiny(**MODEL, compute_dtype=jnp.float32)
    params = j_load(out / "init.npz")
    tokens = np.random.default_rng(1).integers(0, 256, size=(2, T)).astype(np.int32)
    logits, aux = jax.jit(lambda p, t: gpt2_apply(p, t, jcfg, return_aux=True))(
        params, jnp.asarray(tokens))
    model = GPT2(GPT2Config.tiny(**MODEL, compute_dtype=torch.float32), device="cpu")
    state = params_from_jax(params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state[name])
        got, got_aux = model(torch.from_numpy(tokens).long(), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(aux), rtol=1e-6, atol=0)
    want = [".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    names = [n for n, _ in model.jax_named_parameters()]
    assert names == want
    assert names[names.index("blocks.1.moe.b_in"):][:5] == [
        f"blocks.1.moe.{k}" for k in ("b_in", "b_out", "gate", "w_in", "w_out")]
    assert [expert_shard_dim(n) for n in names].count(0) == 4 * 2


def test_grid_layout(moe_run):
    """Rank r = ((d·tp + t)·sp + s)·ep + e."""
    recs, _, _ = moe_run
    assert [r["dp_ep"]["grid"] for r in recs] == [[r // 2, 0, r % 2] for r in range(WORLD)]
    assert [r["tp_ep"]["grid"] for r in recs] == [[0, r // 2, r % 2] for r in range(WORLD)]


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_losses_and_aux_match_jax(moe_run, name):
    recs, refs, _ = moe_run
    for rec in recs:
        assert len(rec[name]["losses"]) == STEPS
        np.testing.assert_allclose(rec[name]["losses"], refs[name]["losses"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(rec[name]["aux"], refs[name]["aux"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_momentum_matches_jax_exp_avg(moe_run, name):
    """After step 1 each rank's momentum is JAX's ``exp_avg[data rank]``
    sliced to its tensor and expert ranks."""
    recs, refs, out = moe_run
    tp, ep, _ = JAX_RUNS[name]
    for r in range(WORLD):
        d, t, e = recs[r][name]["grid"]
        mom = momentum_from_jax(refs[name]["mom"], d, tp, t, ep=ep, e=e)
        want = np.concatenate([mom[k].reshape(-1).numpy() for k in recs[r][name]["names"]])
        got = np.load(out / f"{name}_mom_{r}.npy")
        assert got.shape == want.shape == (recs[r][name]["n_params"],)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_elections_match_jax(moe_run, name):
    """The final params equal JAX's slices bit for bit, every election of
    every step the same, outside the key bias (``qkv_b[1]``): its gradient is
    zero in exact arithmetic and its ballots the signs of float noise (module
    doc), so there the params may differ, by at most 2·lr·steps."""
    recs, refs, out = moe_run
    tp, ep, _ = JAX_RUNS[name]
    for r in range(WORLD):
        _, t, e = recs[r][name]["grid"]
        state = params_from_jax(refs[name]["params"], tp, t, ep=ep, e=e)
        names = recs[r][name]["names"]
        want = np.concatenate([state[k].reshape(-1).numpy() for k in names])
        noise = np.concatenate([
            (np.arange(state[k].numel()) // (state[k].numel() // 3) == 1)
            if k.endswith("attn.qkv_b") else np.zeros(state[k].numel(), bool) for k in names])
        got = np.load(out / f"{name}_params_{r}.npy")
        np.testing.assert_array_equal(got[~noise], want[~noise])
        assert np.max(np.abs(got - want)) <= 2 * LR * STEPS * (1 + 1e-6)


def test_moe_ring_matches_jax(moe_run):
    """dp 1 x tp 2 x ep 2 at depth 2: every rank's ring equals JAX's
    ``moe_ring[0]``; both slots written (4 steps), each the expert group's
    summed tallies: 2 microbatches x 2 expert ranks x 64 lanes a block."""
    recs, refs, out = moe_run
    want = refs["tp_ep"]["ring"][0]
    assert want.shape == (2, 2, E + 1)
    for r in range(WORLD):
        np.testing.assert_array_equal(np.load(out / f"tp_ep_ring_{r}.npy"), want)
    assert (want[..., E] == 2 * 2 * 2 * T).all()
    assert (want[..., :E].sum(-1) == want[..., E]).all()


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_replicated_leaves_equal_across_expert_ranks(moe_run, name):
    """... and the trainer counts the whole model's coordinates, as JAX."""
    recs, _, _ = moe_run
    whole = sum(p.numel() for p in GPT2(GPT2Config.tiny(**MODEL), device="cpu").parameters())
    for rec in recs:
        assert rec[name]["rep_equal"] == [True] * STEPS
        assert rec[name]["n_global"] == whole > rec[name]["n_params"]


def test_ring_checkpoint_resumes_bit_identical(moe_run):
    """dp 2 x ep 2, ring depth 2: the resume from step 2 equals the
    uninterrupted run bit for bit on every rank; the step's files are a dp
    run's plus each data rank's ring, the experts whole."""
    recs, _, out = moe_run
    for rec in recs:
        res = rec["resume"]
        assert res["resumed_from"] == [3, 4] and res["losses_equal"]
        assert res["params_equal"] and res["momentum_equal"] and res["ring_equal"]
        assert res["ring_nonzero"]
    step = out / "resume_a" / "checkpoints" / "2"
    assert sorted(p.relative_to(step).as_posix() for p in step.rglob("*.pt")) == [
        "exp_avg/rank00000.pt", "exp_avg/rank00001.pt", "moe_ring/rank00000.pt",
        "moe_ring/rank00001.pt", "params.pt", "state.pt"]
    whole = GPT2(GPT2Config.tiny(moe_experts=E), device="cpu").jax_named_parameters()
    params = torch.load(step / "params.pt")
    assert params["names"] == [n for n, _ in whole]
    assert params["flat"].shape == (sum(p.numel() for _, p in whole),)
    assert torch.load(step / "moe_ring/rank00000.pt").shape == (2, 1, E + 1)
    meta = json.loads((step / "manifest.json").read_text())["meta"]
    assert meta["ep_dcn_pipeline"] == 2 and meta["expert_parallel"] == 2
    model = load_pytree(out / "resume_a" / "model.npz")
    assert model["blocks"][1]["moe"]["w_in"].shape == (E, 64, 256)


def test_dcn_ring_under_the_expert_axis_resumes(moe_run):
    """``--wire hier:1 --dcn_pipeline_depth 1`` at dp 2 x ep 2: each expert
    rank writes its own DCN ring file (its own ballot's bytes), and a rerun
    resumes from them."""
    recs, _, out = moe_run
    for rec in recs:
        assert rec["resume"]["dcn_resumed_from"] == [3]
    step = out / "resume_dcn" / "checkpoints" / "2"
    assert sorted(p.relative_to(step).as_posix() for p in (step / "dcn_ring").glob("*.pt")) == [
        f"dcn_ring/rank{d:05d}_expert{e:05d}.pt" for d in range(2) for e in range(2)]


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_in_jax_words(moe_run, name):
    recs, _, _ = moe_run
    _, _, error, match = REFUSALS[name]
    for rec in recs:
        got = rec["refusals"][name]
        assert got is not None, name
        assert got[0] == error.__name__ and re.search(match, got[1]), got


def test_expert_axis_needs_its_ranks():
    with pytest.raises(ValueError, match="--expert_parallel 2 needs 2 ranks"):
        make_grid(1, ep=2)
    with pytest.raises(ValueError, match="moe_every must be >= 1"):
        GPT2Config.tiny(moe_experts=4, moe_every=0)
