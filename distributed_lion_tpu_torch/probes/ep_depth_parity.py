"""Probe: ``chip_smoke.py``'s run (y2) (GPT-2-MoE, dp 2 x ep 2, float32
compute, capacity factor 8) at other depths and seeds, on one card.

    python -m distributed_lion_tpu_torch.probes.ep_depth_parity [LAYERS:SEED ...]

From the checkout's root (it imports ``chip_smoke``). The default runs
``4:42 4:1 4:2 12:42`` (seed 42 is the trainer's default, (y2)'s own). Each
case spawns four gloo ranks on cuda:0 that run (y2) under
``chip_smoke.gpt2_cut(LAYERS)`` with ``--seed SEED`` through
``chip_smoke.grid_one`` with no bound on the median ratios, and records
every top-1 routing decision of step 1: the trainer's first forward on each
rank's own rows, and the unsplit model's (the step-1 check's) on the data
rank's rows. Prints, for each case and data rank, the per-leaf median
momentum ratios farthest from 1, and per MoE block the tokens the two
computations sent to different experts, with the unsplit model's top-2
gate-probability margin at each; its last line is every case's record as
one JSON object.
"""

import json
import math
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_CASES = ("4:42", "4:1", "4:2", "12:42")
SHOWN_LEAVES = 6   # per-leaf ratios printed, farthest from 1 first


def ep_coordinates(cs, layers: int) -> int:
    """A rank's coordinates in (y2) at ``layers`` blocks: the embeddings and
    ``ln_f``, every block's attention and norms, the dense blocks' MLPs and
    the MoE blocks' half of the experts and whole gate (every second block,
    from block 1)."""
    cfg = cs.GPT2Config.gpt2_124m()
    d, moe = cfg.d_model, layers // 2
    mlp = 8 * d * d + 5 * d
    return (cfg.vocab_size * d + cfg.n_ctx * d + 2 * d + layers * (4 * d * d + 8 * d)
            + (layers - moe) * mlp + moe * (cs.MOE_E // 2 * mlp + d * cs.MOE_E))


def rank_main(rank: int, tmp: str, layers: int, seed: int) -> None:
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from distributed_lion_tpu_torch.cli import run_clm
    from distributed_lion_tpu_torch.parallel import expert

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=cs.W4)
    calls = {"trainer": [], "unsplit": [], "done": []}
    phase = ["trainer"]
    route, dense_grad = expert.route, cs.dense_grad

    def recording_route(x, gate, n_experts, cap, valid=None):
        out = route(x, gate, n_experts, cap, valid)
        top2 = torch.topk(out[0].detach().float(), 2, dim=-1).values
        calls[phase[0]].append((out[1].cpu(), (top2[:, 0] - top2[:, 1]).cpu()))
        return out

    def recording_dense_grad(*args, **kw):
        phase[0] = "unsplit"
        try:
            return dense_grad(*args, **kw)
        finally:
            phase[0] = "done"

    expert.route, cs.dense_grad = recording_route, recording_dense_grad
    args = cs.Y2_ARGS + ["--seed", str(seed)]
    try:
        with cs.gpt2_cut(layers):
            rec = cs.grid_one(rank, f"(y2) at {layers} blocks, seed {seed}",
                              lambda: (run_clm.main(args), 3, None), ep_coordinates(cs, layers),
                              cs.no_flash, tol=math.inf)
        moe = layers // 2   # the first forward's calls, one an MoE block
        torch.save({"dp": rec["dp"], "losses": rec["losses"],
                    "trainer": calls["trainer"][:moe], "unsplit": calls["unsplit"][:moe]},
                   f"{tmp}/rank{rank}.pt")
    finally:
        expert.route, cs.dense_grad = route, dense_grad
        dist.destroy_process_group()


def report(tmp: str, layers: int, seed: int, world: int, ep: int, card: str) -> dict:
    recs = [torch.load(f"{tmp}/rank{r}.pt") for r in range(world)]
    out = {"layers": layers, "seed": seed, "data_ranks": []}
    for d in range(world // ep):
        mine = recs[d * ep: (d + 1) * ep]
        dp, unsplit = mine[0]["dp"], mine[0]["unsplit"]
        leaves = sorted(((abs(v - 1), k, v) for k, v in dp["per_leaf"].items() if v is not None),
                        reverse=True)[:SHOWN_LEAVES]
        blocks = []
        for b, (u_idx, u_margin) in enumerate(unsplit):
            t_idx = torch.cat([m["trainer"][b][0] for m in mine])
            t_margin = torch.cat([m["trainer"][b][1] for m in mine])
            differ = torch.nonzero(t_idx != u_idx).flatten()
            blocks.append({"tokens": int(u_idx.numel()), "differ": int(differ.numel()),
                           "unsplit_margin_at": [float(u_margin[i]) for i in differ[:8]],
                           "ep_margin_at": [float(t_margin[i]) for i in differ[:8]],
                           "min_margin": float(u_margin.min())})
        row = {"data_rank": d, "losses": mine[0]["losses"],
               "median_ratio": dp["median_ratio"], "max_abs_diff": dp["max_abs_diff"],
               "max_abs": dp["max_abs"], "equal_ballots": dp["equal_ballots"],
               "farthest_leaves": [(k, v) for _, k, v in leaves], "moe_blocks": blocks}
        out["data_ranks"].append(row)
        print(f"[ep-depth] (y2) at {layers} blocks, --seed {seed}, data rank {d}: per-leaf "
              f"median momentum ratio in [{dp['median_ratio'][0]:.6f}, "
              f"{dp['median_ratio'][1]:.6f}], max |diff| {dp['max_abs_diff']:.3e} (max |m| "
              f"{dp['max_abs']:.3e}), equal ballots {dp['equal_ballots']:.6f}; farthest leaves "
              f"{[(k, round(v, 6)) for _, k, v in leaves]}; routing, ep against unsplit, by MoE "
              f"block (tokens sent elsewhere, the unsplit top-2 margin there, the least margin "
              f"of any token): "
              f"{[(x['differ'], x['unsplit_margin_at'], x['min_margin']) for x in blocks]}; "
              f"on {card}", flush=True)
    return out


def main(argv=None) -> None:
    sys.path.insert(0, ".")
    import chip_smoke as cs

    cases = [tuple(int(v) for v in c.split(":")) for c in (argv or sys.argv[1:] or DEFAULT_CASES)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    cs.build_cuda_kernels()
    results = []
    for layers, seed in cases:
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(rank_main, args=(tmp, layers, seed), nprocs=cs.W4, join=True)
            results.append(report(tmp, layers, seed, cs.W4, 2, card))
    print(json.dumps({"card": card, "cases": results}), flush=True)


if __name__ == "__main__":
    main()
