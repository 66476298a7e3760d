"""Probe: ``chip_smoke.py``'s sequence-parallel phases alone, on one card.

    python -m distributed_lion_tpu_torch.probes.seq_parallel_phases

From the checkout's root (it imports ``chip_smoke``, a script at the root,
not a module of the package). It builds the kernels, holds the optimizer
kernels to their plain versions at the seq-parallel runs' windows
(``chip_smoke.SP_DTYPES``), runs (c) and (c-dots) in a 1-rank NCCL group,
then spawns four gloo ranks on cuda:0 that run (v1)-(x2) (``sp_runs``) and
prints their ``[w4]`` lines: about 4 minutes of command, where the whole
script takes about 13.
"""

import json
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, tmp: str) -> None:
    import chip_smoke as cs

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg4", rank=rank,
                            world_size=cs.W4)
    try:
        rec = cs.sp_runs(rank)
        if rank == 0:
            with open(f"{tmp}/sp.json", "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def main() -> None:
    sys.path.insert(0, ".")
    import chip_smoke as cs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rates = cs.card_rates(torch.cuda.get_device_name(0))
    t = time.perf_counter()
    cs.build_cuda_kernels()
    t = cs.phase_time("build", t)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.optimizer_kernel_phase(gen, rates, ns=tuple(cs.SP_DTYPES), big=False)
    t = cs.phase_time("optimizer kernels at the seq-parallel windows", t)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1)
        try:
            torch.cuda.reset_peak_memory_stats()
            plain, rows, launches = cs.run_counted(["--dropout", "0"])
            peak = torch.cuda.max_memory_allocated()
            end = (plain.flat.params.detach().cpu(), plain.state.exp_avg.cpu())
            del plain
            torch.cuda.empty_cache()
            cs.dots_run(end, rows, launches, peak, card)
        finally:
            dist.destroy_process_group()
        t = cs.phase_time("(c), (c-dots)", t)
        torch.cuda.empty_cache()
        mp.spawn(_rank, args=(tmp,), nprocs=cs.W4, join=True)
        with open(f"{tmp}/sp.json") as f:
            cs.sp_report(json.load(f), card)
        cs.phase_time("(v1)-(x2)", t)


if __name__ == "__main__":
    main()
