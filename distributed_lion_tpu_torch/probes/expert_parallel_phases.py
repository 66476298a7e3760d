"""Probe: ``chip_smoke.py``'s expert-parallel phases alone, on one card.

    python -m distributed_lion_tpu_torch.probes.expert_parallel_phases

From the checkout's root (it imports ``chip_smoke``, a script at the root,
not a module of the package). It builds the kernels, holds the optimizer
kernels to their plain versions at the MoE runs' windows
(``chip_smoke.MOE_DTYPES``), runs (y1) in a 1-rank NCCL group, then spawns
four gloo ranks on cuda:0 that run (y2) and (y3) (``chip_smoke.ep_phase``)
and prints their ``[w4]`` lines.
"""

import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist


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
    cs.optimizer_kernel_phase(gen, rates, ns=tuple(cs.MOE_DTYPES), big=False)
    t = cs.phase_time("optimizer kernels at the MoE windows", t)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1)
        try:
            rows, launches, peak = cs.moe_one_rank(gen, card)
        finally:
            dist.destroy_process_group()
        print(f"[slice] (y1) GPT-2-MoE: losses {[round(r['loss'], 4) for r in rows]}: steps 2-"
              f"{len(rows)} {[r['step_ms'] for r in rows[1:]]} ms, "
              f"{[round(r['tokens_per_sec']) for r in rows[1:]]} tokens/s; peak device memory "
              f"{peak / 2**30:.2f} GiB on {card}; launches {launches}", flush=True)
        t = cs.phase_time("(y1)", t)
        torch.cuda.empty_cache()
        cs.ep_phase(tmp, card)
        cs.phase_time("(y2), (y3)", t)


if __name__ == "__main__":
    main()
