"""Probe: ``chip_smoke.py``'s pipeline-parallel phase alone, on one card.

    python -m distributed_lion_tpu_torch.probes.pipeline_phases

From the checkout's root (it imports ``chip_smoke``, a script at the root,
not a module of the package). It builds the kernels, holds the optimizer
kernels to their plain versions at the pipelined runs' windows
(``chip_smoke.PP_DTYPES`` and (z4)'s ``N_PP_LLAMA3``) and the flash kernels
to the float64 criterion at their microbatches' shapes, then spawns four
gloo ranks on cuda:0 that run (z1)-(z4) (``chip_smoke.pp_phase``) and
prints their ``[pp]`` lines.
"""

import subprocess
import sys
import tempfile
import time

import torch


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
    regs = cs.build_cuda_kernels()
    t = cs.phase_time("build", t)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.optimizer_kernel_phase(gen, rates, ns=(*cs.PP_DTYPES, cs.N_PP_LLAMA3), big=False)
    t = cs.phase_time("optimizer kernels at the pipelined windows", t)
    cs.flash_kernel_phase(gen, rates, regs, 64, 1, 12, 1024, (), "qkv", ((1, 6, 1024),))
    cs.flash_kernel_phase(gen, rates, regs, 128, 1, 32, 2048, (), "", ())
    t = cs.phase_time("flash kernels at the microbatches' shapes", t)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        print(f"[pp] launches summed over the runs: {cs.pp_phase(tmp, card)}", flush=True)
    cs.phase_time("(z1)-(z4)", t)


if __name__ == "__main__":
    main()
