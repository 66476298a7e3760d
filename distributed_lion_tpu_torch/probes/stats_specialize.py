"""Probe: the ``bucket_vote_stats`` kernel built with ``world`` specialized.

    python -m distributed_lion_tpu_torch.probes.stats_specialize

Triton turns an integer argument equal to 1 into a compile-time constant.
The stats kernel of ``ops/fused_lion.py`` is built with
``do_not_specialize=["world"]`` because the specialized build counted half
the coordinates at ``world == 1`` on an H100 (torch 2.11, triton 3.6.0).
This probe builds the same kernel body both ways and runs each at
n = 124,439,808 and 70,000, for a vote of 1 (the tally is the ballots)
and of 2, against the plain version. It prints one line per case and a
last line saying whether the specialized build still disagrees; it exits
0 either way, and 1 if the shipped (unspecialized) build disagrees.
"""

import sys

import torch

from distributed_lion_tpu_torch.ops import fused_lion

NBINS = 8


def _run(kernel, ballots, total, world):
    n = ballots.numel()
    out = torch.zeros(NBINS + 1, dtype=torch.int32, device=ballots.device)
    kernel[(fused_lion.triton.cdiv(n, fused_lion.STATS_BLOCK),)](
        ballots, total, out, n, world, NBINS=NBINS, BLOCK=fused_lion.STATS_BLOCK,
        num_warps=fused_lion.NUM_WARPS)
    torch.cuda.synchronize()
    return out.tolist()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stats_specialize: CUDA is not available")
    shipped = fused_lion._kernels()["stats"]
    specialized = fused_lion.triton.jit(shipped.fn)  # the same body, world specialized
    gen = torch.Generator(device="cuda").manual_seed(0)
    spec_wrong = ship_wrong = False
    for n in (124_439_808, 70_000):
        ballots = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 1, -1
                              ).to(torch.int8)
        for world in (1, 2):
            total = ballots.clone() if world == 1 else (
                2 * torch.randint(0, 2, (n,), generator=gen, device="cuda") * ballots
            ).to(torch.int8)
            hist, dis = fused_lion.bucket_vote_stats_plain(ballots, total, world, NBINS)
            plain = hist.tolist() + [int(dis)]
            got = {"specialized": _run(specialized, ballots, total, world),
                   "shipped": _run(shipped, ballots, total, world)}
            spec_wrong |= got["specialized"] != plain
            ship_wrong |= got["shipped"] != plain
            print(f"n={n} world={world} plain {plain} {got}", flush=True)
    print(f"specialized build disagrees with plain: {spec_wrong}; "
          f"shipped build disagrees: {ship_wrong}; torch {torch.__version__}, "
          f"triton {fused_lion.triton.__version__}", flush=True)
    return 1 if ship_wrong else 0


if __name__ == "__main__":
    sys.exit(main())
