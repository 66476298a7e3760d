"""Smoke run of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (none of their failures is caught; any one fails the run):

1. Card check: CUDA must be present; prints the card's name and power limit.
2. Kernel phase: each hand-written kernel of the training path
   (``ops/fused_lion.py``) against its plain PyTorch version on the card,
   at the main path's size (GPT-2 124M, 124,439,808 coordinates) and at a
   ragged 1,000,003, for float32 and bfloat16 params and int8 and int32
   tallies. Outputs must be ``torch.equal``. Times are medians of 25 runs
   with CUDA events, beside the byte bound (bytes moved ÷ the card's
   data-sheet bandwidth) and the plain version's time.
3. Slice phase: ``cli.run_clm.main`` trains GPT-2 124M at full width
   (T=1024, float32 params, bfloat16 compute, dropout 0.1, remat) for 3
   steps on synthetic data with ``--lion --async_grad --wire auto``, inside
   a 1-rank NCCL process group so the vote's all_reduce runs. Every step's
   loss must be finite and each kernel's launch count must equal steps ×
   vote buckets. Before it, in the same group, each of the three flat vote
   wires must return the rank's own ballots as the tally (a vote over one
   rank), and a tiny float32 model's logits on the card must match the
   CPU's. The float32-result products of the tied head and the attention
   scores (``ops/products.py``) must agree with float64 products of the
   same bfloat16 operands to 1/16 of a bfloat16 ulp of the largest value.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import statistics
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.cli import run_clm
from distributed_lion_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_lion_tpu_torch.ops import fused_lion
from distributed_lion_tpu_torch.ops.codec import bucket_bounds
from distributed_lion_tpu_torch.ops.products import matmul_f32
from distributed_lion_tpu_torch.parallel import collectives

N_MAIN = 124_439_808   # GPT-2 124M coordinates: the main path's window
N_RAGGED = 1_000_003
STEPS = 3
RUNS = 25

# data-sheet HBM bandwidth, bytes/s (NVIDIA data sheets)
BANDWIDTH = [("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
             ("H100", 3.35e12)]


def card_bandwidth(name: str) -> float:
    for key, bw in BANDWIDTH:
        if all(part in name for part in key.split()):
            return bw
    raise RuntimeError(f"no data-sheet bandwidth known for {name!r}")


def time_ms(fn, runs=RUNS) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` launches, after three
    warm-up calls."""
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(runs)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_phase(gen, bw):
    """Compare and time both kernels; returns per-kernel records at the main
    path's shape (float32, int8 tally) and the max error over all cases."""
    rec = {}
    err = {"fused_ballots": 0.0, "fused_apply": 0.0}
    for n in (N_MAIN, N_RAGGED):
        for pdt in (torch.float32, torch.bfloat16):
            mdt = pdt
            g = torch.randn(n, generator=gen, device="cuda").to(mdt)
            m = torch.randn(n, generator=gen, device="cuda").to(mdt)
            p = torch.randn(n, generator=gen, device="cuda").to(pdt)
            lr = torch.tensor(3e-4, device="cuda")
            mb = m.element_size()

            ballots = fused_lion.fused_ballots(g, m, 0.9)
            plain = fused_lion.fused_ballots_plain(g, m, 0.9)
            torch.cuda.synchronize()
            if not torch.equal(ballots, plain):
                raise AssertionError(f"fused_ballots != plain at n={n} {mdt}: "
                                     f"{(ballots != plain).sum().item()} differ")
            err["fused_ballots"] = max(err["fused_ballots"],
                                       (ballots.int() - plain.int()).abs().max().item())
            ms = time_ms(lambda: fused_lion.fused_ballots(g, m, 0.9))
            plain_ms = time_ms(lambda: fused_lion.fused_ballots_plain(g, m, 0.9))
            bound = 1e3 * n * (2 * mb + 1) / bw
            print(f"[kernel] fused_ballots n={n} {str(mdt)[6:]}: {ms:.4f} ms "
                  f"(bound {bound:.4f} ms, plain {plain_ms:.4f} ms)", flush=True)
            if n == N_MAIN and pdt == torch.float32:
                rec["fused_ballots"] = (ms, plain_ms, bound)

            for tdt in (torch.int8, torch.int32):
                tot = torch.randint(-3, 4, (n,), generator=gen, device="cuda",
                                    dtype=tdt)
                pk, mk = p.clone(), m.clone()
                fused_lion.fused_apply(pk, g, mk, tot, lr, 0.1, 0.99)
                pp, mp = fused_lion.fused_apply_plain(p, g, m, tot, lr, 0.1, 0.99)
                torch.cuda.synchronize()
                if not (torch.equal(pk, pp) and torch.equal(mk, mp)):
                    raise AssertionError(
                        f"fused_apply != plain at n={n} {pdt} tally {tdt}: "
                        f"{(pk != pp).sum().item()} params, "
                        f"{(mk != mp).sum().item()} momenta differ")
                err["fused_apply"] = max(
                    err["fused_apply"],
                    (pk.float() - pp.float()).abs().max().item(),
                    (mk.float() - mp.float()).abs().max().item())
                del pp, mp
                ms = time_ms(lambda: fused_lion.fused_apply(pk, g, mk, tot, lr, 0.1, 0.99))
                plain_ms = time_ms(
                    lambda: fused_lion.fused_apply_plain(p, g, m, tot, lr, 0.1, 0.99))
                bound = 1e3 * n * (2 * p.element_size() + 2 * mb + mb
                                   + tot.element_size()) / bw
                print(f"[kernel] fused_apply n={n} {str(pdt)[6:]} tally "
                      f"{str(tdt)[6:]}: {ms:.4f} ms (bound {bound:.4f} ms, "
                      f"plain {plain_ms:.4f} ms)", flush=True)
                if n == N_MAIN and pdt == torch.float32 and tdt == torch.int8:
                    rec["fused_apply"] = (ms, plain_ms, bound)
                del tot, pk, mk
            del g, m, p
            torch.cuda.empty_cache()
    return rec, err


def model_check():
    """A tiny float32 GPT-2's logits on the card against the CPU's."""
    cfg = GPT2Config.tiny(compute_dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        cpu = GPT2(cfg, device="cpu", seed=3)(tokens)
        gpu = GPT2(cfg, device="cuda", seed=3)(tokens.cuda()).cpu()
    if gpu.shape != (2, 32, cfg.vocab_size) or not torch.allclose(gpu, cpu, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"tiny GPT-2 logits differ card vs CPU by "
                             f"{(gpu - cpu).abs().max().item()}")


def product_check(gen):
    """``matmul_f32`` on the card at the slice's shapes (one microbatch's
    tied head and attention scores, bfloat16 operands, values of a few
    units to a few tens, as GPT-2's logits reach) against float64 products
    of the same operands."""
    x = torch.randn(8, 1024, 768, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(768, 50257, generator=gen, device="cuda") * 0.1).bfloat16()
    q = torch.randn(8, 12, 1024, 64, generator=gen, device="cuda").bfloat16()
    k = torch.randn(8, 12, 64, 1024, generator=gen, device="cuda").bfloat16()
    for name, a, b in (("head", x, w), ("scores", q, k)):
        got = matmul_f32(a, b)
        want = torch.matmul(a.double(), b.double())
        err = (got.double() - want).abs().max().item()
        top = want.abs().max().item()
        if got.dtype != torch.float32 or err > 2.0 ** -12 * top:
            raise AssertionError(f"matmul_f32 {name}: {got.dtype}, max err {err} at max |value| {top}")
        print(f"[product] {name} {tuple(got.shape)}: max err {err:.3e} at max |value| {top:.2f}",
              flush=True)
        del got, want


def wire_check(gen):
    """Each flat wire over the 1-rank NCCL group: the tally of the rank's
    own card ballots is those ballots, and no byte crosses a link."""
    for n in (N_MAIN, N_RAGGED):
        ballots = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 1, -1
                              ).to(torch.int8)
        for wire in ("sign_psum", "packed_allgather", "packed_a2a"):
            tally = collectives.WireTally()
            tot = collectives.vote_total(ballots, wire, dist.group.WORLD, tally)
            if not (tot.is_cuda and torch.equal(tot.to(torch.int32), ballots.to(torch.int32))
                    and tally.total() == 0):
                raise AssertionError(f"wire {wire} at n={n}: the 1-rank tally is not "
                                     f"the ballots (bytes {tally.total()})")
            print(f"[wire] {wire} n={n}: 1-rank tally == ballots", flush=True)
            del tot


def slice_phase(tmp, gen):
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1)
    try:
        wire_check(gen)
        fused_lion.fused_ballots.launches = 0
        fused_lion.fused_apply.launches = 0
        trainer = run_clm.main([
            "--model_name", "gpt2_124m", "--dataset", "synthetic",
            "--lion", "--async_grad", "--wire", "auto",
            "--per_device_train_batch_size", "8", "--gradient_accumulation_steps", "2",
            "--block_size", "1024", "--max_steps", str(STEPS), "--logging_steps", "1",
            "--synthetic_blocks", "256", "--per_device_eval_batch_size", "8",
            "--eval_iters", "2"])
        launches = {"fused_ballots": fused_lion.fused_ballots.launches,
                    "fused_apply": fused_lion.fused_apply.launches}
    finally:
        dist.destroy_process_group()
    cfg = trainer.cfg
    buckets = len(bucket_bounds(trainer.n_params, cfg.vote_buckets, trainer.world, cfg.wire))
    rows = [r for r in trainer.history if "loss" in r]
    if len(rows) != STEPS or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"expected {STEPS} finite losses, got {rows}")
    for name, count in launches.items():
        if count != STEPS * buckets:
            raise AssertionError(f"{name} launched {count} times on the main path, "
                                 f"expected {STEPS} steps x {buckets} buckets")
    return trainer, rows, launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    bw = card_bandwidth(name)
    print(f"[card] {name}: {torch.__version__}, CUDA {torch.version.cuda}, "
          f"data-sheet bandwidth {bw / 1e12:.2f} TB/s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rec, err = kernel_phase(gen, bw)
    print(f"[card] kernels built with triton {fused_lion.triton.__version__}", flush=True)
    model_check()
    product_check(gen)
    with tempfile.TemporaryDirectory() as tmp:
        trainer, rows, launches = slice_phase(tmp, gen)
    step_ms = statistics.median(r["step_ms"] for r in rows[1:])
    tok_s = statistics.median(r["tokens_per_sec"] for r in rows[1:])
    print(f"[slice] GPT-2 124M, {trainer.world} rank, wire {trainer.cfg.wire}, "
          f"{trainer.cfg.vote_buckets} bucket(s), losses "
          f"{[round(r['loss'], 4) for r in rows]}: 3-step smoke, steps 2-{STEPS} "
          f"median {step_ms:.1f} ms/step, {tok_s:.0f} tokens/s on {card}", flush=True)

    sources = {"fused_ballots": "distributed_lion_tpu/ops/pallas_lion.py:84",
               "fused_apply": "distributed_lion_tpu/ops/pallas_lion.py:118"}
    kernels = [{"name": k, "route": "triton",
                "source": "distributed_lion_tpu_torch/ops/fused_lion.py",
                "replaces": sources[k], "launches": launches[k],
                "max_abs_err": err[k], "ms": rec[k][0], "plain_ms": rec[k][1],
                "bound_ms": rec[k][2], "bound_by": "bytes", "library_ms": None}
               for k in ("fused_ballots", "fused_apply")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
