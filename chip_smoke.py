"""Smoke run of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (none of their failures is caught; any one fails the run):

1. Card check: CUDA must be present; prints the card's name and power limit.
   The CUDA kernels (``csrc/flash_attention.cu`` with ``csrc/hopper.cuh``)
   are built with ``nvcc`` into ``build/cuda/`` first, and the compiler's
   per-kernel register and spill report is printed. The forward and dK/dV
   kernels must spill no byte, and ``cuobjdump -sass`` of the library must
   show ``HGMMA`` (wgmma), ``UTMALDG`` (TMA loads) and no ``HMMA``
   (``mma.sync``, as ``nvcuda::wmma`` compiles) in each of them; the
   counts are printed for the dQ kernel too.
2. Kernel phase, optimizer: each Triton kernel (``ops/fused_lion.py``)
   against its plain PyTorch version on the card, at the main path's size
   (GPT-2 124M, 124,439,808 coordinates) and at a ragged 1,000,003:
   ``fused_ballots`` and ``fused_apply`` for float32 and bfloat16 params and
   int8 and int32 tallies, ``bucket_vote_stats`` for a vote of 1 (int8
   tally) and of 4 (int8 and int32). Outputs must be ``torch.equal``.
3. Kernel phase, attention: the three flash kernels
   (``ops/flash_attention.py``) at the main path's shape (B 8, H 12,
   T 1024, head_dim 64, bfloat16, q/k/v/do as transposed views), at a
   ragged T = 1000, and at B 2, H 3 with T 40 (shorter than one tile) and
   130, against the plain versions and against a float64
   reference built from the same bfloat16 inputs. Criterion: for every
   output X (o, lse, dq, dk, dv),
   ``max|X_kernel - X_f64| <= 2 * max|X_plain - X_f64| + slack``, where
   slack is half a bfloat16 ulp of ``max|X_f64|`` for the bfloat16 outputs
   and four float32 ulps of it for the float32 ``lse``. The backward
   kernels run twice: on the plain forward's o and lse (the plain
   backward's inputs), and on the forward kernel's own o and lse, as
   training chains them; both are held to the plain backward's error.
   Each kernel called twice on the same inputs must give the same bits
   (``torch.equal``). ``torch.nn.functional.scaled_dot_product_attention``
   is timed beside them as the library yardstick (the port never calls
   it): the forward, and the backward with a fresh graph for each timed
   call (its forward runs before the start event), each as median and
   minimum. Each kernel's TFLOP/s is its causal operations over its time.
4. Slice phase, in one 1-rank NCCL process group: each flat vote wire must
   return the rank's own ballots as the tally; then ``cli.run_clm.main``
   trains GPT-2 124M at full width (T = 1024, float32 params, bfloat16
   compute, remat) for 3 steps of batch 8 x accumulation 2 and evaluates 2
   batches, twice: (a) the default run (dropout 0.1: training takes the
   materialized-scores branch, eval takes flash) and (b) the main path of
   this slice, ``--dropout 0 --telemetry``. Every kernel's launch counter
   is set to 0 just before each run and read just after. (a): finite
   losses, optimizer kernels steps x buckets, flash forward n_layer x eval
   batches, no backward kernel. (b): finite losses; flash forward
   n_layer x accum x 2 (remat) x steps + n_layer x eval batches; dK/dV and
   dQ n_layer x accum x steps each; ``bucket_vote_stats`` and the optimizer
   kernels steps x buckets; ``vote/hist_mass == 1`` and
   ``vote/disagree_frac == 0`` (a vote of one rank). After (b) the trained
   model's eval loss through flash must be finite and within 0.002 of its
   eval loss through ``attention_xla``. (c) ``--dropout 0`` alone: (b)'s
   flash counts and no ``bucket_vote_stats``, so (b) - (c) is the cost of
   telemetry. After (c), ``torch.profiler`` traces one forward + backward
   microbatch of (c)'s model (B 8, T 1024, bfloat16 compute, dropout 0,
   remat), recording device activity only, and prints the ten device
   kernels with the most time and the flash kernels wherever they rank
   (total ms, calls), and the device's idle
   share over the traced window (1 - the union of device activity over
   the window from the first to the last device event), beside three
   unprofiled microbatches timed on the host clock. The wire check also times ``sign_psum`` at the main path's
   size with and without the copy that keeps the ballots (telemetry's
   case). Before the runs a tiny float32
   model's logits on the card must match the CPU's, and the float32-result
   products (``ops/products.py``) must agree with float64 products of the
   same bfloat16 operands to 1/16 of a bfloat16 ulp of the largest value.

Times are medians of 25 CUDA-event runs after 3 warm-up calls, queued
while the card sleeps (``torch.cuda._sleep``) so that they time the card's
work and not the host's launches. Bounds are
the larger of bytes moved (each input read once, each output written once)
over the card's data-sheet bandwidth and the operations done (causal
products counted over the pairs k <= q only) over its data-sheet bfloat16
tensor rate. The line before the last is the per-kernel JSON record; the
last line is ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from distributed_lion_tpu_torch.cli import run_clm
from distributed_lion_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_lion_tpu_torch.models.loss import clm_loss_and_metrics
from distributed_lion_tpu_torch.ops import cuda_build, fused_lion
from distributed_lion_tpu_torch.ops import flash_attention as fa
from distributed_lion_tpu_torch.ops.codec import bucket_bounds
from distributed_lion_tpu_torch.ops.products import matmul_f32
from distributed_lion_tpu_torch.parallel import collectives

N_MAIN = 124_439_808   # GPT-2 124M coordinates: the main path's window
N_RAGGED = 1_000_003
FLASH_B, FLASH_H, FLASH_D = 8, 12, 64   # the slice's microbatch at GPT-2 width
FLASH_TS = (1024, 1000)                 # the main path's T, and a ragged one
FLASH_SMALL = ((2, 3, 40), (2, 3, 130))  # (B, H, T): shorter than one tile, one tile and a bit
STEPS = 3
ACCUM = 2
EVAL_BATCHES = 2
N_LAYER = 12
RUNS = 25
AHEAD_CYCLES = 50_000_000   # about 30 ms of the card's clock: the host queues the timed calls

# data-sheet HBM bandwidth (bytes/s) and dense bfloat16 tensor rate (FLOP/s)
CARDS = [("H200", 4.8e12, 989e12), ("H100 PCIe", 2.0e12, 756e12),
         ("H100 NVL", 3.9e12, 835e12), ("H100", 3.35e12, 989e12)]

# the kernels redesigned for Hopper (TMA ring, wgmma): their SASS must show
# both, and mma.sync nowhere
HOPPER_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel")
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")
PROFILE_TOP = 10

KERNELS = ("fused_ballots", "fused_apply", "bucket_vote_stats", "flash_attention_fwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
WRAPPERS = {"fused_ballots": fused_lion.fused_ballots, "fused_apply": fused_lion.fused_apply,
            "bucket_vote_stats": fused_lion.bucket_vote_stats,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq}
ROUTES = {
    "fused_ballots": ("triton", "distributed_lion_tpu_torch/ops/fused_lion.py",
                      "distributed_lion_tpu/ops/pallas_lion.py:84"),
    "fused_apply": ("triton", "distributed_lion_tpu_torch/ops/fused_lion.py",
                    "distributed_lion_tpu/ops/pallas_lion.py:118"),
    "bucket_vote_stats": ("triton", "distributed_lion_tpu_torch/ops/fused_lion.py",
                          "distributed_lion_tpu/ops/pallas_lion.py:233"),
    "flash_attention_fwd": ("cuda", "distributed_lion_tpu_torch/csrc/flash_attention.cu",
                            "jax/experimental/pallas/ops/tpu/flash_attention.py:589"),
    "flash_attention_bwd_dkv": ("cuda", "distributed_lion_tpu_torch/csrc/flash_attention.cu",
                                "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
    "flash_attention_bwd_dq": ("cuda", "distributed_lion_tpu_torch/csrc/flash_attention.cu",
                               "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
}


def card_rates(name: str) -> tuple[float, float]:
    for key, bw, flops in CARDS:
        if all(part in name for part in key.split()):
            return bw, flops
    raise RuntimeError(f"no data-sheet rates known for {name!r}")


def time_ms(fn, runs=RUNS) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` launches, after three
    warm-up calls; the card sleeps while the host queues them."""
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(runs)]
    torch.cuda._sleep(AHEAD_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def time_fresh_ms(setup, fn, runs=RUNS) -> tuple[float, float]:
    """(median, minimum) CUDA-event time of ``fn(setup())`` over ``runs``
    calls, each after its own ``setup()``, which is not timed (its work is
    queued before the start event, and the card sleeps while the host
    queues the call), after three warm-up calls."""
    for _ in range(3):
        fn(setup())
    times = []
    for _ in range(runs):
        arg = setup()
        torch.cuda._sleep(AHEAD_CYCLES // 16)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in times]
    return statistics.median(ms), min(ms)


def bound(nbytes: float, flops: float, rates) -> tuple[float, str]:
    """(least ms, what bounds it) for ``nbytes`` moved and ``flops`` done."""
    bw, peak = rates
    t_bytes, t_ops = 1e3 * nbytes / bw, 1e3 * flops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_cuda_kernels():
    """Build the flash library; check the redesigned kernels' spills and
    SASS."""
    t0 = time.perf_counter()
    lib = cuda_build.build(cuda_build.CSRC / "flash_attention.cu")
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = lib.with_suffix(".log").read_text()
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "warning" in line):
            print(f"[build] {line.strip()}", flush=True)
    spills = cuda_build.ptxas_spills(log)
    for kernel in HOPPER_KERNELS:
        found = [v for name, v in spills.items() if kernel in name]
        if len(found) != 1 or found[0] != (0, 0):
            raise AssertionError(f"{kernel}: spill bytes (stores, loads) {found} in the ptxas "
                                 "report, expected one entry of (0, 0)")
    counts = cuda_build.sass_counts(lib, HOPPER_KERNELS + ("flash_bwd_dq_kernel",), SASS_OPS)
    for kernel, ops in counts.items():
        print(f"[sass] {kernel}: " + ", ".join(f"{op} {n}" for op, n in ops.items()),
              flush=True)
    for kernel in HOPPER_KERNELS:
        ops = counts[kernel]
        if ops["HGMMA"] == 0 or ops["UTMALDG"] == 0 or ops["HMMA"] != 0:
            raise AssertionError(f"{kernel}: SASS {ops}: expected wgmma (HGMMA) and TMA loads "
                                 "(UTMALDG), and no mma.sync (HMMA)")


def optimizer_kernel_phase(gen, rates):
    """Compare and time the three Triton kernels; returns per-kernel records
    at the main path's shape (float32, int8 tally) and the max error over
    all cases."""
    rec = {}
    err = {"fused_ballots": 0.0, "fused_apply": 0.0, "bucket_vote_stats": 0.0}
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
            bms, by = bound(n * (2 * mb + 1), 0, rates)
            print(f"[kernel] fused_ballots n={n} {str(mdt)[6:]}: {ms:.4f} ms "
                  f"(bound {bms:.4f} ms, plain {plain_ms:.4f} ms)", flush=True)
            if n == N_MAIN and pdt == torch.float32:
                rec["fused_ballots"] = (ms, plain_ms, bms, by, None)

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
                bms, by = bound(n * (2 * p.element_size() + 2 * mb + mb
                                     + tot.element_size()), 0, rates)
                print(f"[kernel] fused_apply n={n} {str(pdt)[6:]} tally "
                      f"{str(tdt)[6:]}: {ms:.4f} ms (bound {bms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms)", flush=True)
                if n == N_MAIN and pdt == torch.float32 and tdt == torch.int8:
                    rec["fused_apply"] = (ms, plain_ms, bms, by, None)
                del tot, pk, mk
            del g, m, p
            torch.cuda.empty_cache()

        ballots = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 1, -1
                              ).to(torch.int8)
        # a vote of 1 (the smoke's: the tally is the ballots) and of 4
        # (tallies in {-4, -2, 0, 2, 4}), int8 and int32 tallies
        for world, tdt in ((1, torch.int8), (4, torch.int8), (4, torch.int32)):
            tot = (ballots.clone() if world == 1 else
                   2 * torch.randint(0, 5, (n,), generator=gen, device="cuda") - 4).to(tdt)
            hist, dis = fused_lion.bucket_vote_stats(ballots, tot, world, 8)
            hp, dp = fused_lion.bucket_vote_stats_plain(ballots, tot, world, 8)
            torch.cuda.synchronize()
            if not (torch.equal(hist, hp) and torch.equal(dis, dp)):
                raise AssertionError(f"bucket_vote_stats != plain at n={n} W={world} tally "
                                     f"{tdt}: {hist.tolist()} {dis.item()} vs {hp.tolist()} "
                                     f"{dp.item()}")
            err["bucket_vote_stats"] = max(
                err["bucket_vote_stats"], (hist - hp).abs().max().item(), abs(dis.item() - dp.item()))
            ms = time_ms(lambda: fused_lion.bucket_vote_stats(ballots, tot, world, 8))
            plain_ms = time_ms(lambda: fused_lion.bucket_vote_stats_plain(ballots, tot, world, 8))
            bms, by = bound(n * (1 + tot.element_size()), 0, rates)
            print(f"[kernel] bucket_vote_stats n={n} W={world} tally {str(tdt)[6:]}: "
                  f"{ms:.4f} ms (bound {bms:.4f} ms, plain {plain_ms:.4f} ms); hist "
                  f"{hist.tolist()}, disagree {dis.item()}", flush=True)
            if n == N_MAIN and world == 4 and tdt == torch.int8:
                rec["bucket_vote_stats"] = (ms, plain_ms, bms, by, None)
            del tot
        del ballots
        torch.cuda.empty_cache()
    return rec, err


def flash_inputs(gen, T, B=FLASH_B, H=FLASH_H):
    """q, k, v as the model makes them (transposed views of one [B, T, 3, d]
    projection) and do as a transposed view of [B, T, H, hd]."""
    D = FLASH_D
    qkv = torch.randn(B, T, 3, H * D, generator=gen, device="cuda").bfloat16()
    q, k, v = (qkv[:, :, i].reshape(B, T, H, D).transpose(1, 2) for i in range(3))
    do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16().transpose(1, 2)
    return q, k, v, do


def flash_reference64(q, k, v, do):
    """o, lse, dq, dk, dv in float64 from the same bfloat16 inputs."""
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    T, scale = q.shape[2], 1.0 / math.sqrt(q.shape[-1])
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = (qd @ kd.transpose(-1, -2) * scale).masked_fill(~mask, -math.inf)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    del s
    o = p @ vd
    ds = p * (dod @ vd.transpose(-1, -2) - (o * dod).sum(-1)[..., None])
    out = {"o": o, "lse": lse, "dq": ds @ kd * scale, "dk": ds.transpose(-1, -2) @ qd * scale,
           "dv": p.transpose(-1, -2) @ dod}
    return out


def half_ulp_bf16(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 8)


def ulp_f32(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 23)


def flash_check(T, name, got, plain, want) -> float:
    """Hold one output to the criterion of the module doc; returns its max
    difference from the plain version."""
    got, pl = got.double(), plain.double()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"flash {name} at T={T}: shape {tuple(got.shape)} "
                             f"or non-finite values")
    e_k = (got - want).abs().max().item()
    e_p = (pl - want).abs().max().item()
    top = want.abs().max().item()
    slack = 4 * ulp_f32(top) if name == "lse" else half_ulp_bf16(top)
    limit = 2 * e_p + slack
    vs_plain = (got - pl).abs().max().item()
    print(f"[flash] T={T} {name}: kernel err {e_k:.3e}, plain err {e_p:.3e}, "
          f"limit {limit:.3e} (max |value| {top:.3f}); kernel vs plain {vs_plain:.3e}",
          flush=True)
    if e_k > limit:
        raise AssertionError(f"flash {name} at T={T}: error {e_k} against float64 "
                             f"exceeds 2 x plain ({e_p}) + {slack}")
    return vs_plain


def flash_kernel_phase(gen, rates):
    """Check the three flash kernels at every shape; time them at the main one."""
    rec = {}
    err = {k: 0.0 for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                            "flash_attention_bwd_dq")}
    owner = {"o": "flash_attention_fwd", "lse": "flash_attention_fwd",
             "dk": "flash_attention_bwd_dkv", "dv": "flash_attention_bwd_dkv",
             "dq": "flash_attention_bwd_dq"}
    shapes = [(FLASH_B, FLASH_H, T) for T in FLASH_TS] + list(FLASH_SMALL)
    for B, H, T in shapes:
        q, k, v, do = flash_inputs(gen, T, B, H)
        o, lse = fa.flash_attention_fwd(q, k, v)
        op, lp = fa.flash_attention_fwd_plain(q, k, v)
        di = fa.attention_di(op, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lp, di)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lp, di)
        dkp, dvp = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lp, di)
        dqp = fa.flash_attention_bwd_dq_plain(q, k, v, do, lp, di)
        torch.cuda.synchronize()
        kern = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        plain = {"o": op, "lse": lp, "dq": dqp, "dk": dkp, "dv": dvp}
        ref = flash_reference64(q, k, v, do)
        for name, want in ref.items():
            err[owner[name]] = max(err[owner[name]],
                                   flash_check(T, name, kern[name], plain[name], want))
        # the backward kernels on the forward kernel's own o and lse
        di_k = fa.attention_di(o, do)
        dk_k, dv_k = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di_k)
        dq_k = fa.flash_attention_bwd_dq(q, k, v, do, lse, di_k)
        for name, got in (("dq", dq_k), ("dk", dk_k), ("dv", dv_k)):
            flash_check(T, f"{name} (after the forward kernel)", got, plain[name], ref[name])
        # the same inputs again: the same bits
        o2, lse2 = fa.flash_attention_fwd(q, k, v)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lp, di)
        dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lp, di)
        torch.cuda.synchronize()
        again = {"o": (o, o2), "lse": (lse, lse2), "dk": (dk, dk2), "dv": (dv, dv2),
                 "dq": (dq, dq2)}
        differ = [name for name, (a, b) in again.items() if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"flash at T={T}: a second call differs in {differ}")
        print(f"[flash] T={T}: a second call gives the same bits in {list(again)}", flush=True)
        del ref, kern, plain, di_k, dk_k, dv_k, dq_k, again, o2, lse2, dk2, dv2, dq2
        if (B, H, T) != shapes[0]:
            continue

        D = FLASH_D
        pairs = B * H * T * (T + 1) / 2   # (q, k) pairs with k <= q
        elem = B * H * T * D * 2          # one bfloat16 [B, H, T, D] tensor
        row = B * H * T * 4               # one float32 [B, H, T] tensor
        cases = {
            "flash_attention_fwd": (lambda: fa.flash_attention_fwd(q, k, v),
                                    lambda: fa.flash_attention_fwd_plain(q, k, v),
                                    4 * elem + row, 2 * 2 * D * pairs),
            "flash_attention_bwd_dkv": (
                lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lp, di),
                lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, do, lp, di),
                6 * elem + 2 * row, 4 * 2 * D * pairs),
            "flash_attention_bwd_dq": (
                lambda: fa.flash_attention_bwd_dq(q, k, v, do, lp, di),
                lambda: fa.flash_attention_bwd_dq_plain(q, k, v, do, lp, di),
                5 * elem + 2 * row, 3 * 2 * D * pairs),
        }
        ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
        lib_fwd, lib_fwd_min = time_fresh_ms(
            lambda: None, lambda _: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        lib_bwd, lib_bwd_min = time_fresh_ms(
            lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True),
            lambda out: torch.autograd.grad(out, (ql, kl, vl), do))
        lib_both = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(ql, kl, vl, is_causal=True), (ql, kl, vl), do))
        print(f"[library] scaled_dot_product_attention causal B{B} H{H} T{T} hd{D}: "
              f"forward {lib_fwd:.4f} ms (min {lib_fwd_min:.4f}), backward {lib_bwd:.4f} ms "
              f"(min {lib_bwd_min:.4f}; a fresh graph per call), forward + backward "
              f"{lib_both:.4f} ms", flush=True)
        for name, (kern_fn, plain_fn, nbytes, flops) in cases.items():
            ms, plain_ms = time_ms(kern_fn), time_ms(plain_fn)
            bms, by = bound(nbytes, flops, rates)
            library = lib_fwd if name == "flash_attention_fwd" else lib_bwd
            print(f"[kernel] {name} B{B} H{H} T{T} hd{D}: {ms:.4f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s (bound {bms:.4f} ms by {by}: "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; plain {plain_ms:.4f} ms; "
                  f"library {library:.4f} ms)", flush=True)
            rec[name] = (ms, plain_ms, bms, by, library)
        del ql, kl, vl
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
    own card ballots is those ballots, and no byte crosses a link. Times
    ``sign_psum`` at the main path's size with the copy that keeps the
    ballots (telemetry on) and without it (in place)."""
    for n in (N_MAIN, N_RAGGED):
        ballots = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 1, -1
                              ).to(torch.int8)
        for wire in ("sign_psum", "packed_allgather", "packed_a2a"):
            tally = collectives.WireTally()
            tot = collectives.vote_total(ballots, wire, dist.group.WORLD, tally,
                                         keep_ballots=True)
            if not (tot.is_cuda and tot.data_ptr() != ballots.data_ptr()
                    and torch.equal(tot.to(torch.int32), ballots.to(torch.int32))
                    and tally.total() == 0):
                raise AssertionError(f"wire {wire} at n={n}: the 1-rank tally is not "
                                     f"the ballots (bytes {tally.total()})")
            print(f"[wire] {wire} n={n}: 1-rank tally == ballots", flush=True)
            del tot
        if n == N_MAIN:
            group = dist.group.WORLD
            kept = time_ms(lambda: collectives.vote_total(ballots, "sign_psum", group,
                                                          keep_ballots=True))
            in_place = time_ms(lambda: collectives.vote_total(ballots, "sign_psum", group))
            print(f"[wire] sign_psum n={n}: {kept:.4f} ms keeping the ballots (a copy), "
                  f"{in_place:.4f} ms in place", flush=True)


def profile_step(model, gen) -> None:
    """``torch.profiler`` over one forward + backward microbatch of ``model``
    at the slice's shape; prints the top device kernels and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    tokens = torch.randint(0, model.cfg.vocab_size, (8, 1024), generator=gen, device="cuda")

    def microbatch():
        loss, _ = clm_loss_and_metrics(model(tokens, 0), tokens)
        loss.backward()
        return loss

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        microbatch()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    # device activity only: tracing the host's ops would slow the host
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss = microbatch()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        print("[profile] torch.profiler recorded no device activity: kernel times and the "
              "idle share not measured", flush=True)
        return
    per_name: dict = {}
    for e in device:
        total, calls = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (total + e.time_range.elapsed_us(), calls + 1)
    start = min(e.time_range.start for e in device)
    end = max(e.time_range.end for e in device)
    busy, reach = 0.0, start
    for e in sorted(device, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, reach), e.time_range.end
        if hi > lo:
            busy += hi - lo
            reach = hi
    window = end - start
    print(f"[profile] one forward + backward microbatch, B 8 T 1024, loss {loss.item():.4f}: "
          f"window {window / 1e3:.3f} ms (first to last device event; unprofiled "
          f"microbatches {', '.join(f'{w:.3f}' for w in walls)} ms on the host clock), "
          f"device busy {busy / 1e3:.3f} ms, idle share {1 - busy / window:.4f}, "
          f"{len(device)} device events", flush=True)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    for rank, (name, (total, calls)) in enumerate(ranked, 1):
        if rank <= PROFILE_TOP or "flash_" in name:   # the top, and the port's flash kernels
            print(f"[profile] #{rank:<3d} {total / 1e3:9.3f} ms {calls:5d} calls  {name[:110]}",
                  flush=True)


SLICE_ARGS = ["--model_name", "gpt2_124m", "--dataset", "synthetic",
              "--lion", "--async_grad", "--wire", "auto",
              "--per_device_train_batch_size", "8", "--gradient_accumulation_steps", str(ACCUM),
              "--block_size", "1024", "--max_steps", str(STEPS), "--logging_steps", "1",
              "--synthetic_blocks", "400", "--per_device_eval_batch_size", "8",
              "--eval_iters", str(EVAL_BATCHES)]


def run_counted(extra):
    """One ``run_clm.main`` with every kernel counter at 0 before and read
    after; checks the losses and returns (trainer, rows, launches)."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    trainer = run_clm.main(SLICE_ARGS + extra)
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    rows = [r for r in trainer.history if "loss" in r]
    if len(rows) != STEPS or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"expected {STEPS} finite losses, got {rows}")
    return trainer, rows, launches


def expect(run: str, launches: dict, want: dict) -> None:
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"run {run}: {name} launched {launches[name]} times, "
                                 f"expected {count} (all counts {launches})")


def flash_vs_xla_eval(trainer) -> None:
    """The trained model's eval loss through flash (``auto``) against its
    eval loss through ``attention_xla``, on the same weights and blocks."""
    _, eval_blocks = run_clm.load_blocks(run_clm.DataArguments(synthetic_blocks=400), 1024,
                                         trainer.model.cfg.vocab_size)
    flash_eval = trainer.evaluate(eval_blocks)["eval/loss"]
    trainer.model.cfg = dataclasses.replace(trainer.model.cfg, attn_impl="xla")
    xla_eval = trainer.evaluate(eval_blocks)["eval/loss"]
    if not (math.isfinite(flash_eval) and math.isfinite(xla_eval)):
        raise AssertionError(f"eval losses {flash_eval}, {xla_eval}")
    print(f"[slice] eval loss through flash {flash_eval:.6f}, through attention_xla "
          f"{xla_eval:.6f}", flush=True)
    if abs(flash_eval - xla_eval) > 0.002:
        raise AssertionError(f"eval loss through flash {flash_eval} vs xla {xla_eval}")


def slice_phase(tmp, gen):
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1)
    try:
        wire_check(gen)
        base, base_rows, base_launches = run_counted([])
        buckets = len(bucket_bounds(base.n_params, base.cfg.vote_buckets, base.world,
                                    base.cfg.wire))
        expect("default", base_launches, {
            "fused_ballots": STEPS * buckets, "fused_apply": STEPS * buckets,
            "bucket_vote_stats": 0, "flash_attention_fwd": N_LAYER * EVAL_BATCHES,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0})
        del base
        torch.cuda.empty_cache()
        trainer, rows, launches = run_counted(["--dropout", "0", "--telemetry"])
        expect("dropout 0 + telemetry", launches, {
            "fused_ballots": STEPS * buckets, "fused_apply": STEPS * buckets,
            "bucket_vote_stats": STEPS * buckets,
            "flash_attention_fwd": N_LAYER * ACCUM * 2 * STEPS + N_LAYER * EVAL_BATCHES,
            "flash_attention_bwd_dkv": N_LAYER * ACCUM * STEPS,
            "flash_attention_bwd_dq": N_LAYER * ACCUM * STEPS})
        for r in rows:
            if r["vote/hist_mass"] != 1.0 or r["vote/disagree_frac"] != 0.0:
                raise AssertionError(
                    f"a vote of one rank: hist_mass {r['vote/hist_mass']}, disagree_frac "
                    f"{r['vote/disagree_frac']} at step {r['step']}")
        flash_vs_xla_eval(trainer)
        world, wire, buckets_cfg = trainer.world, trainer.cfg.wire, trainer.cfg.vote_buckets
        del trainer
        torch.cuda.empty_cache()
        plain, plain_rows, plain_launches = run_counted(["--dropout", "0"])
        expect("dropout 0", plain_launches, dict(launches, bucket_vote_stats=0))
        profile_step(plain.model, gen)
        del plain
    finally:
        dist.destroy_process_group()
    return (world, wire, buckets_cfg), [
        ("(a) default (dropout 0.1)", base_rows, base_launches),
        ("(b) dropout 0 + telemetry", rows, launches),
        ("(c) dropout 0", plain_rows, plain_launches)]


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
    rates = card_rates(name)
    print(f"[card] {name}: {torch.__version__}, CUDA {torch.version.cuda}, data-sheet "
          f"bandwidth {rates[0] / 1e12:.2f} TB/s, bfloat16 {rates[1] / 1e12:.0f} TFLOP/s",
          flush=True)
    build_cuda_kernels()

    gen = torch.Generator(device="cuda").manual_seed(0)
    rec, err = optimizer_kernel_phase(gen, rates)
    print(f"[card] Triton kernels built with triton {fused_lion.triton.__version__}", flush=True)
    frec, ferr = flash_kernel_phase(gen, rates)
    rec.update(frec)
    err.update(ferr)
    model_check()
    product_check(gen)
    with tempfile.TemporaryDirectory() as tmp:
        (world, wire, buckets), runs = slice_phase(tmp, gen)
    for label, rs, counts in runs:
        step_ms = statistics.median(r["step_ms"] for r in rs[1:])
        tok_s = statistics.median(r["tokens_per_sec"] for r in rs[1:])
        print(f"[slice] {label}: GPT-2 124M, {world} rank, wire {wire}, {buckets} "
              f"bucket(s), losses {[round(r['loss'], 4) for r in rs]}: steps 2-{STEPS} "
              f"{[r['step_ms'] for r in rs[1:]]} ms, median {step_ms:.1f} ms/step, "
              f"{tok_s:.0f} tokens/s on {card}; launches {counts}", flush=True)
    launches = runs[1][2]   # the main path: (b)

    kernels = []
    for k in KERNELS:
        route, source, replaces = ROUTES[k]
        ms, plain_ms, bms, by, library = rec[k]
        kernels.append({"name": k, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[k], "max_abs_err": err[k], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": library})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
