"""Probe: GPT-2 124M step time of ``run_clm --dropout 0`` on one card, for
comparing two trees in one session on the same card.

    PYTHONPATH=<tree> python3 distributed_lion_tpu_torch/probes/clm_step_time.py [--steps 12] \
        [more run_clm flags, e.g. --max_grad_norm 1.0]

Runs ``cli.run_clm.main`` as ``chip_smoke.py``'s run (c) does (a 1-rank
NCCL group, GPT-2 124M at full width, ``--lion --async_grad --wire auto
--dropout 0``, batch 8 x accumulation 2 x T 1024, 2 eval batches, and
any further ``run_clm`` flags given), over ``--steps`` steps, and prints
one JSON line: the package's directory, the extra flags, the losses and
each step's ms on the host clock, and their median from the third step
on. The package is imported from ``PYTHONPATH``, not from this
file's tree, so the same probe times an older checkout unpacked elsewhere:
run parent, change, change, parent.
"""

import argparse
import json
import os
import statistics
import tempfile

import torch
import torch.distributed as dist


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    args, extra = ap.parse_known_args(argv)
    from distributed_lion_tpu_torch.cli import run_clm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1)
        try:
            trainer = run_clm.main([
                "--model_name", "gpt2_124m", "--dataset", "synthetic", "--lion", "--async_grad",
                "--wire", "auto", "--dropout", "0", "--per_device_train_batch_size", "8",
                "--gradient_accumulation_steps", "2", "--block_size", "1024",
                "--max_steps", str(args.steps), "--logging_steps", "1",
                "--synthetic_blocks", "400", "--per_device_eval_batch_size", "8",
                "--eval_iters", "2", *extra])
        finally:
            dist.destroy_process_group()
    rows = [r for r in trainer.history if "loss" in r]
    step_ms = [r["step_ms"] for r in rows]
    print(json.dumps({"package": os.path.dirname(os.path.dirname(run_clm.__file__)),
                      "extra": extra, "losses": [r["loss"] for r in rows], "step_ms": step_ms,
                      "median_ms_from_step_3": statistics.median(step_ms[2:])}))


if __name__ == "__main__":
    main()
