"""Causal-LM pretraining entry point: port of ``distributed_lion_tpu/cli/run_clm.py``.

The reference's canonical launch, one process per GPU:

    torchrun --nproc_per_node 4 -m distributed_lion_tpu_torch.cli.run_clm \\
        --lion --async_grad --model_name gpt2_124m --dataset synthetic \\
        --per_device_train_batch_size 20 --gradient_accumulation_steps 8 \\
        --learning_rate 1e-4 --weight_decay 0.1 --warmup_steps 2000 \\
        --max_steps 100000 --block_size 1024 --output_dir ./out

Without torchrun it trains a world of one. It runs on the GPU;
``DLION_PLATFORM=cpu`` asks for the CPU (gloo under torchrun). Datasets:
``synthetic`` and ``bin:<glob>`` (pre-tokenized uint16/uint32 shards).
``output_dir/model.npz`` is written in the JAX package's format. Periodic
checkpoints and resume, ``text:`` datasets and the Llama family are not
ported yet (ROADMAP Queue 1 items 7 and 9).
"""

from __future__ import annotations

import dataclasses
import glob
from typing import Optional

import numpy as np
import torch

from distributed_lion_tpu_torch.data.sources import (
    TokenDataset,
    batch_iterator,
    synthetic_lm_dataset,
)
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.parallel.mesh import (
    init_distributed,
    platform_device,
    rank_of,
)
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.utils.argparsing import parse_dataclasses
from distributed_lion_tpu_torch.utils.serialization import params_to_jax, save_pytree


@dataclasses.dataclass
class ModelArguments:
    model_family: str = "gpt2"  # gpt2 (llama is not ported yet)
    model_name: str = "gpt2_124m"  # gpt2_124m | gpt2_small | tiny
    vocab_size: Optional[int] = None
    n_ctx: Optional[int] = None
    dropout: Optional[float] = None  # None = family default: 0.1 for GPT-2
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    vocab_pad_multiple: int = 0


def resolve_dropout(dropout: Optional[float], family: str) -> float:
    """0.1 for GPT-2 when unset, the HF GPT-2 config's every pdrop."""
    if dropout is not None:
        return dropout
    return 0.1 if family == "gpt2" else 0.0


@dataclasses.dataclass
class DataArguments:
    dataset: str = "synthetic"  # synthetic | bin:<glob>
    validation_split_percentage: int = 5
    max_train_samples: Optional[int] = None
    max_eval_samples: Optional[int] = None
    synthetic_blocks: int = 4096
    bin_dtype: str = "uint16"


VOCAB_PROBE_TOKENS = 4_000_000  # sample budget for the token-id range check


def load_blocks(data_args: DataArguments, block_size: int, vocab_size: int):
    """(train, eval) int32 block arrays, split and truncated as the JAX
    package's ``load_blocks``."""
    if data_args.dataset == "synthetic":
        blocks = synthetic_lm_dataset(data_args.synthetic_blocks, block_size, vocab_size)
    elif data_args.dataset.startswith("bin:"):
        paths = sorted(glob.glob(data_args.dataset[len("bin:"):]))
        if not paths:
            raise FileNotFoundError(f"no files match {data_args.dataset!r}")
        shards = [TokenDataset.from_bin(p, block_size, np.dtype(data_args.bin_dtype)).blocks
                  for p in paths]
        blocks = np.concatenate([s for s in shards if len(s)])
    elif data_args.dataset.startswith("text:"):
        raise NotImplementedError(
            "text: datasets need the tokenizer stack, not ported yet "
            "(ROADMAP Queue 1 item 7); pre-tokenize to bin: shards")
    else:
        raise ValueError(f"unknown dataset spec {data_args.dataset!r}")
    if len(blocks):
        sample = np.asarray(blocks[: max(1, VOCAB_PROBE_TOKENS // blocks.shape[1])])
        if int(sample.max()) >= vocab_size:
            raise ValueError(
                f"dataset contains token id {int(sample.max())} >= model "
                f"vocab_size {vocab_size}; set --vocab_size")
    n_val = max(1, len(blocks) * data_args.validation_split_percentage // 100)
    train, val = blocks[n_val:], blocks[:n_val]
    if data_args.max_train_samples:
        train = train[: data_args.max_train_samples]
    if data_args.max_eval_samples:
        val = val[: data_args.max_eval_samples]
    return np.asarray(train), np.asarray(val)


def model_config(model_args: ModelArguments) -> GPT2Config:
    if model_args.model_family != "gpt2":
        raise NotImplementedError(
            f"--model_family {model_args.model_family}: only gpt2 is ported "
            "(Llama is ROADMAP Queue 1 item 9)")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    common = dict(dropout=resolve_dropout(model_args.dropout, model_args.model_family),
                  param_dtype=dtypes[model_args.param_dtype],
                  compute_dtype=dtypes[model_args.compute_dtype],
                  remat=model_args.remat,
                  vocab_pad_multiple=model_args.vocab_pad_multiple)
    presets = {"tiny": GPT2Config.tiny, "gpt2_small": GPT2Config.small,
               "gpt2_124m": GPT2Config.gpt2_124m}
    if model_args.model_name not in presets:
        raise ValueError(f"unknown gpt2 model_name {model_args.model_name!r}")
    cfg = presets[model_args.model_name](**common)
    if model_args.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=model_args.vocab_size)
    if model_args.n_ctx:
        cfg = dataclasses.replace(cfg, n_ctx=model_args.n_ctx)
    return cfg


def main(argv=None) -> Trainer:
    """Train, evaluate, and write ``output_dir/model.npz``; returns the
    (closed) trainer, whose ``history`` holds the logged rows."""
    model_args, data_args, train_cfg = parse_dataclasses(
        (ModelArguments, DataArguments, TrainConfig), argv)
    device = platform_device()
    group = init_distributed(device)
    model_cfg = model_config(model_args)
    if train_cfg.block_size > model_cfg.n_ctx:
        print(f"[run_clm] capping block_size {train_cfg.block_size} -> n_ctx {model_cfg.n_ctx}")
        train_cfg.block_size = model_cfg.n_ctx
    trainer = Trainer.for_gpt2(train_cfg, model_cfg, device=device, group=group)
    if train_cfg.telemetry and rank_of(group) == 0:
        # only the tally wires carry exact margins; the ±1-proxy wire zeroes
        # the histogram by design (train/telemetry.tally_wire)
        print("[run_clm] vote-health telemetry on: margin histogram "
              + ("EXACT (tally wire " if trainer.margin_exact else "UNAVAILABLE (proxy wire ")
              + f"{trainer.cfg.wire}); drained every {train_cfg.logging_steps} steps")
    train_blocks, eval_blocks = load_blocks(data_args, train_cfg.block_size,
                                            model_cfg.vocab_size)
    it = batch_iterator(train_blocks, trainer.global_train_batch(), seed=train_cfg.seed)
    try:
        trainer.train(it, eval_blocks=eval_blocks)
        if len(eval_blocks):
            trainer.evaluate(eval_blocks)
        if train_cfg.output_dir and rank_of(group) == 0:
            save_pytree(f"{train_cfg.output_dir}/model.npz", params_to_jax(trainer.model))
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
